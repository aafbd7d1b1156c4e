"""The generator: repeatable for a seed, different across seeds, a closed
loop, the port's renderer at the loop's first frame."""

import numpy as np

from trackbench.render import camera_to_object, render_loop
from trackbench.traffic import Schedule, Streams

TRAFFIC = {"streams": 8, "loop_frames": 120, "radius": 0.55, "elev_amp": 0.15, "box_size": 0.2,
           "texture_seed": 0, "phase_offset": 0, "phase_spacing": 15, "directions": [1, -1, 1, -1, 1, -1, 1, -1]}


def test_schedule_repeats_for_a_seed_and_differs_across_seeds():
    a, b, c = Schedule(TRAFFIC, 2**31 + 5), Schedule(TRAFFIC, 2**31 + 5), Schedule(TRAFFIC, 2**31 + 6)
    assert (a.phase == b.phase).all() and (a.direction == b.direction).all()
    assert a.tracker_seed == b.tracker_seed and a.tracker_seed != c.tracker_seed
    assert (a.phase != c.phase).any()
    assert a.sample(5, 3, 100) != c.sample(6, 3, 100)


def test_every_seed_gets_the_same_phase_and_direction_pairs_in_another_order():
    pairs = {(15 * k, (-1) ** k) for k in range(8)}
    for seed in (0, 7, 2**31 + 99, 3 * 2**31):
        s = Schedule(TRAFFIC, seed)
        assert set(zip(s.phase.tolist(), s.direction.tolist())) == pairs
    assert Schedule(TRAFFIC, 1).sample(1, 3, 100) == Schedule(TRAFFIC, 1).sample(1, 3, 100)


def test_streams_advance_one_loop_frame_per_fleet_frame():
    s = Schedule(TRAFFIC, 11)
    assert ((s.frames(1) - s.frames(0)) % 120 == s.direction % 120).all()
    assert (s.frames(120) == s.frames(0)).all()


def test_the_loop_closes():
    T = camera_to_object(np.array([0, 120, 60]), 120, 0.55, 0.15)
    assert np.abs(T[0] - T[1]).max() < 1e-12
    assert np.abs(T[0] - T[2]).max() > 0.1


def test_render_repeats_and_a_seed_changes_the_texture():
    a = render_loop(60, 80, 3, loop_frames=12)
    b = render_loop(60, 80, 3, loop_frames=12)
    c = render_loop(60, 80, 4, loop_frames=12)
    assert (a.gray == b.gray).all() and (a.depth == b.depth).all()
    assert (a.mask == c.mask).all() and (a.gray != c.gray).any()
    assert a.gray.dtype == np.uint8 and a.depth.dtype == np.uint16 and a.mask.dtype == bool


def test_first_frame_is_the_ports_renderer():
    from bundletrack_tpu_torch.data.synthetic import render_synthetic_sequence

    ours = render_loop(120, 160, 0, loop_frames=120)
    port = render_synthetic_sequence(num_frames=1, H=120, W=160, seed=0)
    assert (np.round(port.gray[0] * 255).astype(np.uint8) == ours.gray[0]).all()
    assert (np.round(port.depth[0] * 1000).astype(np.uint16) == ours.depth[0]).all()
    assert (port.mask[0] == ours.mask[0]).all()
    assert np.abs(port.ob_in_cam[0] - ours.ob_in_cam[0]).max() < 1e-6


def test_observation_is_what_a_camera_delivers():
    st = Streams(dict(TRAFFIC, streams=2, directions=[1, -1]), 5, 48, 64)
    gray, depth, mask, K = st.observation(3)
    assert gray.shape == (2, 48, 64) and gray.dtype == np.uint8
    assert depth.dtype == np.uint16 and mask.dtype == bool and K.shape == (2, 3, 3)
    assert st.truth(3).shape == (2, 4, 4)


def test_texture_seeds_give_each_pair_its_own_texture_and_follow_it_to_its_stream():
    one = dict(TRAFFIC, streams=2, directions=[1, -1], loop_frames=12)
    two = dict(one, texture_seeds=[0, 9])
    a, b = Streams(one, 5, 48, 64), Streams(two, 5, 48, 64)
    ga, gb = a.observation(2)[0], b.observation(2)[0]
    first = int(np.flatnonzero(b.schedule.texture == 0)[0])  # the stream on pair 0 keeps texture 0
    assert (ga[first] == gb[first]).all() and (ga[1 - first] != gb[1 - first]).any()
    assert sorted(b.schedule.texture.tolist()) == [0, 9]
    assert (a.observation(2)[1] == b.observation(2)[1]).all()  # depth and geometry do not change
