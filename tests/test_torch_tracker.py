"""The port's tracker step against the JAX tracker and against ground truth.

Both trackers run the same rendered sequence with the same configuration.
The JAX side uses backend="pallas_interpret", so its BA matcher applies the
same exact-f32 gate as the port's fused matcher, and the port receives the
RANSAC phases that jax.random draws from the JAX tracker's key, frame by
frame.  What remains different is f32 summation order, so the trajectories
agree to well under the pose bars.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import (
    BundleConfig,
    FeatureCorresConfig,
    FrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig,
)
from bundletrack_tpu.eval import adds_auc, pose_errors
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.tracker.bundler import make_track_frame
from bundletrack_tpu_torch.tracker.driver import Tracker, track_sequence
from bundletrack_tpu_torch.tracker.state import (
    FrameObservation,
    state_from_numpy,
    state_to_numpy,
)
from jax_draws import phases_from_key

torch.set_num_threads(2)

H, W, F = 120, 160, 6
STEP_TRANS_TOL = 1e-3  # m: one step from the same state (issue bar)
STEP_ROT_TOL = 0.1  # deg
# whole sequence against the JAX trajectory: measured <= 6e-7 m and 1e-5 deg
# on this configuration (f32 summation order only); 100x headroom
SEQ_TRANS_TOL = 1e-4
SEQ_ROT_TOL = 0.01
COUNT_TOL = 2  # inlier / edge counts: a residual at a threshold may flip


def jax_cfg():
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=FrontendConfig(top_k=128),
        ransac=RansacConfig(max_iter=256),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )


def port_cfg():
    return load_config(dataclasses.asdict(jax_cfg()))


def model_points():
    return (np.random.RandomState(0).rand(500, 3).astype(np.float32) - 0.5) * 0.2


@pytest.fixture(scope="module")
def runs():
    cfg = jax_cfg()
    seq = render_synthetic_sequence(num_frames=F, H=H, W=W, orbit_deg_per_frame=4.0)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    jtrk = JaxTracker(cfg, H, W)
    ttrk = Tracker(port_cfg(), H, W, device="cpu")
    j_states, j_out, t_out = [], [], []
    for f in range(F):
        j_states.append(jax.tree.map(np.array, jtrk.state))
        phases = phases_from_key(jtrk.state.rng_key, cfg)
        j_out.append(jax.tree.map(np.array, jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)))
        t_out.append(ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases))
    return seq, j_states, j_out, t_out, ttrk


def test_port_sequence_meets_pose_bars(runs):
    seq, _, _, t_out, _ = runs
    poses = [o.ob_in_cam.numpy() for o in t_out]
    assert [int(o.status) for o in t_out] == [0] * F
    for f, pose in enumerate(poses):
        rot, trans = pose_errors(pose, seq.ob_in_cam[f])
        assert rot < 1.0 and trans < 0.005, (f, rot, trans)
    assert adds_auc(poses, list(seq.ob_in_cam), model_points()) > 95.0


def test_port_trajectory_matches_jax(runs):
    _, _, j_out, t_out, _ = runs
    for f in range(F):
        assert int(t_out[f].status) == int(j_out[f].status)
        rot, trans = pose_errors(t_out[f].ob_in_cam.numpy(), j_out[f].ob_in_cam)
        assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, rot, trans)
        assert abs(int(t_out[f].num_matches) - int(j_out[f].num_matches)) <= COUNT_TOL
        assert abs(int(t_out[f].num_ba_edges) - int(j_out[f].num_ba_edges)) <= COUNT_TOL


@pytest.mark.parametrize("k", [1, 3, 5])
def test_track_step_from_the_same_state(runs, k):
    seq, j_states, j_out, _, _ = runs
    cfg = port_cfg()
    state = state_from_numpy(j_states[k]._asdict(), "cpu")
    obs = FrameObservation(*(torch.from_numpy(np.array(a)) for a in (seq.gray[k], seq.depth[k], seq.mask[k], seq.K)))
    init_pose = torch.from_numpy(np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32))
    phases = tuple(torch.from_numpy(np.array(p)) for p in phases_from_key(j_states[k].rng_key, jax_cfg()))
    st, out = make_track_frame(cfg, H, W)(state, obs, init_pose, phases)
    assert int(out.status) == int(j_out[k].status)
    rot, trans = pose_errors(out.pose_in_model.numpy(), j_out[k].pose_in_model)
    assert rot < STEP_ROT_TOL and trans < STEP_TRANS_TOL, (rot, trans)
    assert int(st.frame_count) == k + 1


def test_state_numpy_round_trip(runs):
    _, j_states, _, _, _ = runs
    ref = j_states[4]._asdict()
    back = state_to_numpy(state_from_numpy(ref, "cpu"))
    for name, val in back.items():
        want = ref[name]
        if name == "mappoints":
            np.testing.assert_array_equal(val["obs"], want.obs)
            np.testing.assert_array_equal(val["rev"], want.rev)
        else:
            np.testing.assert_array_equal(np.atleast_1d(val).view(np.uint8), np.atleast_1d(want).view(np.uint8))


def test_blank_mask_frame_fails_and_keeps_pose():
    """The bars of tests/test_tracker_synthetic.py::TestFailureHandling, with
    the phases drawn from the tracker's own generator."""
    seq = render_synthetic_sequence(num_frames=4, H=H, W=W)
    seq.mask[2] = False
    seq.depth[2] = 0.0
    poses, statuses, _ = track_sequence(port_cfg(), seq, device="cpu")
    assert statuses[2] == 1  # STATUS_FAIL
    np.testing.assert_allclose(poses[2], poses[1], atol=1e-5)
    assert statuses[3] in (0, 2)
    rot, trans = pose_errors(poses[3], seq.ob_in_cam[3])
    assert rot < 2.0 and trans < 0.01


def test_raw_sensor_types_match_float_input():
    seq = render_synthetic_sequence(num_frames=2, H=H, W=W)
    gray8 = np.round(seq.gray * 255).astype(np.uint8)
    depth16 = np.round(seq.depth * 1000).astype(np.uint16)
    outs = []
    for raw in (True, False):
        trk = Tracker(port_cfg(), H, W, device="cpu")
        for f in range(2):
            g = gray8[f] if raw else gray8[f].astype(np.float32) / 255.0
            d = depth16[f] if raw else depth16[f].astype(np.float32) * 1e-3
            out = trk.process_frame(g, d, seq.mask[f], seq.K, np.linalg.inv(seq.ob_in_cam[0]))
        outs.append(out.ob_in_cam.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert Tracker(port_cfg(), H, W).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tracker(port_cfg(), H, W)


def test_save_result_writes_reference_pose_files(runs, tmp_path):
    _, _, _, t_out, ttrk = runs
    ttrk.save_result(str(tmp_path), 3, t_out[3])
    got = np.loadtxt(tmp_path / "poses" / "00003.txt")
    np.testing.assert_allclose(got, t_out[3].ob_in_cam.numpy(), atol=1e-7)


def test_config_copy_loads_like_the_jax_config():
    from bundletrack_tpu.config import load_config as jax_load_config

    yaml_like = {"bundle": {"max_BA_frames": 8, "num_iter_outter": 3}, "LOG": 1, "sift": {"x": 1}}
    got = dataclasses.asdict(load_config(yaml_like))
    want = dataclasses.asdict(jax_load_config(yaml_like))
    got.pop("debug_dir"), want.pop("debug_dir")  # a host path, not part of the contract
    # the port has one matcher route (kernel on the card, plain version on
    # the CPU), so it has no backend option and drops the key when loading
    assert "backend" not in got["feature_corres"]
    want["feature_corres"].pop("backend")
    assert got == want
    assert "backend" not in dataclasses.asdict(load_config({"feature_corres": {"backend": "xla"}}).feature_corres)
