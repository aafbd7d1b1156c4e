"""The port's sharded fleets against the JAX package's, on gloo ranks.

As tests/test_torch_parallel.py (spawned gloo ranks on the CPU, their
bodies in tests/torch_mesh_ranks.py; JAX on the virtual 8-device mesh;
JAX's RANSAC draws): 4 streams of tests/test_torch_fleet.py's fleet over
stream=2 (world 2) and over stream=2 x pairs=2 (world 4, bundle.ba_mesh_axis
"pairs") against JAX's `make_fleet_step(mesh=...)` on the same meshes and
against the port's one-rank fleet.  A rank feeds and steps only its block
of the streams; the blocks concatenated in rank order are JAX's global
arrays.  Then streams that join the running fleet (reset to a fresh state
with `set_streams`): rank 1's streams over stream=2, and one of two
streams over stream=1 x pairs=2, against the port's one-rank mixed fleet.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.parallel import init_fleet_state as j_init_fleet_state
from bundletrack_tpu.parallel import make_fleet_step as j_make_fleet_step
from bundletrack_tpu.parallel import make_mesh as j_make_mesh
from bundletrack_tpu.tracker.state import FrameObservation as JaxObservation
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.parallel import distributed, fleet_observation, init_fleet_state, make_fleet_step
from bundletrack_tpu_torch.tracker.state import set_streams
from test_torch_fleet import fleet_phases, frame_arrays, init_poses, jax_cfg

torch.set_num_threads(2)

RANK_TIMEOUT_S, JOIN_S = 120.0, 420.0  # a collective's wait; the spawn's whole budget
# tests/test_torch_fleet.py's fleet bars against JAX, per stream and frame
SEQ_TRANS_TOL, SEQ_ROT_TOL = 1e-4, 0.01
# against the port's one-rank fleet: stream sharding changes no sum (the
# bar of tests/test_torch_fleet.py's stream vs single); pair sharding sums
# H and g over the pair blocks in another order
STREAMS_VS_ONE_RANK_ATOL, PAIRS_VS_ONE_RANK_ATOL = 1e-5, 1e-4
FLEET_S, FLEET_H, FLEET_W, FLEET_F = 4, 96, 128, 4
MESHES = {"fleet_stream": {"stream": 2}, "fleet_stream_pairs": {"stream": 2, "pairs": 2}}


def _fleet_cfg(pairs: bool):
    cfg = jax_cfg()
    return cfg.replace(bundle=dataclasses.replace(cfg.bundle, ba_mesh_axis="pairs" if pairs else ""))


def _port(jcfg):
    return load_config(dataclasses.asdict(jcfg))


def _jax_fleet(seqs, axis_sizes):
    cfg = _fleet_cfg("pairs" in axis_sizes)
    step = j_make_fleet_step(cfg, FLEET_H, FLEET_W, mesh=j_make_mesh(axis_sizes))
    state = j_init_fleet_state(cfg, FLEET_H, FLEET_W, FLEET_S)
    ip = jnp.asarray(init_poses(seqs))
    poses, statuses, phases = [], [], []
    for f in range(FLEET_F):
        phases.append(fleet_phases(np.asarray(state.rng_key), cfg))
        state, out = step(state, JaxObservation(*(jnp.asarray(a) for a in frame_arrays(seqs, f))), ip)
        poses.append(np.asarray(out.ob_in_cam))
        statuses.append(np.asarray(out.status))
    return np.stack(poses), np.stack(statuses), phases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fleet_ranks"))
    seqs = [render_synthetic_sequence(num_frames=FLEET_F, H=FLEET_H, W=FLEET_W, seed=s, orbit_deg_per_frame=3.0)
            for s in range(FLEET_S)]
    frames = [frame_arrays(seqs, f) for f in range(FLEET_F)]
    jax_res = {}
    for name, sizes in MESHES.items():
        jax_res[name] = _jax_fleet(seqs, sizes)
        job = (_port(_fleet_cfg("pairs" in sizes)), frames, init_poses(seqs), jax_res[name][2], sizes, name)
        world = int(np.prod(list(sizes.values())))
        distributed.spawn_ranks(ranks.run_jobs, world, (out, [("fleet_rank", job)]), backend="gloo",
                                device="cpu", timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
    return out, jax_res, seqs, frames


@pytest.mark.parametrize("name,world", [("fleet_stream", 2), ("fleet_stream_pairs", 4)])
def test_sharded_fleet_matches_jax_and_one_rank(runs, name, world):
    out, jax_res, seqs, frames = runs
    res = ranks.load(out, name, world, job="fleet_rank")
    for r in res:
        assert r["forbidden_modules"] == [], r["forbidden_modules"]
    j_poses, j_statuses, phases = jax_res[name]
    # the ranks' outputs in rank order along "stream" are the global arrays
    blocks = sorted({r["streams"]: r for r in res}.items())
    assert [b for b, _ in blocks] == [(0, 2), (2, 4)]
    poses = np.concatenate([r["poses"] for _, r in blocks], axis=1)
    statuses = np.concatenate([r["statuses"] for _, r in blocks], axis=1)
    np.testing.assert_array_equal(statuses, j_statuses)
    for f in range(FLEET_F):
        for s in range(FLEET_S):
            rot, trans = pose_errors(poses[f, s], j_poses[f, s])
            assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (name, f, s, rot, trans)
    if world == 4:  # the two ranks of each pairs group hold the same streams and poses
        for a, b in ((0, 1), (2, 3)):
            assert res[a]["streams"] == res[b]["streams"]
            np.testing.assert_array_equal(res[a]["poses"], res[b]["poses"])
    cfg = _port(_fleet_cfg(False))
    step = make_fleet_step(cfg, FLEET_H, FLEET_W)
    state = init_fleet_state(cfg, FLEET_H, FLEET_W, FLEET_S, device="cpu")
    ip = torch.from_numpy(init_poses(seqs))
    bar = STREAMS_VS_ONE_RANK_ATOL if world == 2 else PAIRS_VS_ONE_RANK_ATOL
    for f in range(FLEET_F):
        state, o = step(state, fleet_observation(*frames[f], "cpu"), ip, phases[f])
        np.testing.assert_array_equal(o.status.numpy(), statuses[f])
        np.testing.assert_allclose(poses[f], o.ob_in_cam.numpy(), atol=bar)


# ---- streams that join the running fleet ----------------------------------------

# name: (mesh, streams, {frame: streams reset before it}); over pairs the
# last frame resets both streams, so every stream of the pair group is new
JOINS = {
    "join_stream": ({"stream": 2}, FLEET_S, {2: [2, 3]}),
    "join_pairs": ({"stream": 1, "pairs": 2}, 2, {2: [1], 3: [0, 1]}),
}


def _resets(seqs, joins):
    """{frame: (streams, init poses [S,4,4])}: a reset stream's init pose is
    its truth at the frame it joins."""
    ip, out = init_poses(seqs), {}
    for f, streams in sorted(joins.items()):
        ip = ip.copy()
        for s in streams:
            ip[s] = np.linalg.inv(seqs[s].ob_in_cam[f])
        out[f] = (streams, ip)
    return out


@pytest.fixture(scope="module")
def join_runs(runs, tmp_path_factory):
    """Each join mesh's ranks, and the port's one-rank mixed fleet on the same
    resets and phases (the stream=2 fleet's JAX phases)."""
    out = str(tmp_path_factory.mktemp("join_ranks"))
    _, jax_res, seqs, frames = runs
    phases = jax_res["fleet_stream"][2]
    ref = {}
    for name, (sizes, S, joins) in JOINS.items():
        cfg = _port(_fleet_cfg("pairs" in sizes))
        sub = [tuple(a[:S] for a in fr) for fr in frames]
        ph = [tuple(p[:S] for p in phs) for phs in phases]
        resets = _resets(seqs[:S], joins)
        job = (cfg, sub, init_poses(seqs[:S]), ph, sizes, name, resets)
        distributed.spawn_ranks(ranks.run_jobs, 2, (out, [("fleet_rank", job)]), backend="gloo",
                                device="cpu", timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
        one = _port(_fleet_cfg(False))
        step = make_fleet_step(one, FLEET_H, FLEET_W)
        state = init_fleet_state(one, FLEET_H, FLEET_W, S, device="cpu")
        ip, outs = torch.from_numpy(init_poses(seqs[:S])), []
        for f in range(FLEET_F):
            if f in resets:
                state = set_streams(state, resets[f][0], init_fleet_state(one, FLEET_H, FLEET_W, S, device="cpu"))
                ip = torch.from_numpy(resets[f][1])
            state, o = step(state, fleet_observation(*sub[f], "cpu"), ip, ph[f])
            outs.append(o)
        ref[name] = (outs, state.frame_count)
    return out, ref


@pytest.mark.parametrize("name", list(JOINS))
def test_joining_streams_over_a_mesh_match_one_rank(join_runs, name):
    """The ranks' mixed fleet against the one-rank mixed fleet; over pairs
    the two ranks' poses are equal bit for bit, and a frame on which every
    stream of the pair group is new issues no collective (both ranks take
    the first-frame branch, so neither waits on the other)."""
    out, ref = join_runs
    sizes, S, joins = JOINS[name]
    res = ranks.load(out, name, 2, job="fleet_rank")
    outs, counts = ref[name]
    bar = STREAMS_VS_ONE_RANK_ATOL if "pairs" not in sizes else PAIRS_VS_ONE_RANK_ATOL
    if "pairs" in sizes:
        assert res[0]["streams"] == res[1]["streams"] == (0, S)
        np.testing.assert_array_equal(res[0]["poses"], res[1]["poses"])
        blocks = [res[0]]
        for r in res:  # frame 0 and the last frame: every stream new
            assert r["collectives"][0] == 0 and r["collectives"][3] == 0, r["collectives"]
            assert r["collectives"][1] > 0 and r["collectives"][2] > 0, r["collectives"]
    else:
        blocks = [r for _, r in sorted({r["streams"]: r for r in res}.items())]
    poses = np.concatenate([r["poses"] for r in blocks], axis=1)
    statuses = np.concatenate([r["statuses"] for r in blocks], axis=1)
    assert sum((tuple(r["frame_count"]) for r in blocks), ()) == counts
    for f in range(FLEET_F):
        np.testing.assert_array_equal(statuses[f], outs[f].status.numpy())
        np.testing.assert_allclose(poses[f], outs[f].ob_in_cam.numpy(), atol=bar)
