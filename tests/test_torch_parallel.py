"""The port's multi-process paths against the JAX package's mesh paths.

The port side runs as gloo ranks spawned on the CPU
(`parallel/distributed.spawn_ranks`, a file:// rendezvous, a process-group
timeout and a join timeout), their bodies in tests/torch_mesh_ranks.py;
the JAX side on the virtual 8-device CPU mesh of tests/conftest.py, with
`make_mesh` taking a prefix of its devices.  Inputs come from seeded numpy
RNGs and the renderer; the RANSAC phases are JAX's draws, as in
tests/test_torch_fleet.py.  One world-2 and one world-4 spawn serve the
file (module fixture):

- `make_pair_sharded_ba` over pairs=2, with and without the dense term,
  against JAX's over pairs=2 and the port's unsharded `_ba_local`;
- `Tracker(mesh)` with bundle.ba_mesh_axis="pairs" over pairs=2 against
  JAX's `Tracker(mesh=make_mesh({"pairs": 2}))` and the port's one-rank
  tracker;
- the runtime helpers and the collectives, the explicit backend choice,
  and a failing rank failing the spawn.

The sharded fleets are in tests/test_torch_parallel_fleet.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from bundletrack_tpu.config import BundleConfig
from bundletrack_tpu.parallel import make_mesh as j_make_mesh
from bundletrack_tpu.parallel.pair_sharded import make_pair_sharded_ba as j_make_pair_sharded_ba
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.parallel import distributed
from bundletrack_tpu_torch.parallel.pair_sharded import BAFrameTable
from bundletrack_tpu_torch.solver.dense_p2p import compact_frame, stack_frame_dense
from bundletrack_tpu_torch.tracker.driver import Tracker
from test_pair_sharded import K_FRAMES, _cfg, _make_problem
from test_torch_fleet import phases_from_key

torch.set_num_threads(2)

RANK_TIMEOUT_S = 120.0  # a collective that waits longer fails its rank
JOIN_S = 420.0  # the spawn's whole budget; stragglers are killed
# tests/test_pair_sharded.py's bars for the sharded BA against one device
BA_POSE_ATOL, BA_COST_RTOL, BA_HIGH_ATOL = 1e-4, 1e-3, 1e-6
TRACKER_POSE_ATOL = 1e-3  # tests/test_pair_sharded.py::test_tracker_parity_sharded_vs_single
# the port's sharded tracker against its one-rank tracker: the same
# arithmetic but for the order of the sums over the pair blocks
SHARDED_VS_ONE_RANK_ATOL = 1e-4
TRACK_H, TRACK_W, TRACK_F = 96, 128, 6


def _port(jcfg):
    return load_config(dataclasses.asdict(jcfg))


# ---- the JAX side ----------------------------------------------------------------


def _ba_problem(dense: bool):
    """tests/test_pair_sharded.py's problems: (JAX cfg, JAX table, pi, pj,
    key, JAX dense tables, K_low, depth maps)."""
    cfg = _cfg()
    if dense:
        cfg = cfg.replace(bundle=BundleConfig(w_dense_depth=1.0, dense_src_capacity=256, num_iter_outer=3))
    table, _, pi, pj = _make_problem()
    depth = K_low = None
    if dense:
        Hl, Wl = 24, 32
        K_low = np.asarray([[40.0, 0, Wl / 2], [0, 40.0, Hl / 2], [0, 0, 1]], np.float32)
        depth = 0.5 + 0.05 * np.random.RandomState(3).rand(K_FRAMES, Hl, Wl).astype(np.float32)
    return cfg, table, pi, pj, jax.random.PRNGKey(11 if dense else 7), K_low, depth


def _port_dense(depth, capacity):
    """The dense tables of tests/test_pair_sharded.py's flat depth maps (a
    plane at each pixel's depth, normals -z), compacted by the port."""
    K, Hl, Wl = depth.shape
    d = torch.from_numpy(depth)
    pts = torch.stack([torch.zeros_like(d), torch.zeros_like(d), d], -1)
    nrm = torch.cat([torch.zeros(K, Hl, Wl, 2), -torch.ones(K, Hl, Wl, 1)], -1)
    fd = compact_frame(pts, nrm, torch.ones(K, Hl, Wl, dtype=torch.bool), capacity)
    return stack_frame_dense(fd.src, fd.valid, fd.lin, fd.tchan)


def _jax_dense(depth, capacity):
    from bundletrack_tpu.solver.dense_p2p import compact_frame as jcf
    from bundletrack_tpu.solver.dense_p2p import stack_frame_dense as jsfd

    K, Hl, Wl = depth.shape
    fds = [jcf(jnp.stack([jnp.zeros((Hl, Wl))] * 2 + [jnp.asarray(depth[k])], -1),
               jnp.concatenate([jnp.zeros((Hl, Wl, 2)), -jnp.ones((Hl, Wl, 1))], -1),
               jnp.ones((Hl, Wl), bool), capacity) for k in range(K)]
    return jsfd(*(jnp.stack([getattr(f, n) for f in fds]) for n in ("src", "valid", "lin", "tchan")))


def _jax_pair_sharded(dense: bool):
    cfg, table, pi, pj, key, K_low, depth = _ba_problem(dense)
    jd = _jax_dense(depth, cfg.bundle.dense_src_capacity) if dense else None
    step = j_make_pair_sharded_ba(cfg, j_make_mesh({"pairs": 2}))
    poses, cost, high = jax.jit(step)(table, jd, None if K_low is None else jnp.asarray(K_low),
                                      jnp.asarray(pi), jnp.asarray(pj), jnp.ones((len(pi),), bool), key)
    M, n_rep = cfg.shapes.max_matches, -(-cfg.ransac.max_iter // cfg.shapes.max_matches)
    phases = jax.vmap(lambda k: jax.random.randint(k, (3, n_rep), 0, M, dtype=jnp.int32))(
        jax.random.split(key, len(pi)))
    port_table = BAFrameTable(*(torch.from_numpy(np.array(a)) for a in table))
    port_dense = _port_dense(depth, cfg.bundle.dense_src_capacity) if dense else None
    job = (f"pair_sharded_{dense}", _port(cfg), port_table, pi.astype(np.int32), pj.astype(np.int32),
           np.asarray(phases), port_dense, None if K_low is None else torch.from_numpy(K_low))
    return (np.asarray(poses), float(cost), float(high)), job


def _tracker_setup():
    """tests/test_pair_sharded.py::TestTrackerPairSharded's config and sequence."""
    from bundletrack_tpu.config import FrontendConfig, RansacConfig, ShapeConfig, TrackerConfig

    cfg = TrackerConfig(
        bundle=BundleConfig(dense_src_capacity=256),
        frontend=FrontendConfig(top_k=64),
        ransac=RansacConfig(max_iter=128),
        shapes=ShapeConfig(max_matches=64, image_h=TRACK_H, image_w=TRACK_W),
    )
    return cfg, render_synthetic_sequence(num_frames=TRACK_F, H=TRACK_H, W=TRACK_W, orbit_deg_per_frame=3.0)


def _jax_tracker(cfg, seq):
    cfg = cfg.replace(bundle=dataclasses.replace(cfg.bundle, ba_mesh_axis="pairs"))
    trk = JaxTracker(cfg, TRACK_H, TRACK_W, mesh=j_make_mesh({"pairs": 2}), donate=False)
    init = np.linalg.inv(seq.ob_in_cam[0])
    poses, statuses, phases = [], [], []
    for f in range(TRACK_F):
        phases.append(tuple(torch.from_numpy(np.array(p)) for p in phases_from_key(trk.state.rng_key, cfg)))
        out = trk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose=init)
        poses.append(np.asarray(out.ob_in_cam))
        statuses.append(int(out.status))
    return np.stack(poses), statuses, phases


# ---- one spawn per world ------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel_ranks"))
    jax_res, jobs2 = {}, []
    for dense in (False, True):
        jax_res[f"pair_sharded_{dense}"], job = _jax_pair_sharded(dense)
        jobs2.append(("pair_sharded_rank", job))

    tcfg, seq = _tracker_setup()
    jax_res["tracker"] = _jax_tracker(tcfg, seq)
    seq_np = {k: getattr(seq, k) for k in ("gray", "depth", "mask", "K", "ob_in_cam")}
    jobs2.append(("tracker_rank", (_port(tcfg), seq_np, jax_res["tracker"][2], {"pairs": 2})))

    jobs4 = [("helpers_rank", ())]
    for world, jobs in ((2, jobs2), (4, jobs4)):
        distributed.spawn_ranks(ranks.run_jobs, world, (out, jobs), backend="gloo", device="cpu",
                                timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
    return out, jax_res, (tcfg, seq)


def _assert_no_jax(results):
    for r, res in enumerate(results):
        assert res["forbidden_modules"] == [], (r, res["forbidden_modules"])


# ---- the tests --------------------------------------------------------------------


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_pair_sharded_ba_matches_jax_and_the_unsharded_solve(runs, dense):
    out, jax_res, _ = runs
    res = ranks.load(out, f"pair_sharded_{dense}", 2, job="pair_sharded_rank")
    _assert_no_jax(res)
    j_poses, j_cost, j_high = jax_res[f"pair_sharded_{dense}"]
    for r in res:
        np.testing.assert_allclose(r["poses"].numpy(), j_poses, atol=BA_POSE_ATOL)
        np.testing.assert_allclose(float(r["cost"]), j_cost, rtol=BA_COST_RTOL)
        np.testing.assert_allclose(float(r["high"]), j_high, atol=BA_HIGH_ATOL)
    assert torch.equal(res[0]["poses"], res[1]["poses"])  # every rank solves the same system
    one = res[0]["one"]
    np.testing.assert_allclose(res[0]["poses"].numpy(), one[0].numpy(), atol=BA_POSE_ATOL)
    np.testing.assert_allclose(float(res[0]["cost"]), float(one[1]), rtol=BA_COST_RTOL)
    np.testing.assert_allclose(float(res[0]["high"]), float(one[2]), atol=BA_HIGH_ATOL)


def test_uneven_pairs_and_a_bad_axis_raise(runs):
    out, _, _ = runs
    for r in ranks.load(out, "pair_sharded_False", 2, job="pair_sharded_rank"):
        assert "P=119 pairs must divide mesh axis pairs=2" in r["uneven"]
        assert "not in mesh axes" in r["bad_axis"]
    for r in ranks.load(out, "tracker", 2, job="tracker_rank"):
        assert "bundle.ba_mesh_axis='nonexistent' not in mesh axes" in r["bad_axis"]


def test_pair_sharded_tracker_matches_jax_and_one_rank(runs):
    out, jax_res, inputs = runs
    res = ranks.load(out, "tracker", 2, job="tracker_rank")
    _assert_no_jax(res)
    j_poses, j_statuses, phases = jax_res["tracker"]
    for r in res:
        assert r["statuses"] == j_statuses
        np.testing.assert_allclose(r["poses"], j_poses, atol=TRACKER_POSE_ATOL)
    np.testing.assert_array_equal(res[0]["poses"], res[1]["poses"])
    cfg, seq = inputs
    one = Tracker(_port(cfg), TRACK_H, TRACK_W, device="cpu")
    init = np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32)
    for f in range(TRACK_F):
        o = one.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init, phases=phases[f])
        assert int(o.status) == res[0]["statuses"][f]
        np.testing.assert_allclose(res[0]["poses"][f], o.ob_in_cam.numpy(), atol=SHARDED_VS_ONE_RANK_ATOL)
    assert j_statuses[1:] == [0] * (TRACK_F - 1)


def test_runtime_helpers_and_collectives(runs):
    out, _, _ = runs
    res = ranks.load(out, "helpers", 4, job="helpers_rank")
    _assert_no_jax(res)
    for rank, r in enumerate(res):
        assert r["fleet"] == (("stream",), (4,))
        assert r["train"] == (("data", "model"), (2, 2))
        assert r["coords"] == (rank // 2, rank % 2)
        assert r["slices"] == (slice(2 * rank, 2 * rank + 2), slice(4 * (rank // 2), 4 * (rank // 2) + 4))
        first = 2 * (rank // 2)  # the pairs group of rank r is {first, first + 1}
        np.testing.assert_array_equal(r["gathered"].numpy(), np.repeat([first, first + 1], 2)[:, None] * np.ones(3))
        w = np.arange(12.0).reshape(4, 3) * ((first + 1) + (first + 2))
        np.testing.assert_array_equal(r["grad"].numpy(), w[2 * (rank % 2):2 * (rank % 2) + 2])
        assert float(r["summed"]) == (first + 1) + (first + 2)
        assert r["first"].tolist() == [first, 0] and int(r["maxed"]) == first + 1
        assert "has 3 ranks, the world 4" in r["bad_product"]
        assert "5 streams do not divide over 4 ranks" in r["uneven"]
        assert "not in mesh axes" in r["bad_axis"] and r["device"] == "cpu"


def test_backend_choice_is_explicit(tmp_path):
    """NCCL refuses two ranks on one card: a world larger than the visible
    cards raises unless gloo is asked for; one process needs no group."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed.initialize_multihost(f"file://{tmp_path / 'r'}", 2, 0, backend="nccl", device="cpu")
    assert distributed.initialize_multihost(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="has 2 ranks, the world 1"):
        distributed.make_mesh({"pairs": 2})
    assert os.path.exists(tmp_path) and not os.listdir(tmp_path)


def test_a_failing_rank_fails_the_spawn():
    """Rank 1 raises; rank 0's collective then fails too, and the spawn
    raises the first failure it sees."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        distributed.spawn_ranks(ranks.failing_rank, 2, (), backend="gloo", device="cpu", timeout_s=30.0,
                                join_s=120.0)


def test_ransac_multi_pair_draws_every_pair_before_the_blocks_are_cut():
    """Every pair's phases come from one draw for all P pairs, so a block of
    pairs solved with its rows of that draw gives the rows of the whole."""
    from bundletrack_tpu_torch.ransac.ransac import draw_phases, ransac_multi_pair, ransac_pair

    rng = np.random.RandomState(0)
    P, M, T = 6, 32, 64
    pa = torch.from_numpy(rng.rand(P, M, 3).astype(np.float32))
    na = torch.nn.functional.normalize(torch.from_numpy(rng.randn(P, M, 3).astype(np.float32)), dim=-1)
    pb = pa + torch.from_numpy((0.002 * rng.randn(P, M, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(P, M) > 0.2)
    prior = torch.eye(4).expand(P, 4, 4)
    full = ransac_multi_pair(pa, pb, na, na, valid, prior, generator=torch.Generator().manual_seed(3), num_trials=T)
    phases = draw_phases((P,), T, M, torch.Generator().manual_seed(3))
    for lo, hi in ((0, 3), (3, 6)):
        block = ransac_pair(pa[lo:hi], pb[lo:hi], na[lo:hi], na[lo:hi], valid[lo:hi], prior[lo:hi],
                            phases=phases[lo:hi], num_trials=T)
        for got, want in zip(block, full):
            assert torch.equal(got, want[lo:hi])
    assert bool(full.valid.all())
