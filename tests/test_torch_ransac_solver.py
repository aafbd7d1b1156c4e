"""Parity of the port's RANSAC, pose-graph solver and keyframe selection with the JAX package.

RANSAC's only random input is the per-repeat phases; the tests draw them
with jax.random exactly as the JAX function does and pass them to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import BundleConfig, DepthProcessingConfig, P2PConfig
from bundletrack_tpu.geometry.camera import scale_intrinsics as j_scale_intrinsics
from bundletrack_tpu.geometry.se3 import se3_exp as j_se3_exp
from bundletrack_tpu.ops.depth import process_depth as j_process_depth
from bundletrack_tpu.ops.pointcloud import depth_to_cloud_and_normals as j_cloud
from bundletrack_tpu.ransac import ransac as jr
from bundletrack_tpu.solver import dense_p2p as jdp
from bundletrack_tpu.solver import gauss_newton as jgn
from bundletrack_tpu.solver import residuals as jres
from bundletrack_tpu.tracker import selection as jsel
from bundletrack_tpu_torch import config as tcfg
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.ransac import ransac as tr
from bundletrack_tpu_torch.solver import dense_p2p as tdp
from bundletrack_tpu_torch.solver import gauss_newton as tgn
from bundletrack_tpu_torch.solver import residuals as tres
from bundletrack_tpu_torch.tracker import selection as tsel

torch.set_num_threads(2)

POSE_ATOL = 1e-4  # f32 fits and solves; summation order differs
HG_RTOL = 1e-4  # relative to the largest entry: f32 sums over hundreds of terms, other order


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, ref, rtol=HG_RTOL):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= rtol * max(np.abs(ref).max(), 1e-12)


def _pose(seed, rot=0.3, trans=0.05):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.randn(3) * trans, rng.randn(3) * rot]).astype(np.float32)
    return np.array(j_se3_exp(jnp.asarray(xi)))


def _matches(seed, M=64, n_valid=48, inlier_frac=0.6):
    rng = np.random.RandomState(seed)
    T = _pose(seed + 100)
    pa = (rng.rand(M, 3) * 0.3).astype(np.float32)
    na = rng.randn(M, 3).astype(np.float32)
    na /= np.linalg.norm(na, axis=-1, keepdims=True)
    pb = pa @ T[:3, :3].T + T[:3, 3] + 0.002 * rng.randn(M, 3)
    nb = na @ T[:3, :3].T
    out = rng.rand(M) > inlier_frac
    pb[out] = rng.rand(out.sum(), 3) * 0.3
    valid = np.zeros(M, bool)
    valid[rng.permutation(M)[:n_valid]] = True
    return [pa, pb.astype(np.float32), na, nb.astype(np.float32), valid], T


def _phases(key, num_trials, M):
    n_rep = -(-num_trials // M)
    return np.asarray(jax.random.randint(key, (3, n_rep), 0, M, dtype=jnp.int32))


def _check_ransac(got, ref, args, inlier_dist=0.01, cos_deg=45.0):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.best_pose.numpy(), np.asarray(ref.best_pose), atol=POSE_ATOL)
    # inliers identical away from the thresholds (a residual within f32
    # rounding of the threshold may fall either side)
    T = np.asarray(ref.best_pose, np.float64)
    pa, pb, na, nb, _ = (np.asarray(a, np.float64) for a in args)
    d2 = np.sum((np.einsum("...ij,...nj->...ni", T[..., :3, :3], pa) + T[..., None, :3, 3] - pb) ** 2, -1)
    cs = np.sum(np.einsum("...ij,...nj->...ni", T[..., :3, :3], na) * nb, -1)
    clear = (np.abs(d2 - inlier_dist**2) > 1e-7) & (np.abs(cs - np.cos(np.deg2rad(cos_deg))) > 1e-5)
    np.testing.assert_array_equal(got.inliers.numpy()[clear], np.asarray(ref.inliers)[clear])


@pytest.mark.parametrize("seed,gate", [(0, False), (1, False), (2, True)])
def test_ransac_pair_with_jax_phases(seed, gate):
    args, T = _matches(seed)
    prior = T if gate else np.eye(4, dtype=np.float32)
    kw = dict(num_trials=256, inlier_dist=0.01, inlier_normal_deg=45.0, min_matches=5)
    if gate:
        kw.update(max_trans=0.02, max_rot_deg=10.0)
    key = jax.random.PRNGKey(seed)
    ref = jr.ransac_pair(key, *(jnp.asarray(a) for a in args), jnp.asarray(prior), **kw)
    got = tr.ransac_pair(*(_t(a) for a in args), _t(prior), phases=_t(_phases(key, 256, 64)), **kw)
    assert bool(ref.valid) and int(ref.num_inliers) > 15
    _check_ransac(got, ref, args)
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_ransac_pairs_batched_like_the_tracker():
    cases = [_matches(s) for s in (3, 4, 5)]
    args = [np.stack([c[0][k] for c in cases]) for k in range(5)]
    args[4][2, 4:] = False  # too few valid matches: no model
    prior = np.stack([np.eye(4, dtype=np.float32)] * 3)
    kw = dict(num_trials=200, inlier_dist=0.01, inlier_normal_deg=45.0, min_matches=5)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    ref = jax.vmap(lambda k, a, b, c, d, e, p: jr.ransac_pair(k, a, b, c, d, e, p, **kw))(
        keys, *(jnp.asarray(a) for a in args), jnp.asarray(prior)
    )
    phases = np.stack([_phases(k, 200, 64) for k in keys])
    got = tr.ransac_pair(*(_t(a) for a in args), _t(prior), phases=_t(phases), **kw)
    _check_ransac(got, ref, args)
    assert not bool(got.valid[2])


def test_ransac_draws_phases_from_generator():
    args, _ = _matches(6)
    phases = tr.draw_phases((), 256, 64, torch.Generator().manual_seed(0))
    res = tr.ransac_pair(*(_t(a) for a in args), torch.eye(4), phases=phases, num_trials=256)
    assert bool(res.valid) and int(res.num_inliers) > 15


def test_refine_pose_on_inliers():
    args, _ = _matches(8)
    inl = args[4] & (np.random.RandomState(8).rand(64) > 0.5)
    got = tr.refine_pose_on_inliers(_t(args[0]), _t(args[1]), _t(inl))
    ref = jr.refine_pose_on_inliers(jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.asarray(inl))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE_ATOL)


def _graph(seed, K=4, M=30):
    """K noisy poses and sparse correspondences of shared model points."""
    rng = np.random.RandomState(seed)
    gt = np.stack([_pose(seed * 10 + k, rot=0.2, trans=0.1) for k in range(K)])
    X = (rng.rand(M, 3) - 0.5) * 0.3
    pi, pj = np.triu_indices(K, k=1)
    cam = lambda T, X: (X - T[:3, 3]) @ T[:3, :3]  # model -> camera of frame T
    pts_i = np.stack([cam(gt[i], X) for i in pi]).astype(np.float32)
    pts_j = np.stack([cam(gt[j], X) + 0.001 * rng.randn(M, 3) for j in pj]).astype(np.float32)
    valid = rng.rand(len(pi), M) > 0.2
    noisy = np.stack([gt[0]] + [_pose(seed + 50 + k, 0.02, 0.01) @ gt[k] for k in range(1, K)]).astype(np.float32)
    return noisy, (pi.astype(np.int32), pj.astype(np.int32), pts_i, pts_j, valid)


def test_sparse_normal_equations():
    poses, corres = _graph(0)
    got = tres.sparse_normal_equations(_t(poses), tres.SparseCorres(*map(_t, corres)), 0.005)
    ref = jres.sparse_normal_equations(jnp.asarray(poses), jres.SparseCorres(*map(jnp.asarray, corres)), 0.005)
    for g, r in zip(got, ref):
        _rel_close(g.numpy(), r)


@pytest.fixture(scope="module")
def dense_frames():
    """Three rendered frames compacted by the JAX package at 1/4 resolution."""
    seq = render_synthetic_sequence(num_frames=3, H=120, W=160, orbit_deg_per_frame=3.0)
    maps = []
    for f in range(3):
        depth = j_process_depth(jnp.asarray(seq.depth[f]), DepthProcessingConfig())
        pts, nrm, val = j_cloud(depth, jnp.asarray(seq.K))
        val = val & jnp.asarray(seq.mask[f])
        maps.append([np.array(a[::4, ::4]) for a in (pts, nrm, val)])
    K_low = np.array(j_scale_intrinsics(jnp.asarray(seq.K), 0.25))
    poses = np.linalg.inv(seq.ob_in_cam).astype(np.float32)
    return maps, K_low, poses


def test_compact_frame(dense_frames):
    maps, _, _ = dense_frames
    got = tdp.compact_frame(*(_t(a) for a in maps[0]), capacity=500)
    ref = jdp.compact_frame(*(jnp.asarray(a) for a in maps[0]), 500)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.lin.numpy(), np.asarray(ref.lin))
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(ref.src))  # gathers: exact
    # the bf16 hi/lo depth table: the same bits
    np.testing.assert_array_equal(got.tchan.view(torch.int16).numpy(), np.asarray(ref.tchan).view(np.int16))


def _compact(lib, maps):
    mod = tdp if lib == "torch" else jdp
    conv = _t if lib == "torch" else jnp.asarray
    fds = [mod.compact_frame(*(conv(a) for a in m), 1200) for m in maps]
    stack = torch.stack if lib == "torch" else jnp.stack
    return mod.stack_frame_dense(*(stack([getattr(fd, k) for fd in fds]) for k in ("src", "valid", "lin", "tchan")))


@pytest.mark.parametrize("perturb", [False, True])
def test_dense_p2p_from_compact(dense_frames, perturb):
    maps, K_low, poses = dense_frames
    if perturb:
        poses = poses.copy()
        poses[2] = _pose(3, 0.01, 0.005) @ poses[2]
    pi, pj = (a.astype(np.int32) for a in np.triu_indices(3, k=1))
    fv = np.ones(3, bool)
    kw = dict(min_pair_pixels=100)  # 30x40 maps give a few hundred pairs per frame pair
    got = tdp.dense_p2p_from_compact(_t(poses), _compact("torch", maps), _t(fv), _t(pi), _t(pj), _t(K_low), **kw)
    ref = jdp.dense_p2p_from_compact(jnp.asarray(poses), _compact("jax", maps), jnp.asarray(fv),
                                     jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(K_low), **kw)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))  # correspondence counts
    assert int(got[3].min()) >= 100
    for g, r in zip(got[:3], ref[:3]):
        _rel_close(g.numpy(), r)


@pytest.mark.parametrize("verify", [False, True])
def test_optimize_pose_graph_verified(dense_frames, verify):
    maps, K_low, _ = dense_frames
    poses, corres = _graph(1, K=3)
    bcfg = BundleConfig(max_ba_frames=3, use_verification=verify)
    p2p = P2PConfig(min_pair_pixels=100)
    fv = np.ones(3, bool)
    free = np.arange(3) > 0
    got_in = tgn.GraphInputs(_t(poses), _t(fv), _t(free), tres.SparseCorres(*map(_t, corres)),
                             dense_compact=_compact("torch", maps), K_lowres=_t(K_low))
    ref_in = jgn.GraphInputs(jnp.asarray(poses), jnp.asarray(fv), jnp.asarray(free),
                             jres.SparseCorres(*map(jnp.asarray, corres)),
                             dense_compact=_compact("jax", maps), K_lowres=jnp.asarray(K_low))
    got, g_rej, _ = tgn.optimize_pose_graph_verified(
        got_in, tcfg.BundleConfig(**dataclasses.asdict(bcfg)), p2p=tcfg.P2PConfig(**dataclasses.asdict(p2p)))
    ref, r_rej, _ = jgn.optimize_pose_graph_verified(ref_in, bcfg, p2p=p2p)
    assert bool(g_rej) == bool(r_rej)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE_ATOL)
    assert np.abs(np.asarray(ref) - poses).max() > 1e-3  # the solve moved the poses


def test_cholesky_failure_takes_a_zero_step():
    K = 2
    H = np.zeros((K, K, 6, 6), np.float32)
    H[0, 0] = np.eye(6)
    H[1, 1] = -np.eye(6) * 5.0  # not positive definite after damping
    g = np.ones((K, 6), np.float32)
    got = tgn.solve_normal_equations_cholesky(_t(H), _t(g), 1e-6)
    ref = jgn.solve_normal_equations_cholesky(jnp.asarray(H), jnp.asarray(g), 1e-6)
    assert not np.any(np.asarray(ref)) and not got.abs().sum()
    H[1, 1] = np.eye(6) * 3.0  # positive definite: a real step, as in JAX
    got = tgn.solve_normal_equations_cholesky(_t(H), _t(g), 1e-6)
    ref = jgn.solve_normal_equations_cholesky(jnp.asarray(H), jnp.asarray(g), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("n_used", [0, 3, 8])
def test_keyframe_selection(n_used):
    rng = np.random.RandomState(n_used)
    Kp = 8
    kf_id = np.full(Kp, -1, np.int32)
    used = rng.permutation(Kp)[:n_used]
    kf_id[used] = rng.permutation(50)[:n_used]
    kf_pose = np.stack([_pose(100 + k, rot=0.4) for k in range(Kp)]).astype(np.float32)
    new_pose = _pose(7, rot=0.4)
    slots, valid = tsel.select_ba_subset(_t(kf_id), _t(kf_pose), _t(new_pose), 4)
    r_slots, r_valid = jsel.select_ba_subset(jnp.asarray(kf_id), jnp.asarray(kf_pose), jnp.asarray(new_pose), 4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(r_valid))
    np.testing.assert_array_equal(slots.numpy()[valid.numpy()], np.asarray(r_slots)[np.asarray(r_valid)])
    assert int(tsel.eviction_slot(_t(kf_id), _t(kf_pose))) == int(jsel.eviction_slot(jnp.asarray(kf_id), jnp.asarray(kf_pose)))
    for rot in (5.0, 30.0):
        got = tsel.keyframe_admission(_t(kf_id), _t(kf_pose), _t(new_pose), torch.tensor(40), torch.tensor(True), 10, rot)
        ref = jsel.keyframe_admission(jnp.asarray(kf_id), jnp.asarray(kf_pose), jnp.asarray(new_pose), 40, True, 10, rot)
        assert bool(got) == bool(ref)
