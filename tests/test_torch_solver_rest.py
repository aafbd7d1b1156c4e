"""The rest of the solver against the JAX package: the PCG backend, the
photometric dense term with its compaction and the standalone dense solve,
depth fusion and the last geometry helpers; and the PCG and colour-weight
configurations through the tracker.

Each test gives both packages the same seeded numpy inputs and states its
tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
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
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.geometry import camera as jcam
from bundletrack_tpu.geometry import procrustes as jproc
from bundletrack_tpu.geometry import se3 as jse3
from bundletrack_tpu.ops import fusion as jfusion
from bundletrack_tpu.ops import intensity as jint
from bundletrack_tpu.solver import dense_p2p as jdp
from bundletrack_tpu.solver import gauss_newton as jgn
from bundletrack_tpu.solver import pcg as jpcg
from bundletrack_tpu.solver import residuals as jres
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch import config as tcfg
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.geometry import camera as tcam
from bundletrack_tpu_torch.geometry import procrustes as tproc
from bundletrack_tpu_torch.geometry import se3 as tse3
from bundletrack_tpu_torch.ops import fusion as tfusion
from bundletrack_tpu_torch.ops import intensity as tint
from bundletrack_tpu_torch.solver import dense_p2p as tdp
from bundletrack_tpu_torch.solver import gauss_newton as tgn
from bundletrack_tpu_torch.solver import pcg as tpcg
from bundletrack_tpu_torch.solver import residuals as tres
from bundletrack_tpu_torch.tracker.driver import Tracker
from jax_draws import phases_from_key

torch.set_num_threads(2)

# f32 everywhere; sums run in another order (per-graph dot products, the
# einsum block reductions), so results agree to a few ulps of the largest
# entry
PCG_RTOL = 1e-5  # relative to the largest |x| of the solve
HG_RTOL = 1e-4  # H, g, cost of the dense terms, relative to the largest entry
POSE_ATOL = 1e-4  # poses after a solve
GEOM_ATOL = 1e-6  # elementwise f32 geometry
# the tracker with PCG against JAX's, given JAX's RANSAC phases (the bars of
# tests/test_torch_fleet.py)
SEQ_TRANS_TOL, SEQ_ROT_TOL = 1e-4, 0.01  # m, deg


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, ref, rtol=HG_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-12), (err, np.abs(ref).max())


def _pose(rng, rot=0.3, trans=0.05):
    xi = np.concatenate([rng.randn(3) * trans, rng.randn(3) * rot]).astype(np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(xi)))


# ---- PCG ---------------------------------------------------------------------


def _spd_system(seed, K=4, fixed=None):
    """A random SPD blocked system [K, K, 6, 6] and g [K, 6]; frame `fixed`
    gauge-fixed as the solver does it (identity block, zero row, column and
    gradient)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(K * 6, K * 6).astype(np.float32)
    Hd = A @ A.T + 10.0 * np.eye(K * 6, dtype=np.float32)
    H = Hd.reshape(K, 6, K, 6).transpose(0, 2, 1, 3).copy()
    g = rng.randn(K, 6).astype(np.float32)
    if fixed is not None:
        free = np.arange(K) != fixed
        H, g = (np.array(a) for a in jgn._apply_gauge(jnp.asarray(H), jnp.asarray(g), jnp.asarray(free)))
    return H, g


@pytest.mark.parametrize("batch", [None, 3], ids=["one_graph", "three_graphs"])
@pytest.mark.parametrize("fixed", [None, 0], ids=["all_free", "gauge_fixed"])
def test_pcg_matches_jax(batch, fixed):
    """Five PCG steps (the default num_iter_inner), alone and batched over
    graphs: each batch entry equals JAX's solve of that graph."""
    n = 1 if batch is None else batch
    systems = [_spd_system(10 + b, fixed=fixed) for b in range(n)]
    ref = np.stack([np.asarray(jpcg.solve_normal_equations_pcg(jnp.asarray(H), jnp.asarray(g), 5, 1e-4))
                    for H, g in systems])
    H, g = (np.stack(a) for a in zip(*systems))
    if batch is None:
        H, g, ref = H[0], g[0], ref[0]
    got = tpcg.solve_normal_equations_pcg(_t(H), _t(g), num_iters=5, lm_lambda=1e-4).numpy()
    assert got.shape == ref.shape
    _rel_close(got, ref, PCG_RTOL)
    if fixed is not None:
        assert np.all(got[..., fixed, :] == 0.0)  # a fixed frame's gradient is zero: no step


def test_pcg_guards_a_zero_system():
    """g = 0 makes every denominator zero: the guards give a zero step, no
    NaN, as in JAX; a singular diagonal block does not raise."""
    H = np.zeros((3, 3, 6, 6), np.float32)
    g = np.zeros((3, 6), np.float32)
    got = tpcg.solve_normal_equations_pcg(_t(H), _t(g), num_iters=5, lm_lambda=0.0).numpy()
    ref = np.asarray(jpcg.solve_normal_equations_pcg(jnp.asarray(H), jnp.asarray(g), 5, 0.0))
    np.testing.assert_array_equal(got, np.zeros_like(got))
    np.testing.assert_array_equal(got, ref)


def test_cholesky_vs_pcg_against_numpy():
    """tests/test_solver.py::test_cholesky_vs_pcg's case."""
    H, g = _spd_system(7)
    ref = np.linalg.solve(H.transpose(0, 2, 1, 3).reshape(24, 24), -g.ravel())
    d1 = tgn.solve_normal_equations_cholesky(_t(H), _t(g), 0.0).numpy().ravel()
    d2 = tpcg.solve_normal_equations_pcg(_t(H), _t(g), num_iters=60, lm_lambda=0.0).numpy().ravel()
    np.testing.assert_allclose(d1, ref, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(d2, ref, atol=1e-2, rtol=1e-2)


def _build_graph(seed, K=5, n_landmarks=60, M=64):
    """tests/test_solver.py::build_graph: K poses, landmarks seen in every
    frame, all-pairs correspondences, and an initial guess off by a few cm."""
    rng = np.random.RandomState(seed)
    poses_gt = np.stack([np.eye(4, dtype=np.float32)] + [_pose(rng, 0.3, 0.2) for _ in range(K - 1)])
    landmarks = rng.rand(n_landmarks, 3).astype(np.float32) - 0.5
    cam = np.stack([(landmarks - T[:3, 3]) @ T[:3, :3] for T in poses_gt]).astype(np.float32)
    pi, pj = np.triu_indices(K, k=1)
    sel = rng.randint(0, n_landmarks, (len(pi), M))
    pts_i = np.take_along_axis(cam[pi], sel[..., None], axis=1)
    pts_j = np.take_along_axis(cam[pj], sel[..., None], axis=1)
    init = poses_gt.copy()
    for k in range(1, K):
        xi = np.concatenate([0.03 * rng.randn(3), 0.05 * rng.randn(3)]).astype(np.float32)
        init[k] = np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ init[k]
    corres = (pi.astype(np.int32), pj.astype(np.int32), pts_i, pts_j, np.ones((len(pi), M), bool))
    return poses_gt, init, corres


@pytest.mark.parametrize("backend", ["pcg", "cholesky"])
def test_pose_graph_converges_like_jax(backend):
    """tests/test_solver.py::TestPoseGraphOptimization's case (its bars:
    1e-3 for PCG, 1e-4 for Cholesky) and JAX's poses on the same graph."""
    poses_gt, init, corres = _build_graph(0)
    K = len(init)
    bcfg = BundleConfig(solver_backend=backend, w_dense_depth=0.0, num_iter_outer=7, num_iter_inner=10)
    free = np.arange(K) > 0
    got, _ = tgn.optimize_pose_graph(
        tgn.GraphInputs(_t(init), torch.ones(K, dtype=torch.bool), _t(free), tres.SparseCorres(*map(_t, corres))),
        tcfg.BundleConfig(**dataclasses.asdict(bcfg)))
    ref, _ = jgn.optimize_pose_graph(
        jgn.GraphInputs(jnp.asarray(init), jnp.ones(K, bool), jnp.asarray(free),
                        jres.SparseCorres(*map(jnp.asarray, corres))), bcfg)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=POSE_ATOL)
    bar = 1e-3 if backend == "pcg" else 1e-4
    for k in range(K):
        rot, trans = pose_errors(got[k], poses_gt[k])
        assert trans < bar and np.deg2rad(rot) < bar, (k, rot, trans)


def test_unknown_backend_raises():
    _, init, corres = _build_graph(1, K=3)
    inputs = tgn.GraphInputs(_t(init), torch.ones(3, dtype=torch.bool), torch.arange(3) > 0,
                             tres.SparseCorres(*map(_t, corres)))
    with pytest.raises(ValueError, match="'cholesky' or 'pcg'"):
        tgn.optimize_pose_graph(inputs, tcfg.BundleConfig(solver_backend="lu"))


# ---- the photometric term ---------------------------------------------------


@pytest.mark.parametrize("case", ["ramp", "texture_with_holes"])
def test_intensity_gradients(case):
    rng = np.random.RandomState(3)
    H, W = 16, 20
    if case == "ramp":
        img = np.tile(np.arange(W, dtype=np.float32), (H, 1)) * 0.1
        valid = np.ones((H, W), bool)
    else:
        img = rng.rand(H, W).astype(np.float32)
        valid = rng.rand(H, W) > 0.2
    got = tint.intensity_gradients(_t(img), _t(valid))
    ref = jint.intensity_gradients(jnp.asarray(img), jnp.asarray(valid))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))  # elementwise f32: exact
    if case == "ramp":  # tests/test_photometric.py::TestIntensityGradients
        np.testing.assert_allclose(got[0].numpy()[2:-2, 2:-2], 0.1, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy()[2:-2, 2:-2], 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def frames():
    """Three rendered 120x160 frames at 1/4 resolution (30x40) as DenseFrames
    numpy arrays, with intensity and its gradients; the low-res intrinsics
    and the true poses."""
    from bundletrack_tpu.geometry.camera import scale_intrinsics
    from bundletrack_tpu.ops.depth import process_depth
    from bundletrack_tpu.ops.pointcloud import depth_to_cloud_and_normals
    from bundletrack_tpu.config import DepthProcessingConfig

    seq = render_synthetic_sequence(num_frames=3, H=120, W=160, orbit_deg_per_frame=3.0)
    out = {k: [] for k in ("points", "normals", "valid", "intensity", "grad_x", "grad_y")}
    for f in range(3):
        depth = process_depth(jnp.asarray(seq.depth[f]), DepthProcessingConfig())
        pts, nrm, val = depth_to_cloud_and_normals(depth, jnp.asarray(seq.K))
        val = (val & jnp.asarray(seq.mask[f]))[::4, ::4]
        inten = jnp.asarray(seq.gray[f][::4, ::4].astype(np.float32) / 255.0)
        gx, gy = jint.intensity_gradients(inten, val)
        for k, a in zip(out, (pts[::4, ::4], nrm[::4, ::4], val, inten, gx, gy)):
            out[k].append(np.array(a))
    K_low = np.array(scale_intrinsics(jnp.asarray(seq.K), 0.25))
    return {k: np.stack(v) for k, v in out.items()}, K_low, np.linalg.inv(seq.ob_in_cam).astype(np.float32)


def _frames(lib, arrays):
    if lib == "torch":
        return tdp.DenseFrames(**{k: _t(v) for k, v in arrays.items()})
    return jdp.DenseFrames(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("with_color", [False, True], ids=["geometry", "with_color"])
def test_compact_dense_frames(frames, with_color):
    arrays, _, _ = frames
    got = tdp.compact_dense_frames(_frames("torch", arrays), capacity=600, with_color=with_color)
    ref = jdp.compact_dense_frames(_frames("jax", arrays), capacity=600, with_color=with_color)
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(ref.src))  # gathers: exact
    np.testing.assert_array_equal(got.src_valid.numpy(), np.asarray(ref.src_valid))
    np.testing.assert_array_equal(got.src_lin.numpy(), np.asarray(ref.src_lin))
    np.testing.assert_array_equal(got.tchan.view(torch.int16).numpy(), np.asarray(ref.tchan).view(np.int16))
    if with_color:
        np.testing.assert_array_equal(got.cchan.numpy(), np.asarray(ref.cchan))
    else:
        assert got.cchan is None and ref.cchan is None


def _pairs(K=3):
    return tuple(a.astype(np.int32) for a in np.triu_indices(K, k=1))


@pytest.mark.parametrize("perturb", [False, True])
def test_dense_color_term_matches_jax(frames, perturb):
    """dense_p2p_from_compact with the photometric term on, depth weight 1
    and 0: H, g, cost and the correspondence counts."""
    arrays, K_low, poses = frames
    if perturb:
        poses = poses.copy()
        poses[2] = _pose(np.random.RandomState(4), 0.01, 0.005) @ poses[2]
    pi, pj = _pairs()
    fv = np.ones(3, bool)
    cd_t = tdp.compact_dense_frames(_frames("torch", arrays), capacity=600, with_color=True)
    cd_j = jdp.compact_dense_frames(_frames("jax", arrays), capacity=600, with_color=True)
    for weight in (1.0, 0.0):
        kw = dict(min_pair_pixels=100, weight=weight, weight_color=1.0)
        got = tdp.dense_p2p_from_compact(_t(poses), cd_t, _t(fv), _t(pi), _t(pj), _t(K_low), **kw)
        ref = jdp.dense_p2p_from_compact(jnp.asarray(poses), cd_j, jnp.asarray(fv), jnp.asarray(pi),
                                         jnp.asarray(pj), jnp.asarray(K_low), **kw)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
        assert int(got[3].min()) >= 100
        for g, r in zip(got[:3], ref[:3]):
            _rel_close(g.numpy(), r)
        assert float(np.abs(np.asarray(ref[0])).max()) > 0.0


def test_dense_p2p_normal_equations_matches_jax(frames):
    """The one-shot form, with a capacity and the colour term."""
    arrays, K_low, poses = frames
    pi, pj = _pairs()
    kw = dict(min_pair_pixels=100, weight_color=0.5, src_capacity=400)
    got = tdp.dense_p2p_normal_equations(_t(poses), _frames("torch", arrays), torch.ones(3, dtype=torch.bool),
                                         _t(pi), _t(pj), _t(K_low), **kw)
    ref = jdp.dense_p2p_normal_equations(jnp.asarray(poses), _frames("jax", arrays), jnp.ones(3, bool),
                                         jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(K_low), **kw)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for g, r in zip(got[:3], ref[:3]):
        _rel_close(g.numpy(), r)


def _plane_problem():
    """tests/test_photometric.py::test_recovers_in_plane_shift: a textured
    fronto-parallel plane seen twice, frame 1 shifted 4 mm in x."""
    H, W = 48, 64
    K = np.array([[60.0, 0, W / 2 - 0.5], [0, 60.0, H / 2 - 0.5], [0, 0, 1]], np.float32)
    pts = np.asarray(jcam.unproject(jnp.asarray(np.full((H, W), 1.0, np.float32)), jnp.asarray(K)))
    normals = np.zeros((H, W, 3), np.float32)
    normals[..., 2] = -1.0
    valid = np.ones((H, W), bool)
    intensity = (0.5 + 0.2 * np.sin(20.0 * pts[..., 0]) + 0.2 * np.cos(17.0 * pts[..., 1])).astype(np.float32)
    gx, gy = (np.asarray(a) for a in jint.intensity_gradients(jnp.asarray(intensity), jnp.asarray(valid)))
    arrays = {k: np.stack([a, a]) for k, a in
              dict(points=pts, normals=normals, valid=valid, intensity=intensity, grad_x=gx, grad_y=gy).items()}
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses[1][0, 3] = 0.004
    return arrays, K, poses


def test_photometric_in_plane_shift_like_jax():
    """The 4 mm shift falls below 2 mm (the JAX test's bar), and the poses
    equal JAX's."""
    arrays, K, poses = _plane_problem()
    bcfg = BundleConfig(w_sparse=0.0, w_dense_depth=0.0, w_dense_color=1.0, num_iter_outer=6, lm_lambda=1e-4)
    corres = (np.array([0], np.int32), np.array([1], np.int32), np.zeros((1, 4, 3), np.float32),
              np.zeros((1, 4, 3), np.float32), np.zeros((1, 4), bool))
    got, _ = tgn.optimize_pose_graph(
        tgn.GraphInputs(_t(poses), torch.ones(2, dtype=torch.bool), torch.tensor([False, True]),
                        tres.SparseCorres(*map(_t, corres)), K_lowres=_t(K), dense=_frames("torch", arrays)),
        tcfg.BundleConfig(**dataclasses.asdict(bcfg)))
    ref, _ = jgn.optimize_pose_graph(
        jgn.GraphInputs(jnp.asarray(poses), jnp.ones(2, bool), jnp.asarray([False, True]),
                        jres.SparseCorres(*map(jnp.asarray, corres)), dense=_frames("jax", arrays),
                        K_lowres=jnp.asarray(K)), bcfg)
    got = got.numpy()
    assert abs(got[1][0, 3]) < 0.002, got[1][:3, 3]
    np.testing.assert_allclose(got, np.asarray(ref), atol=POSE_ATOL)


@pytest.mark.parametrize("backend", ["cholesky", "pcg"])
def test_standalone_dense_solve_matches_jax(frames, backend):
    """GraphInputs.dense with both dense weights on: compacted once per
    solve in both packages; sparse, depth and colour terms together."""
    arrays, K_low, poses = frames
    rng = np.random.RandomState(5)
    init = poses.copy()
    init[1:] = np.stack([_pose(rng, 0.005, 0.003) @ p for p in poses[1:]])
    pi, pj = _pairs()
    M = 16
    pts = (rng.rand(len(pi), M, 3).astype(np.float32) - 0.5) * 0.1
    corres = (pi, pj, pts, pts, np.zeros((len(pi), M), bool))
    bcfg = BundleConfig(max_ba_frames=3, w_dense_color=0.5, dense_src_capacity=600, solver_backend=backend)
    from bundletrack_tpu.config import P2PConfig

    p2p = P2PConfig(min_pair_pixels=100)
    free = np.arange(3) > 0
    got, _ = tgn.optimize_pose_graph(
        tgn.GraphInputs(_t(init), torch.ones(3, dtype=torch.bool), _t(free), tres.SparseCorres(*map(_t, corres)),
                        K_lowres=_t(K_low), dense=_frames("torch", arrays)),
        tcfg.BundleConfig(**dataclasses.asdict(bcfg)), p2p=tcfg.P2PConfig(**dataclasses.asdict(p2p)))
    ref, _ = jgn.optimize_pose_graph(
        jgn.GraphInputs(jnp.asarray(init), jnp.ones(3, bool), jnp.asarray(free),
                        jres.SparseCorres(*map(jnp.asarray, corres)), dense=_frames("jax", arrays),
                        K_lowres=jnp.asarray(K_low)), bcfg, p2p=p2p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=POSE_ATOL)
    assert np.abs(np.asarray(ref) - init).max() > 1e-4  # the solve moved the poses


# ---- geometry and fusion ----------------------------------------------------


def test_project_matches_jax():
    rng = np.random.RandomState(6)
    pts = (rng.rand(50, 3).astype(np.float32) - 0.5) * 0.4
    pts[:, 2] += 0.6
    pts[0, 2] = 0.0  # |z| < 1e-8 divides by 1e-8
    K = np.array([[500.0, 0, 320.0], [0, 505.0, 240.0], [0, 0, 1]], np.float32)
    got = tcam.project(_t(pts), _t(K))
    ref = jcam.project(jnp.asarray(pts), jnp.asarray(K))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "three_channels"])
@pytest.mark.parametrize("with_valid", [False, True], ids=["no_mask", "validity_mask"])
def test_bilinear_sample_matches_jax(channels, with_valid):
    """Taps inside, on the border and outside the image, with and without
    a validity mask: values and the valid weight."""
    rng = np.random.RandomState(7)
    H, W = 12, 16
    img = rng.rand(H, W).astype(np.float32) if channels is None else rng.rand(H, W, channels).astype(np.float32)
    u = rng.uniform(-2.0, W + 1.0, 200).astype(np.float32)
    v = rng.uniform(-2.0, H + 1.0, 200).astype(np.float32)
    valid = rng.rand(H, W) > 0.3 if with_valid else None
    got = tcam.bilinear_sample(_t(img), _t(u), _t(v), None if valid is None else _t(valid))
    ref = jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v),
                               None if valid is None else jnp.asarray(valid))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GEOM_ATOL)
    w = got[1].numpy()
    assert (w == 0).any() and (w > 0.999).any()  # some taps wholly outside, some wholly valid


def test_umeyama_rigid_matches_jax():
    rng = np.random.RandomState(8)
    T = _pose(rng, 0.5, 0.1)
    src = rng.rand(2, 40, 3).astype(np.float32)
    dst = (src @ T[:3, :3].T + T[:3, 3] + 0.001 * rng.randn(2, 40, 3)).astype(np.float32)
    w = rng.rand(2, 40).astype(np.float32)
    got = tproc.umeyama_rigid(_t(src), _t(dst), _t(w)).numpy()
    ref = np.asarray(jproc.umeyama_rigid(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got[0], T, atol=5e-3)


def test_orthonormalize_matches_jax():
    rng = np.random.RandomState(9)
    R = np.stack([_pose(rng, 1.0)[:3, :3] for _ in range(5)])
    R_noisy = (R + 0.02 * rng.randn(5, 3, 3)).astype(np.float32)
    R_noisy[0] = np.diag([1.0, 1.0, -1.0]).astype(np.float32) @ R[0]  # a reflection goes to a rotation
    got = tse3.orthonormalize(_t(R_noisy)).numpy()
    ref = np.asarray(jse3.orthonormalize(jnp.asarray(R_noisy)))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), (5, 3, 3)), atol=1e-5)


def test_fuse_depth_frames_matches_jax():
    """Four rendered depth maps from an orbit, fused into frame 1's view:
    reprojection, out-of-image drops and the max_dist gate."""
    seq = render_synthetic_sequence(num_frames=4, H=60, W=80, orbit_deg_per_frame=6.0)
    depths = seq.depth.astype(np.float32)
    poses = np.linalg.inv(seq.ob_in_cam).astype(np.float32)
    K = seq.K.astype(np.float32)
    got = tfusion.fuse_depth_frames(_t(depths), _t(poses), _t(K), target_idx=1, max_dist=0.01).numpy()
    ref = np.asarray(jfusion.fuse_depth_frames(jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(K),
                                               target_idx=1, max_dist=0.01))
    np.testing.assert_allclose(got, ref, atol=1e-6)  # the same sums, frame-major on both CPUs
    assert (got != depths[1]).mean() > 0.05  # fusion changed part of the target


def test_fusing_identical_frames_denoises():
    """tests/test_fusion_verify.py::TestDepthFusion, and JAX's result."""
    rng = np.random.RandomState(0)
    H, W = 32, 40
    K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    depths = np.stack([np.full((H, W), 1.0, np.float32) + 0.005 * rng.randn(H, W).astype(np.float32)
                       for _ in range(5)])
    poses = np.stack([np.eye(4, dtype=np.float32)] * 5)
    fused = tfusion.fuse_depth_frames(_t(depths), _t(poses), _t(K)).numpy()
    inner = slice(4, -4)
    assert np.abs(fused[inner, inner] - 1.0).std() < np.abs(depths[0][inner, inner] - 1.0).std()
    ref = np.asarray(jfusion.fuse_depth_frames(jnp.asarray(depths), jnp.asarray(poses), jnp.asarray(K)))
    np.testing.assert_allclose(fused, ref, atol=1e-6)


def test_fusion_keeps_invalid_depth():
    """tests/test_fusion_verify.py::TestDepthFusion::test_invalid_stays."""
    K = np.array([[50.0, 0, 8], [0, 50.0, 8], [0, 0, 1]], np.float32)
    depths = np.zeros((2, 16, 16), np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
    assert (tfusion.fuse_depth_frames(_t(depths), _t(poses), _t(K)).numpy() == 0).all()


# ---- PCG and the colour weight in the tracker ------------------------------


TH, TW, TF = 96, 128, 4


def _jax_tracker_cfg(**bundle):
    """tests/test_fleet.py::tiny_cfg with the Pallas matcher in interpret mode."""
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=4, num_iter_outer=3, **bundle),
        keyframe=KeyframeConfig(pool_size=4, min_rot=5.0),
        frontend=FrontendConfig(top_k=64),
        ransac=RansacConfig(max_iter=128),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=64, image_h=TH, image_w=TW),
    )


@pytest.fixture(scope="module")
def tracker_seq():
    return render_synthetic_sequence(num_frames=TF, H=TH, W=TW, orbit_deg_per_frame=3.0)


def _run_both(cfg, seq):
    """Both trackers over the sequence, the port on JAX's phases; the
    outputs of each, as numpy."""
    init_pose = np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32)
    jtrk = JaxTracker(cfg, TH, TW)
    ttrk = Tracker(load_config(dataclasses.asdict(cfg)), TH, TW, device="cpu")
    outs = []
    for f in range(len(seq.gray)):
        phases = phases_from_key(jtrk.state.rng_key, cfg)
        j = jax.tree.map(np.array, jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose))
        t = ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases)
        outs.append((j, t))
    return outs


def test_pcg_tracker_follows_jax(tracker_seq):
    """solver_backend="pcg" through both trackers for 4 frames."""
    outs = _run_both(_jax_tracker_cfg(solver_backend="pcg"), tracker_seq)
    for f, (j, t) in enumerate(outs):
        assert int(t.status) == int(j.status) == 0, f
        rot, trans = pose_errors(t.ob_in_cam.numpy(), j.ob_in_cam)
        assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, rot, trans)
        rot, trans = pose_errors(t.ob_in_cam.numpy(), tracker_seq.ob_in_cam[f])
        assert rot < 1.0 and trans < 0.005, (f, rot, trans)  # the tracker's pose bars


def test_tracker_colour_weight_changes_nothing(tracker_seq):
    """The keyframe tables carry no intensity, so w_dense_color = 1 computes
    no photometric term in either tracker: the poses equal those of
    w_dense_color = 0, and the port follows JAX."""
    with_colour = _run_both(_jax_tracker_cfg(w_dense_color=1.0), tracker_seq)
    ttrk = Tracker(load_config(dataclasses.asdict(_jax_tracker_cfg())), TH, TW, device="cpu")
    init_pose = np.linalg.inv(tracker_seq.ob_in_cam[0]).astype(np.float32)
    for f, (j, t) in enumerate(with_colour):
        assert int(t.status) == int(j.status) == 0, f
        rot, trans = pose_errors(t.ob_in_cam.numpy(), j.ob_in_cam)
        assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, rot, trans)
    # the same frames without the colour weight, on the same phases
    jtrk = JaxTracker(_jax_tracker_cfg(), TH, TW)
    for f in range(TF):
        phases = phases_from_key(jtrk.state.rng_key, _jax_tracker_cfg())
        j0 = jtrk.process_frame(tracker_seq.gray[f], tracker_seq.depth[f], tracker_seq.mask[f], tracker_seq.K,
                                init_pose)
        t0 = ttrk.process_frame(tracker_seq.gray[f], tracker_seq.depth[f], tracker_seq.mask[f], tracker_seq.K,
                                init_pose, phases=phases)
        np.testing.assert_array_equal(np.asarray(j0.ob_in_cam), with_colour[f][0].ob_in_cam)
        np.testing.assert_array_equal(t0.ob_in_cam.numpy(), with_colour[f][1].ob_in_cam.numpy())
