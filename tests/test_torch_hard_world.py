"""The port's hard world, its suites and the frontend metrics against the JAX package.

The renderers, model points, warp fields and pass reports are numpy on
both sides and must be equal; the frontend metrics run the classical
frontend in each package and must agree within 1e-6; the VOS masks of
`generate_vos_masks` must be equal on every pixel; and a hard pass tracked
by both packages, the port given the JAX tracker's RANSAC phases, must give
the same statuses and poses within 1e-5 m and 1e-3 deg.  Small sizes
(48x64 to 120x160), on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.config import (
    BundleConfig as JBundleConfig,
    FeatureCorresConfig as JFeatureCorresConfig,
    FrontendConfig as JFrontendConfig,
    KeyframeConfig as JKeyframeConfig,
    RansacConfig as JRansacConfig,
    SegmentationConfig as JSegmentationConfig,
    ShapeConfig as JShapeConfig,
    TrackerConfig as JTrackerConfig,
)
from bundletrack_tpu.data import hard_world as jhw
from bundletrack_tpu.data.pairs import warp_field_from_depth as jwarp
from bundletrack_tpu.eval import evaluate_frontend as jevaluate_frontend
from bundletrack_tpu.eval import hard_suite as jhs
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.apps.run_vos import VOS_CKPT
from bundletrack_tpu_torch.config import (
    BundleConfig,
    FrontendConfig,
    SegmentationConfig,
    ShapeConfig,
    TrackerConfig,
    load_config,
)
from bundletrack_tpu_torch.data import hard_world as hw
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.data.pairs import warp_field_from_depth
from bundletrack_tpu_torch.eval import evaluate_frontend
from bundletrack_tpu_torch.eval import hard_suite as hs
from bundletrack_tpu_torch.models import vos
from bundletrack_tpu_torch.tracker.driver import Tracker

torch.set_num_threads(2)

FRONTEND_TOL = 1e-6  # the metrics are ratios of counts: equal keypoints give equal metrics
TRAJ_TRANS_TOL, TRAJ_ROT_TOL = 1e-5, 1e-3  # m, deg: f32 summation order only


# ---- the renderers -----------------------------------------------------------


@pytest.fixture(scope="module")
def passes():
    """Every pass of both suites, 3 frames at 48x64, from both packages."""
    kw = dict(H=48, W=64, num_frames=3)
    return {
        "hard": (hw.hard_passes(**kw), jhw.hard_passes(**kw)),
        "long": (hw.long_hard_passes(**kw), jhw.long_hard_passes(**kw)),
    }


@pytest.mark.parametrize("suite,name", [
    ("hard", n) for n in ("cube", "cylinder", "lshape", "scale2x", "fastrot")
] + [("long", n) for n in ("orbit", "occluder", "scale2x")])
def test_pass_renders_equal_jax(passes, suite, name):
    port, ref = passes[suite]
    assert list(port) == list(ref)
    got, want = port[name], ref[name]
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.mask_gt.any()


@pytest.mark.parametrize("shape", ["cube", "cylinder", "lshape", "tshape"])
def test_model_points_equal_jax(shape):
    got = hw.model_points(shape, size=0.2)
    np.testing.assert_array_equal(got, jhw.model_points(shape, size=0.2))
    assert got.shape == (500, 3) and got.dtype == np.float32


def test_unknown_shape_raises():
    with pytest.raises(ValueError, match="unknown shape"):
        hw.model_points("sphere")


# ---- warp fields -------------------------------------------------------------


@pytest.mark.parametrize("source", ["easy", "hard"])
@pytest.mark.parametrize("with_depth2", [True, False])
def test_warp_field_equals_jax(passes, source, with_depth2):
    seq = (render_synthetic_sequence(num_frames=3, H=48, W=64, orbit_deg_per_frame=4.0)
           if source == "easy" else passes["hard"][0]["fastrot"])
    args = (seq.depth[0], seq.K, seq.ob_in_cam[0], seq.ob_in_cam[2])
    kw = dict(depth2=seq.depth[2] if with_depth2 else None, mask1=seq.mask[0])
    got, want = warp_field_from_depth(*args, **kw), jwarp(*args, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].any()


# ---- pass reports ------------------------------------------------------------


@pytest.mark.parametrize("noisy", [False, True])
def test_pass_report_equals_jax(noisy):
    """test_long_suite.py::test_pass_report_fields on the port, and the port's
    report equal to JAX's on the same poses."""
    seq = hw.render_hard_sequence("cube", num_frames=4, H=48, W=64, seed=5)
    poses = [np.asarray(p) for p in seq.ob_in_cam]
    if noisy:
        rng = np.random.RandomState(1)
        poses = [p @ _small_motion(rng) for p in poses]
    statuses = [0, 0, 2, 1]
    rep = hs.pass_report(poses, statuses, seq, "cube")
    assert rep == jhs.pass_report(poses, statuses, seq, "cube")
    assert rep["n_fail"] == 1 and rep["n_no_ba"] == 1 and rep["frames"] == 4
    if not noisy:
        assert rep["adds_auc"] == 100.0
        assert rep["max_trans_err_mm"] < 1e-3


def _small_motion(rng):
    from scipy.spatial.transform import Rotation

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.02).as_matrix()
    T[:3, 3] = rng.randn(3) * 0.003
    return T


# ---- frontend metrics --------------------------------------------------------


def _frontend_case(case):
    if case == "easy":
        seq = render_synthetic_sequence(num_frames=5, H=120, W=160, orbit_deg_per_frame=2.0)
        return seq, dict(top_k=128), dict(gap=1, eps_px=3.0)
    if case == "hard":
        seq = hw.render_hard_sequence("lshape", num_frames=5, H=96, W=128, seed=2)
        return seq, dict(top_k=128), dict(gap=1, eps_px=3.0)
    seq = render_synthetic_sequence(num_frames=2, H=96, W=128, orbit_deg_per_frame=0.0)
    return seq, dict(top_k=64), dict(gap=1, eps_px=2.0)


@pytest.mark.parametrize("case", ["easy", "hard", "identity"])
def test_evaluate_frontend_matches_jax(case):
    """TestFrontendEval's bars on the port, and the port's metrics within
    1e-6 of JAX's (4 pairs of the easy renderer and of a hard pass, and the
    perfect identity pair)."""
    seq, fkw, ekw = _frontend_case(case)
    got = evaluate_frontend(seq, FrontendConfig(kind="classical", **fkw), device="cpu", **ekw)
    want = jevaluate_frontend(seq, JFrontendConfig(kind="classical", **fkw), **ekw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= FRONTEND_TOL, (k, got, want)
    if case == "easy":
        assert got["repeatability"] > 0.5 and got["inlier_rate"] > 0.5 and got["n_matches"] > 20, got
    if case == "identity":
        assert got["repeatability"] > 0.95 and got["inlier_rate"] > 0.95, got


def test_evaluate_frontend_max_pairs():
    seq, fkw, ekw = _frontend_case("easy")
    cfg = FrontendConfig(kind="classical", **fkw)
    one = evaluate_frontend(seq, cfg, device="cpu", max_pairs=1, **ekw)
    want = jevaluate_frontend(seq, JFrontendConfig(kind="classical", **fkw), max_pairs=1, **ekw)
    assert one == pytest.approx(want, abs=FRONTEND_TOL)


# ---- the long suite and VOS masks --------------------------------------------


def _tiny_cfg(H, W):
    return TrackerConfig(shapes=ShapeConfig(image_h=H, image_w=W), bundle=BundleConfig(dense_src_capacity=256))


def test_run_long_suite_tiny():
    """test_long_suite.py::test_run_long_suite_tiny on the port, with the
    shipped VOS weights re-tracking the orbit on propagated masks."""
    H, W = 96, 128
    passes = {"orbit": hw.render_hard_sequence("lshape", num_frames=5, H=H, W=W, seed=11)}
    out = hs.run_long_suite(_tiny_cfg(H, W), passes=passes, vos_ckpt=VOS_CKPT, device="cpu")
    assert set(out["passes"]) == {"orbit", "orbit_vosmask"}
    assert out["passes"]["orbit"]["frames"] == 5
    rep = out["passes"]["orbit_vosmask"]
    assert rep["frames"] == 5 and 0.0 <= rep["vos_mask_min_iou"] <= rep["vos_mask_mean_iou"] <= 1.0
    assert isinstance(out["mean_adds_auc"], float)


def test_run_hard_suite_reports_every_pass():
    H, W = 96, 128
    passes = {"cube": hw.render_hard_sequence("cube", num_frames=3, H=H, W=W, seed=0)}
    out = hs.run_hard_suite(_tiny_cfg(H, W), passes=passes, device="cpu")
    assert set(out) == {"cube", "mean"} and out["mean"] == out["cube"]
    assert 0.0 <= out["cube"] <= 100.0


def test_generate_vos_masks_equals_jax():
    """test_long_suite.py::test_generate_vos_masks_shapes on the port, with
    the same randomly initialised Flax weights carried over: the masks equal
    JAX's on every pixel."""
    from bundletrack_tpu.models.vos import VOSNet as JVOSNet

    H, W = 96, 128
    seq = hw.render_hard_sequence("cube", num_frames=4, H=H, W=W, seed=3)
    jmodel = JVOSNet(out_dim=32, width=16)
    params = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 48, 64, 3), np.float32))["params"]
    want = jhs.generate_vos_masks(seq, params, jmodel, JSegmentationConfig(), work_hw=(48, 64))
    model = vos.VOSNet(out_dim=32, width=16)
    model.load_state_dict(vos.vos_state_dict_from_flax(_flatten(params)))
    got = hs.generate_vos_masks(seq, model, SegmentationConfig(), work_hw=(48, 64), device="cpu")
    assert got.shape == (4, H, W) and got.dtype == bool
    np.testing.assert_array_equal(got[0], np.asarray(seq.mask[0], bool))
    np.testing.assert_array_equal(got, want)


def _flatten(tree, prefix=""):
    """Flax params -> {"a/b/kernel": numpy array}, the npz's naming."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def test_suites_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = hw.render_hard_sequence("cube", num_frames=2, H=48, W=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hs.evaluate_pass(_tiny_cfg(48, 64), seq, "cube")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_frontend(seq, FrontendConfig(top_k=64))


# ---- a hard pass tracked by both packages ------------------------------------


def phases_from_key(rng_key, cfg):
    """The RANSAC phases the JAX step draws from its state's key:
    (neighbour [3, n_rep], BA pairs [P, 3, n_rep])."""
    M = cfg.shapes.max_matches
    n_rep = -(-cfg.ransac.max_iter // M)
    K = cfg.bundle.max_ba_frames
    _, kn, km = jax.random.split(rng_key, 3)
    draw = lambda k: jax.random.randint(k, (3, n_rep), 0, M, dtype=jnp.int32)  # noqa: E731
    return np.asarray(draw(kn)), np.asarray(jax.vmap(draw)(jax.random.split(km, K * (K - 1) // 2)))


def test_hard_lshape_trajectory_matches_jax():
    """5 frames of the hard lshape pass at 96x128, tracked by both packages,
    the port given the JAX tracker's RANSAC phases: the same statuses, poses
    within 1e-5 m and 1e-3 deg."""
    h, w = 96, 128
    cfg = JTrackerConfig(
        bundle=JBundleConfig(max_ba_frames=4),
        keyframe=JKeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=JFrontendConfig(top_k=128),
        ransac=JRansacConfig(max_iter=256),
        feature_corres=JFeatureCorresConfig(backend="pallas_interpret"),
        shapes=JShapeConfig(max_matches=128, image_h=h, image_w=w),
    )
    seq = hw.render_hard_sequence("lshape", num_frames=5, H=h, W=w, seed=2)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    jtrk = JaxTracker(cfg, h, w)
    ttrk = Tracker(load_config(dataclasses.asdict(cfg)), h, w, device="cpu")
    j_st, t_st = [], []
    for f in range(len(seq.gray)):
        phases = phases_from_key(jtrk.state.rng_key, cfg)
        jo = jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        to = ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases)
        j_st.append(int(jo.status))
        t_st.append(int(to.status))
        pose = to.ob_in_cam.numpy()
        assert np.all(np.isfinite(pose))
        rot, trans = pose_errors(pose, np.asarray(jo.ob_in_cam))
        assert rot < TRAJ_ROT_TOL and trans < TRAJ_TRANS_TOL, (f, rot, trans)
    assert t_st == j_st
