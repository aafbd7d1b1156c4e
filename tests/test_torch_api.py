"""The port's public surface against the JAX package's.

Every name a JAX subpackage lists in `__all__` imports from the port's
subpackage of the same name and is the port's own object; the functions
the port added last hold to their JAX counterparts on seeded numpy inputs;
and tests/test_cloud_utils_and_new_apps.py::TestCloudUtils runs again on
the port's cloud utilities.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundletrack_tpu.eval import metrics as j_metrics
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.geometry import robust as j_robust
from bundletrack_tpu.ops import pointcloud as j_pointcloud
from bundletrack_tpu_torch.config import load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.eval import metrics
from bundletrack_tpu_torch.geometry import robust
from bundletrack_tpu_torch.ops import pointcloud
from bundletrack_tpu_torch.ops.pointcloud import statistical_outlier_removal, voxel_downsample
from bundletrack_tpu_torch.tracker import FrameObservation, init_tracker_state, make_track_frame, track_frame
from bundletrack_tpu_torch.tracker.state import state_from_numpy
from test_torch_fleet import COUNT_TOL, SEQ_ROT_TOL, SEQ_TRANS_TOL, H, W, jax_cfg, phases_from_key

SUBPACKAGES = ["data", "eval", "frontend", "geometry", "matching", "models", "ops", "parallel", "ransac",
               "solver", "tracker", "utils"]
# JAX exports the port leaves out on purpose: a stage timer that waits for
# the card at the end of every stage (the port's tracing is
# utils/profiling.py's spans and counters, which never wait)
LEFT_OUT = {"utils": {"StageTimer"}}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_every_jax_export_has_the_ports_counterpart(name):
    jax_pkg = importlib.import_module(f"bundletrack_tpu.{name}")
    port_pkg = importlib.import_module(f"bundletrack_tpu_torch.{name}")
    left_out = LEFT_OUT.get(name, set())
    assert left_out <= set(jax_pkg.__all__) and not any(hasattr(port_pkg, n) for n in left_out)
    exports = [n for n in jax_pkg.__all__ if n not in left_out]
    missing = [n for n in exports if not hasattr(port_pkg, n)]
    assert not missing, f"bundletrack_tpu_torch.{name} lacks {missing}"
    foreign = [n for n in exports if not getattr(port_pkg, n).__module__.startswith("bundletrack_tpu_torch.")]
    assert not foreign, foreign
    assert set(exports) <= set(port_pkg.__all__)


def test_importing_the_subpackages_builds_no_kernel():
    """In a fresh interpreter: importing every subpackage compiles nothing
    and imports neither triton nor jax."""
    code = f"""
import importlib, sys
from bundletrack_tpu_torch.kernels import build
calls = []
for name in ("build", "build_host", "load"):
    setattr(build, name, lambda *a, _name=name, **k: calls.append(_name))
for pkg in {SUBPACKAGES!r}:
    importlib.import_module("bundletrack_tpu_torch." + pkg)
print(calls, sorted({{m.split(".")[0] for m in sys.modules}} & {{"triton", "jax", "jaxlib", "flax"}}))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=repo, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[] []", run.stdout


def test_renamed_exports_are_bound_to_the_ports_functions():
    from bundletrack_tpu_torch import matching, models, ops, tracker
    from bundletrack_tpu_torch.frontend import lfnet
    from bundletrack_tpu_torch.matching import mappoints
    from bundletrack_tpu_torch.tracker import bundler

    assert matching.forget_frame_mappoints is mappoints.forget_frame
    assert models.LFNet is lfnet.LFNet and models.init_lfnet is lfnet.init_lfnet
    assert ops.downsample_nearest is pointcloud.downsample_nearest
    assert tracker.track_frame is bundler.track_frame


def _poses(seed, n, rot=0.2, trans=0.05):
    """n random poses and n truths near them (some beyond 5 deg / 5 cm)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(n):
        g = np.eye(4)
        g[:3, :3] = Rotation.from_rotvec(rng.randn(3)).as_matrix()
        g[:3, 3] = rng.randn(3) * 0.3
        p = np.eye(4)
        p[:3, :3] = Rotation.from_rotvec(rng.randn(3) * rot * rng.rand()).as_matrix() @ g[:3, :3]
        p[:3, 3] = g[:3, 3] + rng.randn(3) * trans * rng.rand()
        gts.append(g)
        preds.append(p)
    return preds, gts


def test_add_auc_and_five_deg_five_cm_match_jax():
    preds, gts = _poses(0, 40)
    model = (np.random.RandomState(1).rand(300, 3) - 0.5) * 0.2
    assert abs(metrics.add_auc(preds, gts, model) - j_metrics.add_auc(preds, gts, model)) <= 1e-9
    assert abs(metrics.add_auc(preds, gts, model, 0.05) - j_metrics.add_auc(preds, gts, model, 0.05)) <= 1e-9
    got, want = metrics.five_deg_five_cm(preds, gts), j_metrics.five_deg_five_cm(preds, gts)
    assert 0 < want < 100 and abs(got - want) <= 1e-9
    assert metrics.five_deg_five_cm([], []) == j_metrics.five_deg_five_cm([], []) == 0.0


def test_huber_weight_matches_jax():
    e_sq = (np.random.RandomState(2).rand(1000).astype(np.float32) * 0.02) ** 2  # both sides of delta
    e_sq[:3] = [0.0, 0.005 ** 2, 1e-30]
    got = robust.huber_weight(torch.from_numpy(e_sq), 0.005).numpy()
    want = np.asarray(j_robust.huber_weight(jnp.asarray(e_sq), 0.005))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert (got < 1).any() and (got == 1).any()


@pytest.mark.parametrize("shape", [(2, 9, 11), (9, 11, 3), (2, 9, 11, 8)], ids=["images", "channel_last", "wide"])
def test_downsample_nearest_matches_jax(shape):
    a = np.random.RandomState(3).rand(*shape).astype(np.float32)
    got = pointcloud.downsample_nearest(torch.from_numpy(a), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pointcloud.downsample_nearest(jnp.asarray(a), 4)))
    assert got.data_ptr() == torch.from_numpy(a).data_ptr() or got.numel() == 0  # a strided view


def test_voxel_downsample_and_outlier_removal_match_jax():
    rng = np.random.RandomState(4)
    cloud = np.concatenate([rng.rand(800, 3) * 0.2, rng.rand(5, 3) * 4.0 - 2.0]).astype(np.float32)
    got, want = voxel_downsample(cloud, 0.015), j_pointcloud.voxel_downsample(cloud, 0.015)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    (pts, keep), (j_pts, j_keep) = statistical_outlier_removal(cloud), j_pointcloud.statistical_outlier_removal(cloud)
    np.testing.assert_array_equal(keep, j_keep)
    np.testing.assert_array_equal(pts, j_pts)
    assert not keep.all()


def test_track_frame_equals_the_built_step():
    """track_frame builds the step for the frame's size and runs it once:
    the same outputs and state as make_track_frame's step from equal states."""
    cfg = load_config(dataclasses.asdict(jax_cfg()))
    seq = render_synthetic_sequence(num_frames=2, H=H, W=W, orbit_deg_per_frame=3.0)
    ip = torch.from_numpy(np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32))
    obs = [FrameObservation(*(torch.from_numpy(np.asarray(a)) for a in (seq.gray[f], seq.depth[f], seq.mask[f],
                                                                       seq.K)))
           for f in range(2)]
    step = make_track_frame(cfg, H, W)
    state, _ = step(init_tracker_state(cfg, H, W, "cpu"), obs[0], ip)
    twin = torch.Generator()
    twin.set_state(state.rng.get_state())
    got_state, got = track_frame(state, obs[1], ip, cfg)
    want_state, want = step(state._replace(rng=twin), obs[1], ip)
    assert int(got.status) == 0 and got_state.frame_count == want_state.frame_count == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got_state.kf_pose, want_state.kf_pose)


def test_track_frame_matches_jax():
    """The port's track_frame against the JAX package's on a first frame
    from a fresh state and a tracked frame from JAX's state after it, with
    the RANSAC phases JAX draws from that state's key."""
    from bundletrack_tpu.tracker import init_tracker_state as j_init_tracker_state
    from bundletrack_tpu.tracker import track_frame as j_track_frame
    from bundletrack_tpu.tracker.state import FrameObservation as JaxObservation

    seq = render_synthetic_sequence(num_frames=2, H=H, W=W, orbit_deg_per_frame=3.0)
    ip = np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32)
    frames = [(seq.gray[f], seq.depth[f], seq.mask[f], seq.K) for f in range(2)]
    j_state = j_init_tracker_state(jax_cfg(), H, W)
    j_states, j_outs = [j_state], []
    for f in range(2):
        j_state, j_out = j_track_frame(j_state, JaxObservation(*map(jnp.asarray, frames[f])), jnp.asarray(ip),
                                       jax_cfg())
        j_states.append(j_state)
        j_outs.append(j_out)
    cfg = load_config(dataclasses.asdict(jax_cfg()))
    for f in range(2):
        state = state_from_numpy(j_states[f]._asdict(), "cpu")
        phases = tuple(torch.from_numpy(np.array(p)) for p in phases_from_key(j_states[f].rng_key, jax_cfg()))
        obs = FrameObservation(*(torch.from_numpy(np.asarray(a)) for a in frames[f]))
        st, out = track_frame(state, obs, torch.from_numpy(ip), cfg, phases)
        want = j_outs[f]
        assert int(out.status) == int(want.status) == 0 and st.frame_count == int(j_states[f + 1].frame_count)
        rot, trans = pose_errors(out.ob_in_cam.numpy(), np.asarray(want.ob_in_cam))
        assert rot < SEQ_ROT_TOL and trans < SEQ_TRANS_TOL, (f, rot, trans)
        assert abs(int(out.num_matches) - int(want.num_matches)) <= COUNT_TOL
        assert abs(int(out.num_ba_edges) - int(want.num_ba_edges)) <= COUNT_TOL
    assert int(j_outs[1].num_matches) > 0


class TestCloudUtils:
    """tests/test_cloud_utils_and_new_apps.py::TestCloudUtils on the port."""

    def test_voxel_downsample_centroids(self):
        rng = np.random.RandomState(0)
        c1 = rng.rand(50, 3) * 0.001
        c2 = rng.rand(60, 3) * 0.001 + 1.0
        out = voxel_downsample(np.concatenate([c1, c2]), voxel_size=0.015)
        assert out.shape == (2, 3)
        got = out[np.argsort(out[:, 0])]
        np.testing.assert_allclose(got[0], c1.mean(0), atol=1e-6)
        np.testing.assert_allclose(got[1], c2.mean(0), atol=1e-6)

    def test_voxel_downsample_reduces_and_preserves_extent(self):
        rng = np.random.RandomState(1)
        pts = rng.rand(5000, 3).astype(np.float32) * 0.2
        out = voxel_downsample(pts, 0.015)
        assert 0 < len(out) < len(pts)
        assert np.all(out.min(0) >= pts.min(0) - 0.015)
        assert np.all(out.max(0) <= pts.max(0) + 0.015)

    def test_voxel_downsample_empty(self):
        assert voxel_downsample(np.zeros((0, 3)), 0.01).shape[0] == 0

    def test_outlier_removal_drops_far_points(self):
        rng = np.random.RandomState(0)
        cloud = rng.rand(200, 3).astype(np.float32) * 0.1
        outliers = np.array([[5.0, 5.0, 5.0], [-4.0, 2.0, 9.0]], np.float32)
        _, keep = statistical_outlier_removal(np.concatenate([cloud, outliers]), num_neighbors=30, std_mul=3.0)
        assert not keep[-1] and not keep[-2]
        assert keep[:200].mean() > 0.95

    def test_outlier_removal_tiny_cloud_noop(self):
        pts = np.random.RandomState(0).rand(10, 3).astype(np.float32)
        filtered, keep = statistical_outlier_removal(pts, num_neighbors=30)
        assert keep.all() and len(filtered) == 10
