"""The port's CLI chain on the CPU: YCBInEOAT directory -> run_tracking ->
poses/<id>.txt -> eval_ycbineoat, with the classical frontend and with
LF-Net on the shipped weights; and the LF-Net tracker against the JAX
tracker frame by frame.

The bars are those of tests/test_e2e_parity.py (ADD-S AUC > 90, ADD AUC >
80) on its reduced configuration.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bundletrack_tpu.config import (
    BundleConfig,
    FeatureCorresConfig,
    FrontendConfig as JaxFrontendConfig,
    KeyframeConfig,
    RansacConfig,
    ShapeConfig,
    TrackerConfig as JaxTrackerConfig,
)
from bundletrack_tpu.data.export import export_ycbineoat_sequence as jax_export
from bundletrack_tpu.data.ycbineoat import YcbineoatLoader as JaxLoader
from bundletrack_tpu.eval import pose_errors
from bundletrack_tpu.frontend.lfnet import load_params_npz as jax_load_params_npz
from bundletrack_tpu.frontend.lfnet import make_lfnet_apply as jax_make_lfnet_apply
from bundletrack_tpu.tracker.driver import Tracker as JaxTracker
from bundletrack_tpu_torch.apps.eval_ycbineoat import evaluate, load_model_points
from bundletrack_tpu_torch.apps.run_tracking import main as run_tracking
from bundletrack_tpu_torch.config import FrontendConfig, TrackerConfig, load_config
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
from bundletrack_tpu_torch.data.ycbineoat import YcbineoatLoader
from bundletrack_tpu_torch.frontend import lfnet
from bundletrack_tpu_torch.frontend.pipeline import extract_frame_features
from bundletrack_tpu_torch.tracker.bundler import make_track_frame
from bundletrack_tpu_torch.tracker.driver import Tracker, track_sequence

torch.set_num_threads(2)

CKPT = "checkpoints/lfnet_params.npz"
H, W = 120, 160
ADDS_AUC_MIN, ADD_AUC_MIN = 90.0, 80.0  # tests/test_e2e_parity.py
# 6-frame LF-Net trajectory against the JAX tracker, f32 frontend (measured
# 1.4e-6 m and 2e-5 deg: f32 summation order only)
TRAJ_TRANS_TOL, TRAJ_ROT_TOL = 1e-4, 0.05  # m, deg
# ... and against the renderer's truth: LF-Net on a 96-px crop of a 120x160
# frame tracks to 1.5 deg and 0.7 mm at worst (both trackers alike)
GT_TRANS_TOL, GT_ROT_TOL = 0.005, 2.0


@pytest.fixture(scope="module")
def seq():
    return render_synthetic_sequence(num_frames=14, H=H, W=W, orbit_deg_per_frame=3.0)


@pytest.fixture(scope="module")
def seq_dir(seq, tmp_path_factory):
    return export_ycbineoat_sequence(seq, str(tmp_path_factory.mktemp("ycbineoat") / "cube"))


def test_export_round_trip_equals_the_jax_loader(seq, seq_dir, tmp_path):
    """The port's export and loader give the JAX loader's arrays, on the
    JAX export of the same sequence."""
    jax_dir = jax_export(seq, str(tmp_path / "jax_cube"))
    for sub in ("rgb", "depth", "masks"):
        for name in sorted(os.listdir(os.path.join(jax_dir, sub)))[:3]:
            with open(os.path.join(jax_dir, sub, name), "rb") as a, open(os.path.join(seq_dir, sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, name)
    ours, theirs = YcbineoatLoader(seq_dir), JaxLoader(jax_dir)
    try:
        assert len(ours) == len(theirs) == 14
        np.testing.assert_array_equal(ours.K, theirs.K)
        np.testing.assert_array_equal(ours.init_pose_in_model, theirs.init_pose_in_model)
        for i in (0, 3, 13):
            a, b = ours[i], theirs[i]
            for field in a._fields:
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
            np.testing.assert_array_equal(ours.gt_pose(i), theirs.gt_pose(i))
    finally:
        ours.close()
    fd = YcbineoatLoader(seq_dir)
    try:
        frame = fd[3]
        valid = seq.depth[3] > 0.1
        assert np.abs(frame.depth - seq.depth[3])[valid].max() < 1e-3  # u16 mm quantization only
    finally:
        fd.close()


def _write_config(path, seq_dir, out_dir, **frontend):
    """The reduced reference-format config of tests/test_e2e_parity.py."""
    with open(path, "w") as f:
        yaml.safe_dump({
            "data_dir": seq_dir,
            "mask_dir": os.path.join(seq_dir, "masks"),
            "debug_dir": out_dir,
            "LOG": 0,
            "bundle": {"num_iter_outter": 7, "max_BA_frames": 8, "dense_src_capacity": 512},
            "keyframe": {"pool_size": 8},
            "frontend": {"top_k": 256, **frontend},
            "ransac": {"max_iter": 512},
            "shapes": {"max_matches": 128},
        }, f)
    return path


@pytest.mark.parametrize("frontend,extra", [("classical", {}), ("lfnet", {"input_size": 96})])
def test_cli_chain_meets_the_pose_bars(seq_dir, tmp_path, frontend, extra):
    out_dir = str(tmp_path / "out")
    cfg = _write_config(str(tmp_path / "config.yml"), seq_dir, out_dir, **extra)
    tracker = run_tracking([cfg, "--frontend", frontend, "--device", "cpu"])
    assert tracker.cfg.frontend.kind == frontend
    pose_dir = os.path.join(out_dir, "poses")
    assert len(os.listdir(pose_dir)) == 14
    res = evaluate(pose_dir, os.path.join(seq_dir, "annotated_poses"),
                   load_model_points(os.path.join(seq_dir, "model", "points.xyz")))
    assert res["missing"] == 0 and res["num_frames"] == 14
    assert res["ADDS_AUC"] > ADDS_AUC_MIN and res["ADD_AUC"] > ADD_AUC_MIN, res


@pytest.mark.parametrize("args,raw", [(["--dataset", "nocs"], {}), ([], {"use_6pack_datalist": True})],
                         ids=["flag", "auto"])
def test_nocs_dataset_raises(tmp_path, args, raw):
    """--dataset nocs, or `auto` on a use_6pack_datalist config, reads the
    directory with the NOCS loader (tests/test_torch_nocs.py runs the
    chain); on an empty directory it raises for want of NOCS frames or of
    the 6-PACK list, where the YCBInEOAT loader would want cam_K.txt."""
    cfg = str(tmp_path / "config.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"data_dir": str(tmp_path), **raw}, f)
    with pytest.raises(FileNotFoundError, match="no frames found|NOCS-REAL275-additional"):
        run_tracking([cfg, "--device", "cpu", *args])


def test_lfnet_without_the_net_raises(seq):
    """The JAX package quietly runs the classical frontend when it gets no
    net; the port refuses."""
    cfg = FrontendConfig(kind="lfnet", input_size=96, top_k=64)
    gray = torch.from_numpy(seq.gray[0])
    mask = torch.from_numpy(seq.mask[0])
    pts = torch.zeros(H, W, 3)
    with pytest.raises(ValueError, match="lfnet_apply"):
        extract_frame_features(gray, mask, pts, pts, mask, cfg)
    tcfg = TrackerConfig(frontend=cfg)
    with pytest.raises(ValueError, match="lfnet_apply"):
        track_sequence(tcfg, render_synthetic_sequence(num_frames=1, H=H, W=W), device="cpu")


def _small_cfg(frontend):
    return TrackerConfig(
        bundle=BundleConfig(max_ba_frames=3, dense_src_capacity=256),
        keyframe=KeyframeConfig(pool_size=4),
        ransac=RansacConfig(max_iter=128),
        shapes=ShapeConfig(max_matches=64, image_h=H, image_w=W),
        frontend=frontend,
    )


def test_descriptor_width_check_is_the_classical_frontends():
    """Classical descriptors are 16x16 patches: 256 wide, nothing else.
    LF-Net's width is frontend.desc_dim."""
    with pytest.raises(ValueError, match="256-d"):
        make_track_frame(_small_cfg(FrontendConfig(kind="classical", desc_dim=128)), H, W)
    fcfg = FrontendConfig(kind="lfnet", input_size=64, top_k=64, desc_dim=128, bf16=False)
    model, params = lfnet.init_lfnet(fcfg, seed=3)
    seq = render_synthetic_sequence(num_frames=2, H=H, W=W)
    poses, _, tracker = track_sequence(_small_cfg(fcfg), seq, lfnet_apply=lfnet.make_lfnet_apply(fcfg, params),
                                       device="cpu")
    assert tracker.state.kf_desc.shape[-1] == 128 and tracker.state.prev_desc.shape == (64, 128)
    assert np.all(np.isfinite(poses))


def phases_from_key(rng_key, cfg):
    """The RANSAC phases the JAX step draws from its state's key, as in
    tests/test_torch_tracker.py."""
    M = cfg.shapes.max_matches
    n_rep = -(-cfg.ransac.max_iter // M)
    K = cfg.bundle.max_ba_frames
    _, kn, km = jax.random.split(rng_key, 3)
    draw = lambda k: jax.random.randint(k, (3, n_rep), 0, M, dtype=jnp.int32)  # noqa: E731
    return np.asarray(draw(kn)), np.asarray(jax.vmap(draw)(jax.random.split(km, K * (K - 1) // 2)))


def _jax_lfnet_cfg():
    return JaxTrackerConfig(
        bundle=BundleConfig(max_ba_frames=4),
        keyframe=KeyframeConfig(pool_size=8, min_rot=5.0),
        frontend=JaxFrontendConfig(kind="lfnet", input_size=96, top_k=128, bf16=False),
        ransac=RansacConfig(max_iter=256),
        feature_corres=FeatureCorresConfig(backend="pallas_interpret"),
        shapes=ShapeConfig(max_matches=128, image_h=H, image_w=W),
    )


def test_lfnet_trajectory_matches_jax():
    """Six frames through both trackers with LF-Net in f32; the port takes
    the RANSAC phases the JAX step draws."""
    jcfg = _jax_lfnet_cfg()
    pcfg = load_config(dataclasses.asdict(jcfg))
    assert pcfg.frontend.kind == "lfnet" and not pcfg.frontend.bf16
    seq = render_synthetic_sequence(num_frames=6, H=H, W=W, orbit_deg_per_frame=4.0)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    _, jparams = jax_load_params_npz(CKPT, jcfg.frontend)
    jtrk = JaxTracker(jcfg, H, W, lfnet_apply=jax_make_lfnet_apply(jcfg.frontend, jparams))
    _, params = lfnet.load_params_npz(CKPT, pcfg.frontend)
    ttrk = Tracker(pcfg, H, W, lfnet_apply=lfnet.make_lfnet_apply(pcfg.frontend, params), device="cpu")
    for f in range(6):
        phases = phases_from_key(jtrk.state.rng_key, jcfg)
        j = jax.tree.map(np.array, jtrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose))
        t = ttrk.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=phases)
        assert int(t.status) == int(j.status) == 0, f
        rot, trans = pose_errors(t.ob_in_cam.numpy(), j.ob_in_cam)
        assert rot < TRAJ_ROT_TOL and trans < TRAJ_TRANS_TOL, (f, rot, trans)
        print(f"frame {f}: port vs JAX {rot:.2e} deg {trans:.2e} m", end="; ")
        rot, trans = pose_errors(t.ob_in_cam.numpy(), seq.ob_in_cam[f])
        print(f"vs truth {rot:.3f} deg {trans * 1e3:.3f} mm")
        assert rot < GT_ROT_TOL and trans < GT_TRANS_TOL, (f, rot, trans)
