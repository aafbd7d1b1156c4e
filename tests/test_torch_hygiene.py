"""The port stands alone: it imports torch and never jax, flax or the JAX package.

Checked two ways: statically, on every import statement of the port and of
chip_smoke.py; and at run time, in a fresh interpreter that imports the port,
tracks two frames on the CPU with each frontend and with a fleet of two
streams, runs the CLI chain, run_vos on two frames, one NOCS frame
through run_tracking --dataset nocs, the hard suite and the frontend
metrics on one tiny hard pass, reads a Paeth-filtered PNG, and trains
LF-Net for two steps (then resumes for a third) and VOS for one; and in
two gloo ranks spawned from a fresh interpreter, which step a fleet
sharded over "stream" and train VOS data-parallel (tests/torch_mesh_ranks.py).
"""

import ast
import os
import subprocess
import sys

import pytest

import torch_mesh_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "bundletrack_tpu_torch")
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax", "bundletrack_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build outputs, not sources
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    # the root of `bundletrack_tpu_torch.x` is `bundletrack_tpu_torch`, so the
    # JAX package's name matches only itself, never the port's prefix
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN_ROOTS)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


_RUN = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from bundletrack_tpu_torch.config import (TrackerConfig, BundleConfig, KeyframeConfig,
    FrontendConfig, RansacConfig, ShapeConfig)
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.tracker.driver import track_sequence
cfg = TrackerConfig(bundle=BundleConfig(max_ba_frames=3), keyframe=KeyframeConfig(pool_size=4),
                    frontend=FrontendConfig(top_k=64), ransac=RansacConfig(max_iter=128),
                    shapes=ShapeConfig(max_matches=64, image_h=60, image_w=80))
seq = render_synthetic_sequence(num_frames=2, H=60, W=80)
poses, statuses, _ = track_sequence(cfg, seq, device="cpu")
assert poses.shape == (2, 4, 4) and np.all(np.isfinite(poses)), poses
from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
fleet, step = init_fleet_state(cfg, 60, 80, 2, device="cpu"), make_fleet_step(cfg, 60, 80)
for f in range(2):
    fleet, out = step(fleet, fleet_observation(*(np.stack([a[f]] * 2) for a in (seq.gray, seq.depth, seq.mask)),
                                               np.stack([seq.K] * 2), "cpu"),
                      torch.from_numpy(np.stack([np.linalg.inv(seq.ob_in_cam[0])] * 2).astype(np.float32)))
assert out.ob_in_cam.shape == (2, 4, 4) and bool(torch.isfinite(out.ob_in_cam).all())
import os, tempfile, yaml
from bundletrack_tpu_torch.apps import eval_ycbineoat, run_tracking
from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence
from bundletrack_tpu_torch.frontend import lfnet
lf = FrontendConfig(kind="lfnet", top_k=64, input_size=32, bf16=False)
_, params = lfnet.load_params_npz("checkpoints/lfnet_params.npz", lf)
poses, _, _ = track_sequence(cfg.replace(frontend=lf), seq, lfnet_apply=lfnet.make_lfnet_apply(lf, params),
                             device="cpu")
assert np.all(np.isfinite(poses)), poses
with tempfile.TemporaryDirectory() as root:
    data = export_ycbineoat_sequence(seq, os.path.join(root, "seq"))
    with open(os.path.join(root, "c.yml"), "w") as f:
        yaml.safe_dump({"data_dir": data, "debug_dir": os.path.join(root, "out"), "frontend": {"top_k": 64},
                        "bundle": {"max_BA_frames": 3}, "keyframe": {"pool_size": 4},
                        "ransac": {"max_iter": 128}, "shapes": {"max_matches": 64}}, f)
    run_tracking.main([os.path.join(root, "c.yml"), "--device", "cpu"])
    eval_ycbineoat.evaluate(os.path.join(root, "out", "poses"), os.path.join(data, "annotated_poses"),
                            eval_ycbineoat.load_model_points(os.path.join(data, "model", "points.xyz")))
    from bundletrack_tpu_torch.apps import eval_nocs, run_vos
    from bundletrack_tpu_torch.data.export import export_nocs_sequence
    small = render_synthetic_sequence(num_frames=2, H=32, W=32)
    vdir = export_ycbineoat_sequence(small, os.path.join(root, "small"))
    run_vos.main(["--img_dir", os.path.join(vdir, "rgb"), "--init_mask_file", os.path.join(vdir, "masks", "00000.png"),
                  "--mask_save_dir", os.path.join(root, "vos"), "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(root, "vos"))) == ["00000.png", "00001.png"]
    scene, mdir, gdir, model = export_nocs_sequence(seq, os.path.join(root, "nocs"))
    with open(os.path.join(root, "n.yml"), "w") as f:
        yaml.safe_dump({"data_dir": scene, "mask_dir": mdir, "model_name": "camera_mini", "use_6pack_datalist": False,
                        "debug_dir": os.path.join(root, "nout"), "frontend": {"top_k": 64},
                        "bundle": {"max_BA_frames": 3}, "keyframe": {"pool_size": 4},
                        "ransac": {"max_iter": 128}, "shapes": {"max_matches": 64}}, f)
    run_tracking.main([os.path.join(root, "n.yml"), "--dataset", "nocs", "--max-frames", "1", "--device", "cpu"])
    eval_nocs.main(["--pred_dir", os.path.join(root, "nout", "poses"), "--gt_dir", gdir, "--model", model,
                    "--class_name", "camera"])
from bundletrack_tpu_torch.data import render_hard_sequence
from bundletrack_tpu_torch.eval import evaluate_frontend
from bundletrack_tpu_torch.eval.hard_suite import run_hard_suite
hard = render_hard_sequence("cube", num_frames=2, H=60, W=80)
out = run_hard_suite(cfg, passes={"cube": hard}, device="cpu")
assert set(out) == {"cube", "mean"}, out
evaluate_frontend(hard, cfg.frontend, device="cpu")
from bundletrack_tpu_torch.data.native_io import read_png, write_png
with tempfile.TemporaryDirectory() as root:
    write_png(os.path.join(root, "x.png"), (hard.gray[0] * 255).astype(np.uint8), filter_type=4)
    assert np.array_equal(read_png(os.path.join(root, "x.png")), (hard.gray[0] * 255).astype(np.uint8))
from bundletrack_tpu_torch.apps import train_lfnet, train_vos
with tempfile.TemporaryDirectory() as root:
    small = ["--size", "32", "--batch", "2", "--num-seqs", "1", "--log-every", "1", "--device", "cpu"]
    train_lfnet.main(["--steps", "2", "--top-k", "16", "--desc-dim", "32", "--net-channel", "8", "--num-scales", "3",
                      "--desc-channel", "16", "--sm-ksize", "5", "--ckpt-dir", os.path.join(root, "lf"),
                      "--ckpt-every", "1"] + small)
    train_lfnet.main(["--steps", "3", "--resume", "--top-k", "16", "--desc-dim", "32", "--net-channel", "8",
                      "--num-scales", "3", "--desc-channel", "16", "--sm-ksize", "5", "--ckpt-dir",
                      os.path.join(root, "lf")] + small)
    train_vos.main(["--steps", "1", "--clip-len", "3", "--width", "8", "--rollout",
                    "--ckpt-dir", os.path.join(root, "vos")] + small)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax") or m == "bundletrack_tpu"
             or m.startswith("bundletrack_tpu."))
print("FORBIDDEN", bad)
"""


def test_scan_covers_every_module_of_the_slices():
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for module in ("frontend/lfnet.py", "frontend/detector_ops.py", "ops/resize.py", "utils/params_io.py",
                   "data/native_io.py", "data/ycbineoat.py", "data/export.py", "apps/run_tracking.py",
                   "apps/eval_ycbineoat.py", "tracker/bundler.py", "kernels/matching.py",
                   "utils/flax_layers.py", "models/vos.py", "eval/vos_eval.py", "apps/run_vos.py", "ops/masks.py",
                   "data/nocs.py", "eval/nocs_protocol.py", "apps/eval_nocs.py", "vos_bench.py",
                   "parallel/fleet.py", "fleet_bench.py", "data/hard_world.py", "data/pairs.py",
                   "eval/hard_suite.py", "eval/frontend_eval.py", "models/lfnet_train.py", "models/vos_train.py",
                   "models/optim.py", "apps/train_lfnet.py", "apps/train_vos.py", "utils/checkpoint.py",
                   "utils/profiling.py", "utils/viz.py", "frontend/port_tf1.py",
                   "parallel/distributed.py", "parallel/pair_sharded.py", "ops/collectives.py"):
        assert os.path.join("bundletrack_tpu_torch", module) in scanned, module


def test_running_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout


_SPAWN = r"""
import sys
sys.path.insert(0, "tests")
import torch_mesh_ranks as ranks
from bundletrack_tpu_torch.parallel.distributed import spawn_ranks
spawn_ranks(ranks.run_jobs, 2, (sys.argv[1], [("hygiene_rank", ())]), backend="gloo", device="cpu",
            timeout_s=120.0, join_s=240.0)
"""


def test_a_spawned_rank_loads_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SPAWN, str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for r in ranks.load(str(tmp_path), "hygiene", 2, job="hygiene_rank"):
        assert r["finite"] and r["forbidden_modules"] == [], r
