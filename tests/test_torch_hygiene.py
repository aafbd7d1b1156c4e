"""The port stands alone: it imports torch and never jax, flax or the JAX package.

Checked two ways: statically, on every import statement of the port and of
chip_smoke.py; and at run time, in a fresh interpreter that imports the port
and tracks two frames on the CPU.
"""

import ast
import os
import subprocess
import sys

import pytest

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax") or m == "bundletrack_tpu"
             or m.startswith("bundletrack_tpu."))
print("FORBIDDEN", bad)
"""


def test_running_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout, proc.stdout
