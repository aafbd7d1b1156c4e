"""bundletrack_tpu_torch — the tracker in PyTorch, with hand-written CUDA kernels.

The port of `bundletrack_tpu` to PyTorch on an NVIDIA H100.  The layout
mirrors the JAX package module for module (geometry, ops, frontend, matching,
ransac, solver, tracker, data), plus `kernels/` (the counterpart of
`pallas_kernels/`) and `csrc/` (the CUDA sources those kernels build from).

Entry points run on the card unless the caller passes `device="cpu"`.
"""

import torch

# RANSAC scoring expands |R pa + t - pb|^2 into a matmul whose terms (~1 m^2)
# cancel down to the 1e-4 m^2 inlier threshold, and the pose solver's normal
# equations cancel the same way; the JAX reference runs both at
# Precision.HIGHEST.  TF32 keeps 10 mantissa bits and would swamp the
# threshold, so matmuls and convolutions stay in full f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from bundletrack_tpu_torch.config import TrackerConfig, load_config  # noqa: E402

__version__ = "0.1.0"

__all__ = ["TrackerConfig", "load_config", "__version__"]
