"""Intensity derivatives for the photometric dense term.

Counterpart of bundletrack_tpu/ops/intensity.py (reference:
src/cuda/CUDAImageUtil.cu, the intensity derivative kernels that feed the
dense colour residual of BuildDenseSystem_Kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def intensity_gradients(intensity: torch.Tensor, valid: torch.Tensor):
    """Central-difference gradients (d/du, d/dv) of [..., H, W] intensity,
    zero on the border.  A pixel with an invalid 4-neighbour (wrapping at
    the border, as the JAX package's roll does) gets zero gradient: the
    reference's derivative kernels skip MINF neighbours."""
    gx = F.pad(0.5 * (intensity[..., :, 2:] - intensity[..., :, :-2]), (1, 1))
    gy = F.pad(0.5 * (intensity[..., 2:, :] - intensity[..., :-2, :]), (0, 0, 1, 1))
    v = valid.to(intensity.dtype)
    ok = torch.roll(v, 1, dims=-1) * torch.roll(v, -1, dims=-1)
    ok = ok * torch.roll(v, 1, dims=-2) * torch.roll(v, -1, dims=-2)
    return gx * ok, gy * ok
