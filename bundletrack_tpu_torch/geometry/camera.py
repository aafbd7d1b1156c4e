"""Pinhole camera ops (reference: src/cuda/CUDACameraUtil.h)."""

from __future__ import annotations

import torch


def scale_intrinsics(K: torch.Tensor, scale: float) -> torch.Tensor:
    """Rescale a 3x3 intrinsic matrix for a `scale`-resampled image, with the
    (x+0.5)*s - 0.5 principal-point rule (reference CUDACache.cpp:20-25)."""
    out = torch.zeros_like(K)
    out[..., 0, 0] = K[..., 0, 0] * scale
    out[..., 1, 1] = K[..., 1, 1] * scale
    out[..., 0, 2] = (K[..., 0, 2] + 0.5) * scale - 0.5
    out[..., 1, 2] = (K[..., 1, 2] + 0.5) * scale - 0.5
    out[..., 2, 2].fill_(1.0)
    return out


def unproject(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth maps [..., H, W] with intrinsics [..., 3, 3] -> camera-space
    points [..., H, W, 3] (zero depth gives zero-depth points; callers carry
    a validity mask)."""
    H, W = depth.shape[-2], depth.shape[-1]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)
