"""Pinhole camera ops: intrinsics scaling, unproject, project and
bilinear sampling (reference: src/cuda/CUDACameraUtil.h; the MINF-aware
interpolation of src/cuda/Solver/ICPUtil.h)."""

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


def project(pts: torch.Tensor, K: torch.Tensor):
    """Camera-space points [..., 3] -> pixel coords (u, v) and depth z, each
    [...]; |z| < 1e-8 divides by 1e-8.  K's entries broadcast against the
    points' leading axes, as in the JAX package."""
    z = pts[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = pts[..., 0] / safe_z * K[..., 0, 0] + K[..., 0, 2]
    v = pts[..., 1] / safe_z * K[..., 1, 1] + K[..., 1, 2]
    return u, v, z


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, valid=None):
    """Sample img [H, W, C] (or [H, W]) bilinearly at float pixel coords.

    Returns (values, weight) where weight in [0, 1] is the share of the four
    taps that lie inside the image and, when `valid` [H, W] is given, on a
    valid pixel; the values are renormalised by it (a weight of 0 gives 0)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W = img.shape[0], img.shape[1]
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    dx = (u - x0)[..., None]
    dy = (v - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = torch.clamp(xi, 0, W - 1)
        yc = torch.clamp(yi, 0, H - 1)
        ok = inb if valid is None else inb & (valid[yc, xc] > 0)
        return img[yc, xc], ok.to(img.dtype)

    v00, m00 = gather(y0i, x0i)
    v01, m01 = gather(y0i, x0i + 1)
    v10, m10 = gather(y0i + 1, x0i)
    v11, m11 = gather(y0i + 1, x0i + 1)
    w00 = (1 - dx) * (1 - dy) * m00[..., None]
    w01 = dx * (1 - dy) * m01[..., None]
    w10 = (1 - dx) * dy * m10[..., None]
    w11 = dx * dy * m11[..., None]
    wsum = w00 + w01 + w10 + w11
    out = (v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11) / torch.clamp(wsum, min=1e-8)
    if squeeze:
        out, wsum = out[..., 0], wsum[..., 0]
    return out, wsum
