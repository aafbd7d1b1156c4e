"""Depth-map preprocessing: erosion and depth-aware bilateral filtering.

Counterpart of bundletrack_tpu/ops/depth.py (reference:
src/cuda/CUDAImageUtil.cu erodeDepthMap / gaussFilterDepthMap, called from
src/Frame.cpp processDepth).  Both filters are written as sums over shifted
images, in the same order as the JAX package.
"""

from __future__ import annotations

import torch

from bundletrack_tpu_torch.config import DepthProcessingConfig
from bundletrack_tpu_torch.ops.numerics import exp_f32


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """Shift [H, W] by (dy, dx) with constant fill (no wraparound)."""
    out = torch.roll(img, shifts=(dy, dx), dims=(-2, -1))
    H, W = img.shape[-2], img.shape[-1]
    v = torch.arange(H, device=img.device)[:, None]
    u = torch.arange(W, device=img.device)[None, :]
    ok = ((v - dy >= 0) & (v - dy < H)) & ((u - dx >= 0) & (u - dx < W))
    return torch.where(ok, out, torch.full_like(out, fill))


def erode_depth(depth, radius: int = 1, diff: float = 0.001, ratio: float = 0.8):
    """Zero depth pixels whose neighborhood disagrees: a pixel survives only
    if at most `ratio` of its window is invalid or differs by `diff` or more."""
    valid = depth > 0.1
    agree = torch.zeros_like(depth)
    total = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            close = torch.abs(nb - depth) < diff
            agree = agree + ((nb > 0.1) & close).to(depth.dtype)
            total += 1
    frac_bad = 1.0 - agree / float(total)
    keep = valid & (frac_bad <= ratio)
    return torch.where(keep, depth, torch.zeros_like(depth))


def bilateral_filter_depth(
    depth, radius: int = 2, sigma_d: float = 2.0, sigma_r: float = 100000.0
):
    """Spatial x range Gaussian over valid neighbors; invalid centers stay invalid."""
    valid = depth > 0.1
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    inv_2sd = 0.5 / (sigma_d * sigma_d)
    inv_2sr = 0.5 / (sigma_r * sigma_r)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shifted(depth, dy, dx)
            w_spatial = exp_f32(-(dy * dy + dx * dx) * inv_2sd)
            d = nb - depth
            w = w_spatial * torch.exp(-(d * d) * inv_2sr) * (nb > 0.1).to(depth.dtype)
            acc = acc + w * nb
            wacc = wacc + w
    out = acc / torch.clamp(wacc, min=1e-8)
    return torch.where(valid & (wacc > 1e-8), out, torch.zeros_like(out))


def process_depth(depth: torch.Tensor, cfg: DepthProcessingConfig) -> torch.Tensor:
    """Clamp to [znear, zfar] -> erode -> two bilateral passes
    (reference Frame::processDepth, src/Frame.cpp:166-168)."""
    depth = torch.where(
        (depth < cfg.znear) | (depth > cfg.zfar), torch.zeros_like(depth), depth
    )
    e = cfg.erode
    depth = erode_depth(depth, e.radius, e.diff, e.ratio)
    b = cfg.bilateral_filter
    depth = bilateral_filter_depth(depth, b.radius, b.sigma_d, b.sigma_r)
    return bilateral_filter_depth(depth, b.radius, b.sigma_d, b.sigma_r)
