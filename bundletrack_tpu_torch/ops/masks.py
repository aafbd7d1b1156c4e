"""Segmentation-mask utilities: dilation, ROI, component and hull fills.

Counterpart of bundletrack_tpu/ops/masks.py (reference:
Frame::segmentationByMaskFile, src/Frame.cpp:236-319 — reads the VOS mask,
on the NOCS path keeps the largest connected component and fills its convex
hull (OpenCV connectedComponents + convexHull + fillConvexPoly,
src/Frame.cpp:262-312), then always dilates with a 5x5 rect kernel
(313-315)).  Every op runs on the mask's device with no host read.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def dilate_mask(mask: torch.Tensor, iterations: int = 1, ksize: int = 5) -> torch.Tensor:
    """Binary dilation of [..., H, W] masks with a ksize x ksize rect element
    (non-wrapping edges; reference cv::dilate with MORPH_RECT {5,5}).  Max
    pooling pads with -inf, like the JAX package's reduce_window."""
    H, W = mask.shape[-2], mask.shape[-1]
    m = mask.to(torch.float32).reshape(-1, 1, H, W)
    r = ksize // 2
    for _ in range(iterations):
        m = F.max_pool2d(m, (ksize, 1), stride=1, padding=(r, 0))
        m = F.max_pool2d(m, (1, ksize), stride=1, padding=(0, r))
    return m.reshape(mask.shape) > 0


def mask_roi(mask: torch.Tensor):
    """Bounding box (umin, umax, vmin, vmax) of a mask plus `nonempty`; the
    full image when the mask is empty."""
    H, W = mask.shape[-2], mask.shape[-1]
    any_col = torch.any(mask, dim=-2)
    any_row = torch.any(mask, dim=-1)
    u_idx = torch.arange(W, dtype=torch.int32, device=mask.device)
    v_idx = torch.arange(H, dtype=torch.int32, device=mask.device)
    nonempty = torch.any(mask)
    umin = torch.where(nonempty, torch.min(torch.where(any_col, u_idx, 1 << 30)), 0)
    umax = torch.where(nonempty, torch.max(torch.where(any_col, u_idx, -1)), W - 1)
    vmin = torch.where(nonempty, torch.min(torch.where(any_row, v_idx, 1 << 30)), 0)
    vmax = torch.where(nonempty, torch.max(torch.where(any_row, v_idx, -1)), H - 1)
    return umin, umax, vmin, vmax, nonempty


def _segmented_run_min(lab: torch.Tensor, mask: torch.Tensor, axis: int, big: int) -> torch.Tensor:
    """Min label over each contiguous run of mask pixels along `axis`; `big`
    off the mask.

    The JAX package scans forwards and backwards with a resetting min
    (jax.lax.associative_scan).  Here every run gets an id, the cumulative
    sum of run starts in row-major order, and one scatter_reduce("amin")
    takes each run's minimum; off-mask pixels go to a spare bin 0.  Integer
    minima are exact, so the labels are identical."""
    m = mask.movedim(axis, -1)
    v = torch.where(m, lab.movedim(axis, -1), big)
    prev = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], dim=-1)
    run = torch.cumsum((m & ~prev).reshape(-1), 0).reshape(m.shape)  # 1-based on the mask
    ids = torch.where(m, run, 0)
    run_min = torch.full((m.numel() + 1,), big, dtype=lab.dtype, device=lab.device)
    run_min.scatter_reduce_(0, ids.reshape(-1), v.reshape(-1), "amin")
    return torch.where(m, run_min[ids], big).movedim(-1, axis)


def largest_component_fill(mask: torch.Tensor, num_iters: int = 16) -> torch.Tensor:
    """Largest 4-connected component of a binary mask [H, W].

    The reference's NOCS path keeps the largest CC (src/Frame.cpp:262-300,
    OpenCV connectedComponents).  Each round propagates the minimum pixel
    index across whole horizontal, then vertical runs, so a round resolves
    one bend of a component's geodesic: num_iters=16 is exact for anything
    but a 16-turn spiral, whatever the component's size.  Ties in size go
    to the component with the smallest pixel index."""
    H, W = mask.shape[-2], mask.shape[-1]
    idx = torch.arange(H * W, dtype=torch.int64, device=mask.device).reshape(H, W)
    big = H * W + 1
    labels = torch.where(mask, idx, big)
    for _ in range(num_iters):
        labels = _segmented_run_min(labels, mask, -1, big)
        labels = _segmented_run_min(labels, mask, -2, big)
    counts = torch.zeros(big, dtype=torch.int64, device=mask.device)  # bin `big` (off the mask) left out
    on = labels < big
    counts.index_add_(0, torch.where(on, labels, 0).reshape(-1), on.reshape(-1).to(torch.int64))
    return labels == torch.argmax(counts)


@functools.lru_cache(maxsize=8)
def _hull_directions(num_dirs: int, device: torch.device):
    """(cos, sin) of the hull's directions k * 2pi / num_dirs as f32 host
    constants: the f32 angle, its cosine and sine in f64, rounded to f32.
    XLA's f32 sine and cosine differ from these by an ulp in a few
    directions (1 of 64 at the default count)."""
    ang = np.arange(num_dirs, dtype=np.float32) * np.float32(2.0 * math.pi / num_dirs)
    cs = np.stack([np.cos(ang.astype(np.float64)), np.sin(ang.astype(np.float64))]).astype(np.float32)
    return torch.from_numpy(cs).to(device).unbind(0)


def convex_hull_fill(mask: torch.Tensor, num_dirs: int = 64) -> torch.Tensor:
    """Filled convex hull of a binary mask [H, W] (outer approximation).

    Reference: cv::convexHull + cv::fillConvexPoly over the largest-CC
    pixels (src/Frame.cpp:293-307).  The hull is the intersection of the
    half-planes {p : <p, d_k> <= sup_k} over num_dirs directions d_k; the
    support values need only each row's first and last mask column, and
    each half-plane bounds each row to a column interval, so the fill is a
    per-row interval intersection.  With 64 directions the circumscribed
    polygon lies within ~R * pi^2 / (2 * 64^2) < 0.5 px of the exact hull
    for R ~ 400 px.  f32, in the JAX package's order of operations."""
    H, W = mask.shape[-2], mask.shape[-1]
    dev = mask.device
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    big = 1e9
    any_row = torch.any(mask, dim=-1)  # [H]
    wmin = torch.amin(torch.where(mask, cols[None, :], big), dim=-1)
    wmax = torch.amax(torch.where(mask, cols[None, :], -big), dim=-1)
    # candidates: each row's extreme points (the support in any direction is
    # attained at a row extreme: for a fixed row, w * cx is monotone in w)
    cw = torch.cat([wmin, wmax])  # [2H]
    ch = torch.cat([rows, rows])
    cvalid = torch.cat([any_row, any_row])
    cx, cy = _hull_directions(num_dirs, dev)  # [K]
    s = cw[:, None] * cx[None, :] + ch[:, None] * cy[None, :]  # [2H, K]
    sup = torch.amax(torch.where(cvalid[:, None], s, -big), dim=0)  # [K]
    # half-plane k restricted to row h: w * cx_k <= thr[h, k]
    eps = 0.5  # sub-pixel slack so boundary pixels stay inside
    thr = sup[None, :] - rows[:, None] * cy[None, :] + eps  # [H, K]
    tol = 1e-6
    pos = cx > tol
    neg = cx < -tol
    zer = ~(pos | neg)
    bound = thr / torch.where(zer, torch.ones_like(cx), cx)[None, :]
    ub = torch.amin(torch.where(pos[None, :], bound, big), dim=-1)  # [H]
    lb = torch.amax(torch.where(neg[None, :], bound, -big), dim=-1)
    rowok = torch.all(torch.where(zer[None, :], thr >= 0.0, True), dim=-1)
    filled = (cols[None, :] >= lb[:, None]) & (cols[None, :] <= ub[:, None]) & rowok[:, None]
    return filled & torch.any(mask)


def preprocess_mask(mask: torch.Tensor, seg_cfg) -> torch.Tensor:
    """The reference mask chain (Frame::segmentationByMaskFile postprocess):
    on the NOCS path (seg_cfg.nocs_mask_fill) the largest component, then
    its convex hull; then always exactly one 5x5 dilate
    (src/Frame.cpp:313-315).  The reference parses `seg_dilation_iter` but
    never reads it, and neither does the port.  Masks [..., H, W]: the
    fills run per mask, the dilation on all at once."""
    if seg_cfg.nocs_mask_fill:
        H, W = mask.shape[-2], mask.shape[-1]
        filled = [convex_hull_fill(largest_component_fill(m)) for m in mask.reshape(-1, H, W)]
        mask = torch.stack(filled).reshape(mask.shape)
    return dilate_mask(mask, iterations=1, ksize=5)
