"""Segmentation-mask utilities: dilation and ROI.

Counterpart of bundletrack_tpu/ops/masks.py (reference:
Frame::segmentationByMaskFile, src/Frame.cpp:236-319).  The NOCS-only
largest-component and convex-hull fills are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_mask(mask: torch.Tensor, iterations: int = 1, ksize: int = 5) -> torch.Tensor:
    """Binary dilation with a ksize x ksize rect element (non-wrapping edges;
    reference cv::dilate with MORPH_RECT {5,5}).  Max pooling pads with -inf,
    like the JAX package's reduce_window."""
    m = mask.to(torch.float32)[None, None]
    r = ksize // 2
    for _ in range(iterations):
        m = F.max_pool2d(m, (ksize, 1), stride=1, padding=(r, 0))
        m = F.max_pool2d(m, (1, ksize), stride=1, padding=(0, r))
    return m[0, 0] > 0


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


def preprocess_mask(mask: torch.Tensor, seg_cfg) -> torch.Tensor:
    """The reference mask chain: one 5x5 dilate (src/Frame.cpp:313-315)."""
    if seg_cfg.nocs_mask_fill:
        raise NotImplementedError(
            "segmentation.nocs_mask_fill (largest component + convex hull) "
            "is not ported yet"
        )
    return dilate_mask(mask, iterations=1, ksize=5)
