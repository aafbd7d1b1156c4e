"""Detector post-processing ops of the LF-Net frontend, channels-first.

Counterpart of bundletrack_tpu/frontend/detector_ops.py (reference:
lf-net-release/det_tools.py — soft_nms_3d, instance_normalization,
non_max_suppression, make_top_k_sparse_tensor, soft_max_and_argmax_1d,
soft_argmax_2d; spatial_transformer.py transformer_crop).  The JAX functions
take [B, H, W, C]; these take [B, C, H, W] and otherwise compute the same
thing in the same order, with no host read.

XLA flushes denormal f32 results to zero on every backend; torch keeps them.
The soft NMS divides exponentials by a sum that can be as small as 1e-6, so
an exponential that underflowed to a denormal would come back as a normal
score: a keypoint that XLA scores 0 (invalid) would be valid here.  So the
exponentials and products that can underflow are flushed explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bundletrack_tpu_torch.kernels.norm_sums import xla_order_sums
from bundletrack_tpu_torch.ops.numerics import clip, flush_denormals, reciprocal_f32
from bundletrack_tpu_torch.ops.topk import topk_stable


def instance_norm(x: torch.Tensor, dims=(2, 3), eps: float = 1e-3, xla_order: bool = False) -> torch.Tensor:
    """Per-sample, per-channel normalization with the population variance.
    With `xla_order` (the bf16 LF-Net's photo and score maps, inference
    only) the mean and the variance are summed as jax.jit sums them on the CPU
    (kernels/norm_sums.py): mean = sum * (1/n), variance = the sum of
    (x - mean)^2 times 1/n."""
    if xla_order:
        if tuple(dims) != (2, 3):
            raise ValueError(f"instance_norm: XLA's order is over dims (2, 3), not {dims}")
        B, C, H, W = x.shape
        inv = reciprocal_f32(H * W)
        s, _ = xla_order_sums(x, per_channel=True)
        mu = s * inv
        _, s2 = xla_order_sums(x, per_channel=True, shift=mu)
        mu, var = mu.view(B, C, 1, 1), (s2 * inv).view(B, C, 1, 1)
        return (x - mu) / torch.sqrt(var + eps)
    mu = torch.mean(x, dim=dims, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=dims, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _window_max(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize max, "SAME" with -inf padding (XLA reduce_window)."""
    r = ksize // 2
    x = F.max_pool2d(x, (ksize, 1), stride=1, padding=(r, 0))
    return F.max_pool2d(x, (1, ksize), stride=1, padding=(0, r))


def _window_sum(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize sum, "SAME" with zero padding: a separable box sum."""
    r = ksize // 2
    kw = dict(stride=1, count_include_pad=True, divisor_override=1)
    x = F.avg_pool2d(x, (ksize, 1), padding=(r, 0), **kw)
    return F.avg_pool2d(x, (1, ksize), padding=(0, r), **kw)


def _check_odd(ksize: int) -> None:
    # XLA's SAME pads (k-1)//2 before and k//2 after: symmetric only for odd k
    if ksize % 2 != 1:
        raise ValueError(f"window size {ksize} must be odd")


def soft_nms_3d(scale_logits: torch.Tensor, ksize: int, com_strength: float = 1.0):
    """Softmax-style NMS over (scale, y, x) windows of [B, S, H, W]: the
    window spans all scales and ksize x ksize pixels."""
    _check_odd(ksize)
    max_all_scales = torch.amax(scale_logits, dim=1, keepdim=True)
    max_maps = _window_max(max_all_scales, ksize)
    exp_maps = flush_denormals(torch.exp(com_strength * (scale_logits - max_maps)))
    sum_exp_scales = torch.sum(exp_maps, dim=1, keepdim=True)
    sum_ex = _window_sum(sum_exp_scales, ksize)
    return exp_maps / (sum_ex + 1e-6)


def soft_max_and_argmax_1d(x: torch.Tensor, index_values: torch.Tensor, dim: int = 1,
                           com1: float = 250.0, com2: float = 250.0):
    """Differentiable max and argmax along `dim` (reference det_tools:1707)."""
    mx = torch.amax(x, dim=dim, keepdim=True)
    e1 = flush_denormals(torch.exp(com1 * (x - mx)))
    p1 = e1 / (torch.sum(e1, dim=dim, keepdim=True) + 1e-8)
    e2 = flush_denormals(torch.exp(com2 * (x - mx)))
    p2 = e2 / (torch.sum(e2, dim=dim, keepdim=True) + 1e-8)
    soft_max = torch.sum(flush_denormals(x * p1), dim=dim)
    shape = [1] * x.ndim
    shape[dim] = -1
    soft_arg = torch.sum(flush_denormals(index_values.reshape(shape) * p2), dim=dim)
    return soft_max, soft_arg


def non_max_suppression_mask(x: torch.Tensor, thresh: float, ksize: int) -> torch.Tensor:
    """Local-max mask over a ksize window of [B, 1, H, W]; `>=`, so every
    pixel of a plateau passes."""
    _check_odd(ksize)
    work = torch.where(x < thresh, torch.zeros_like(x), x)
    return work >= _window_max(work, ksize)


def end_of_frame_mask(H: int, W: int, radius: int, device=None, dtype=torch.float32):
    """[1, 1, H, W]: 1 at least `radius` pixels inside the border, else 0."""
    v = torch.arange(H, device=device)[:, None]
    u = torch.arange(W, device=device)[None, :]
    ok = (v >= radius) & (v < H - radius) & (u >= radius) & (u < W - radius)
    return ok.to(dtype)[None, None]


def top_k_keypoints(score_map: torch.Tensor, k: int):
    """[B, 1, H, W] -> (kpts [B, k, 2] (x, y) float, scores [B, k], valid).

    Bucketed as in the JAX package: each 4x4 cell keeps its best pixel (the
    first one on a tie) and the top k runs over the cell winners, lower
    index first on ties."""
    B, H, W = score_map.shape[0], score_map.shape[2], score_map.shape[3]
    CELL = 4
    if H % CELL or W % CELL or (H // CELL) * (W // CELL) < k:
        vals, idx = topk_stable(score_map.reshape(B, H * W), k)
        x = (idx % W).to(torch.float32)
        y = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
        return torch.stack([x, y], dim=-1), vals, vals > 0.0
    hc, wc = H // CELL, W // CELL
    cells = score_map[:, 0].reshape(B, hc, CELL, wc, CELL)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(B, hc * wc, CELL * CELL)
    cell_best = torch.amax(cells, dim=-1)
    cell_arg = torch.argmax(cells, dim=-1)
    vals, cidx = topk_stable(cell_best, k)
    sub = torch.gather(cell_arg, 1, cidx)
    x = ((cidx % wc) * CELL + sub % CELL).to(torch.float32)
    y = (torch.div(cidx, wc, rounding_mode="floor") * CELL
         + torch.div(sub, CELL, rounding_mode="floor")).to(torch.float32)
    return torch.stack([x, y], dim=-1), vals, vals > 0.0


def soft_argmax_2d(patches: torch.Tensor, do_softmax: bool = True, com: float = 10.0):
    """[N, 1, P, P] -> [N, 2] soft-argmax offsets in [-1, 1] patch coords."""
    P = patches.shape[-1]
    xs = torch.linspace(-1.0, 1.0, P, device=patches.device)
    m = patches[:, 0]
    if do_softmax:
        mx = torch.amax(m, dim=(1, 2), keepdim=True)
        e = flush_denormals(torch.exp(com * (m - mx)))
        m = e / (torch.sum(e, dim=(1, 2), keepdim=True) + 1e-8)
    dx = torch.sum(xs[None, None, :] * m, dim=(1, 2))
    dy = torch.sum(xs[None, :, None] * m, dim=(1, 2))
    return torch.stack([dx, dy], dim=-1)


def transformer_crop(
    images: torch.Tensor,  # [B, C, H, W]
    out_size: int,
    batch_inds: torch.Tensor,  # [N] integer
    kpts_xy: torch.Tensor,  # [N, 2] (x, y) pixel coords
    kpts_scale: torch.Tensor | None = None,  # [N]
    kpts_ori: torch.Tensor | None = None,  # [N, 2] (cos, sin)
) -> torch.Tensor:
    """Oriented, scaled bilinear patches [N, C, out, out] around keypoints.

    Bilinear by hand as in the JAX code: the top-left tap is clipped to
    [0, W-2] x [0, H-2] and the fractions to [0, 1], so a sample outside the
    image takes the nearest border pair of taps (F.grid_sample treats the
    border differently).  The fractions' clip splits the gradient of a
    sample on an integer pixel as jnp.clip does (ops/numerics.clip)."""
    B, C, H, W = images.shape
    N = kpts_xy.shape[0]
    lin = torch.linspace(-1.0, 1.0, out_size, device=images.device)
    gx = lin[None, :].expand(out_size, out_size).reshape(1, -1)
    gy = lin[:, None].expand(out_size, out_size).reshape(1, -1)
    # theta = scale * I @ R(ori), written out entry by entry
    s = kpts_scale[:, None] if kpts_scale is not None else torch.ones_like(kpts_xy[:, :1])
    if kpts_ori is not None:
        cos, sin = kpts_ori[:, 0:1], kpts_ori[:, 1:2]
        t00, t01, t10, t11 = s * cos, s * (-sin), s * sin, s * cos
    else:
        zero = torch.zeros_like(s)
        t00, t01, t10, t11 = s, zero, zero, s
    half = out_size / 2.0
    x = (t00 * gx + t01 * gy) * half + kpts_xy[:, 0:1]  # [N, P*P]
    y = (t10 * gx + t11 * gy) * half + kpts_xy[:, 1:2]

    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    dx = clip(x - x0, 0.0, 1.0)[:, None]  # [N, 1, P*P]; jnp.clip's gradient at 0 and 1
    dy = clip(y - y0, 0.0, 1.0)[:, None]
    flat = images.permute(1, 0, 2, 3).reshape(C, B * H * W)
    lin_idx = (batch_inds.to(torch.int64)[:, None] * H + y0) * W + x0  # [N, P*P]

    def tap(offset):
        return flat[:, (lin_idx + offset).reshape(-1)].reshape(C, N, -1).transpose(0, 1)

    p00, p01, p10, p11 = tap(0), tap(1), tap(W), tap(W + 1)
    out = (
        p00 * (1 - dx) * (1 - dy)
        + p01 * dx * (1 - dy)
        + p10 * (1 - dx) * dy
        + p11 * dx * dy
    )
    return out.reshape(N, C, out_size, out_size)
