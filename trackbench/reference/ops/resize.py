"""Resize and ROI-crop ops for the keypoint frontend, channels-first.

Counterpart of bundletrack_tpu/ops/resize.py (reference:
Lfnet::detectFeature, src/FeatureManager.cpp:811-908: crop the mask ROI, pad
to square, resize to 400x400, map keypoints back).

The JAX package resamples with `jax.image.resize` and
`jax.image.scale_and_translate`, which antialias by default: when they
shrink an axis, the triangle kernel widens by 1/scale; the weights of each
output sample are renormalised, and a sample whose centre falls outside the
input gets none.  `F.interpolate` does neither, so the port builds the same
separable weight matrices (jax/_src/image/scale.py, compute_weight_mat) and
applies them as two products.  The crop's scale and offsets stay device
tensors: its weights are built on the device, with no host read.
"""

from __future__ import annotations

import functools

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """[..., in_size, out_size] triangle-kernel weights, antialiased.

    `inv_scale` is input pixels per output pixel, `shift` the translation
    times `inv_scale`; both f32 tensors of the batch shape [...] (0-dim for
    one image).  Output sample j reads input position
    (j + 0.5) * inv_scale - shift - 0.5."""
    dev = inv_scale.device
    kernel_scale = torch.clamp(inv_scale, min=1.0)[..., None, None]
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale[..., None]
                - shift[..., None] - 0.5)  # [..., out]
    x = torch.abs(sample_f[..., None, :] - torch.arange(in_size, dtype=torch.float32, device=dev)[:, None])
    x = x / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=-2, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS, weights / safe, torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype):
    """Weights of a plain resize in_size -> out_size (the scale is a host
    constant, as in jax.image.resize), built once per shape and device.
    Built outside inference mode even when first asked for inside it (the
    LF-Net serving forward): the cached tensor is also used by training,
    where autograd must save it."""
    with torch.inference_mode(False):
        inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
        w = _weight_mat(in_size, out_size, inv_scale, torch.zeros((), dtype=torch.float32))
        return w.to(device=device, dtype=dtype)


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of the last two axes of [..., H, W] to `out_hw`,
    antialiased when shrinking.  An axis whose size does not change is left
    as it is.  The product runs in the image's dtype (weights cast to it),
    rows first, then columns."""
    H, W = img.shape[-2], img.shape[-1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = img
    if oh != H:
        wh = _resize_weights(H, oh, img.device, img.dtype)
        out = torch.matmul(wh.transpose(0, 1), out)
    if ow != W:
        ww = _resize_weights(W, ow, img.device, img.dtype)
        out = torch.matmul(out, ww)
    return out


def crop_resize_square(img: torch.Tensor, roi, out_size: int):
    """Crop ROI (umin, umax, vmin, vmax), pad to square, resize to out_size.

    Every entry of `roi` may be a device tensor of a batch shape [...]: a
    0-dim ROI crops img [H, W] or [C, H, W]; an ROI of shape [S] crops each
    of img [S, H, W] or [S, C, H, W] by its own box (the fleet's streams).
    Returns (resized [..., out, out], scale, offset_u, offset_v), the last
    three of the ROI's shape, where original pixel = keypoint_px / scale +
    offset."""
    umin, umax, vmin, vmax = roi
    H, W = img.shape[-2], img.shape[-1]
    w = (umax - umin + 1).to(torch.float32)
    h = (vmax - vmin + 1).to(torch.float32)
    side = torch.maximum(w, h)
    # tensor / tensor: torch computes `number / tensor` as a reciprocal
    # times the number, which can round differently from the division
    scale = torch.full_like(side, float(out_size)) / side  # output px per input px
    inv_scale = torch.ones_like(scale) / scale
    translate_u = -umin.to(torch.float32) * scale
    translate_v = -vmin.to(torch.float32) * scale
    # the batch axes of the weights, then one axis per channel axis of img
    lead = (*scale.shape, *([1] * (img.dim() - 2 - scale.dim())))
    wv = _weight_mat(H, out_size, inv_scale, translate_v * inv_scale).reshape(*lead, H, out_size)
    wu = _weight_mat(W, out_size, inv_scale, translate_u * inv_scale).reshape(*lead, W, out_size)
    out = torch.matmul(torch.matmul(wv.transpose(-1, -2), img.to(torch.float32)), wu)
    return out, scale, umin.to(torch.float32), vmin.to(torch.float32)


def keypoints_to_original(kpts_uv: torch.Tensor, scale, offset_u, offset_v) -> torch.Tensor:
    """Inverse of crop_resize_square for [..., N, 2] keypoints, with scale
    and offsets of the batch shape [...] (reference
    FeatureManager.cpp:884-898)."""
    u = kpts_uv[..., 0] / scale[..., None] + offset_u[..., None]
    v = kpts_uv[..., 1] / scale[..., None] + offset_v[..., None]
    return torch.stack([u, v], dim=-1)
