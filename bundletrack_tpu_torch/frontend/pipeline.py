"""Per-frame feature extraction: detector -> 3D lifting.

Counterpart of bundletrack_tpu/frontend/pipeline.py (reference:
src/FeatureManager.cpp:811-908 crops the mask ROI, resizes it to 400x400,
runs the net, maps the keypoints back and reads each keypoint's point and
normal from the frame's cloud).

Two frontends:
  * "classical" — Shi-Tomasi + patch descriptors on the full-resolution
    masked image;
  * "lfnet"     — the learned frontend (frontend/lfnet.py) on the masked
    ROI crop at cfg.input_size, keypoints mapped back through the affine.
    It needs the net: without `lfnet_apply` it raises, where the JAX
    package runs the classical frontend instead.

Inputs may carry a leading stream axis: the classical frontend detects on
every stream at once, the LF-Net branch crops and runs the net per stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.frontend.classical import harris_keypoints_and_descriptors
from bundletrack_tpu_torch.frontend.interface import FrontendOutput
from bundletrack_tpu_torch.ops.masks import mask_roi
from bundletrack_tpu_torch.ops.resize import crop_resize_square, keypoints_to_original


class FrameFeatures(NamedTuple):
    """Keypoints lifted to 3D for one frame (or a leading stream axis)."""

    uv: torch.Tensor  # [..., N, 2] pixel coords
    desc: torch.Tensor  # [..., N, D]
    pts: torch.Tensor  # [..., N, 3] camera-space
    normals: torch.Tensor  # [..., N, 3]
    valid: torch.Tensor  # [..., N]


def _lift_to_3d(out: FrontendOutput, points_map, normals_map, valid_map) -> FrameFeatures:
    H, W = valid_map.shape[-2:]
    ui = torch.clamp(torch.round(out.kpts_uv[..., 0]).long(), 0, W - 1)
    vi = torch.clamp(torch.round(out.kpts_uv[..., 1]).long(), 0, H - 1)
    lin = (vi * W + ui).reshape(-1, ui.shape[-1])  # [B, N]
    B, N = lin.shape
    pick = lin[..., None].expand(B, N, 3)
    pts = torch.gather(points_map.reshape(B, H * W, 3), 1, pick).reshape(*ui.shape, 3)
    normals = torch.gather(normals_map.reshape(B, H * W, 3), 1, pick).reshape(*ui.shape, 3)
    ok = out.valid & torch.gather(valid_map.reshape(B, H * W), 1, lin).reshape(ui.shape)
    return FrameFeatures(
        uv=out.kpts_uv,
        desc=out.desc,
        pts=torch.where(ok[..., None], pts, torch.zeros_like(pts)),
        normals=torch.where(ok[..., None], normals, torch.zeros_like(normals)),
        valid=ok,
    )


def extract_frame_features(
    gray: torch.Tensor,  # [..., H, W] in [0, 1]
    mask: torch.Tensor,  # [..., H, W] bool
    points_map: torch.Tensor,  # [..., H, W, 3]
    normals_map: torch.Tensor,  # [..., H, W, 3]
    valid_map: torch.Tensor,  # [..., H, W] bool
    cfg: FrontendConfig,
    lfnet_apply=None,  # callable(crop [S, S, 1]) -> FrontendOutput in crop coords
) -> FrameFeatures:
    if cfg.kind == "classical":
        out = harris_keypoints_and_descriptors(
            gray,
            mask,
            top_k=cfg.top_k,
            sigma=cfg.harris_sigma,
            z_map=points_map[..., 2],
            patch_z0=cfg.harris_patch_z0,
        )
        return _lift_to_3d(out, points_map, normals_map, valid_map)
    if cfg.kind != "lfnet":
        raise ValueError(f"unknown frontend.kind {cfg.kind!r}")
    if lfnet_apply is None:
        raise ValueError("frontend.kind='lfnet' needs the net: pass lfnet_apply")
    if gray.dim() == 3:  # a stream axis: one crop and forward per stream
        per_stream = [
            extract_frame_features(*args, cfg, lfnet_apply)
            for args in zip(gray, mask, points_map, normals_map, valid_map)
        ]
        return FrameFeatures(*(torch.stack(f) for f in zip(*per_stream)))

    # learned path: the crop is masked first, as the reference zeroes every
    # pixel outside the segmentation (Frame::invalidatePixelsByMask)
    umin, umax, vmin, vmax, nonempty = mask_roi(mask)
    crop, scale, ou, ov = crop_resize_square(
        torch.where(mask, gray, torch.zeros_like(gray)), (umin, umax, vmin, vmax), cfg.input_size
    )
    out = lfnet_apply(crop[..., None])
    kpts_orig = keypoints_to_original(out.kpts_uv, scale, ou, ov)
    # keep only keypoints inside the mask
    H, W = mask.shape
    ui = torch.clamp(torch.round(kpts_orig[:, 0]).long(), 0, W - 1)
    vi = torch.clamp(torch.round(kpts_orig[:, 1]).long(), 0, H - 1)
    ok = out.valid & mask[vi, ui] & nonempty
    out = FrontendOutput(kpts_uv=kpts_orig, scores=out.scores, desc=out.desc, valid=ok)
    return _lift_to_3d(out, points_map, normals_map, valid_map)
