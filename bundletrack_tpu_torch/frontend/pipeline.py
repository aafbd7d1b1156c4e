"""Per-frame feature extraction: detector -> 3D lifting.

Counterpart of bundletrack_tpu/frontend/pipeline.py (reference:
src/FeatureManager.cpp:811-908).  Only the classical branch is ported; the
LF-Net branch raises until its slice lands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.frontend.classical import harris_keypoints_and_descriptors
from bundletrack_tpu_torch.frontend.interface import FrontendOutput


class FrameFeatures(NamedTuple):
    """Keypoints lifted to 3D for one frame."""

    uv: torch.Tensor  # [N, 2] pixel coords
    desc: torch.Tensor  # [N, D]
    pts: torch.Tensor  # [N, 3] camera-space
    normals: torch.Tensor  # [N, 3]
    valid: torch.Tensor  # [N]


def _lift_to_3d(out: FrontendOutput, points_map, normals_map, valid_map) -> FrameFeatures:
    H, W = valid_map.shape
    ui = torch.clamp(torch.round(out.kpts_uv[:, 0]).long(), 0, W - 1)
    vi = torch.clamp(torch.round(out.kpts_uv[:, 1]).long(), 0, H - 1)
    pts = points_map[vi, ui]
    normals = normals_map[vi, ui]
    ok = out.valid & valid_map[vi, ui]
    return FrameFeatures(
        uv=out.kpts_uv,
        desc=out.desc,
        pts=torch.where(ok[:, None], pts, torch.zeros_like(pts)),
        normals=torch.where(ok[:, None], normals, torch.zeros_like(normals)),
        valid=ok,
    )


def extract_frame_features(
    gray: torch.Tensor,  # [H, W] in [0, 1]
    mask: torch.Tensor,  # [H, W] bool
    points_map: torch.Tensor,  # [H, W, 3]
    normals_map: torch.Tensor,  # [H, W, 3]
    valid_map: torch.Tensor,  # [H, W] bool
    cfg: FrontendConfig,
) -> FrameFeatures:
    if cfg.kind != "classical":
        raise NotImplementedError(
            f"frontend.kind={cfg.kind!r}: only the classical frontend is ported"
        )
    out = harris_keypoints_and_descriptors(
        gray,
        mask,
        top_k=cfg.top_k,
        sigma=cfg.harris_sigma,
        z_map=points_map[..., 2],
        patch_z0=cfg.harris_patch_z0,
    )
    return _lift_to_3d(out, points_map, normals_map, valid_map)
