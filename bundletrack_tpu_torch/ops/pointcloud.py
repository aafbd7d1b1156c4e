"""Depth -> camera-space cloud + normals.

Counterpart of bundletrack_tpu/ops/pointcloud.py (reference:
src/cuda/CUDAImageUtil.cu convertDepthFloatToCameraSpaceFloat4 and
computeNormals).  Normals face the camera.
"""

from __future__ import annotations

import torch

from bundletrack_tpu_torch.geometry.camera import unproject


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def compute_normals(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross-product normals of central differences, [..., H, W, 3] (zero
    where undefined)."""
    right = torch.roll(points, -1, dims=-2)
    left = torch.roll(points, 1, dims=-2)
    down = torch.roll(points, -1, dims=-3)
    up = torch.roll(points, 1, dims=-3)
    v_r = torch.roll(valid, -1, dims=-1)
    v_l = torch.roll(valid, 1, dims=-1)
    v_d = torch.roll(valid, -1, dims=-2)
    v_u = torch.roll(valid, 1, dims=-2)
    H, W = valid.shape[-2:]
    border = torch.zeros((H, W), dtype=torch.bool, device=valid.device)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True

    n = _cross(down - up, right - left)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = v_r & v_l & v_d & v_u & valid & (~border) & (norm[..., 0] > 1e-10)
    n = n / torch.clamp(norm, min=1e-10)
    flip = torch.sum(n * points, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(ok[..., None], n, torch.zeros_like(n))


def depth_to_cloud_and_normals(depth: torch.Tensor, K: torch.Tensor):
    """Depth [..., H, W], intrinsics [..., 3, 3] -> (points [..., H, W, 3],
    normals [..., H, W, 3], valid [..., H, W])."""
    valid = depth > 0.1
    pts = unproject(depth, K)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    normals = compute_normals(pts, valid)
    valid = valid & (torch.linalg.norm(normals, dim=-1) > 0.5)
    return pts, normals, valid
