"""Depth -> camera-space cloud + normals, and the cloud utilities.

Counterpart of bundletrack_tpu/ops/pointcloud.py (reference:
src/cuda/CUDAImageUtil.cu convertDepthFloatToCameraSpaceFloat4 and
computeNormals).  Normals face the camera.  `voxel_downsample` and
`statistical_outlier_removal` are host numpy, as in the JAX package: they
run once per sequence on model clouds.
"""

from __future__ import annotations

import numpy as np
import torch

from trackbench.reference.geometry.camera import unproject


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


def downsample_nearest(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Every `factor`-th row and column of [..., H, W] or channel-last
    [..., H, W, C] (C <= 4), as a strided view (reference CUDACache::
    storeFrame resamples frames before the dense term, src/cuda/
    CUDACache.cpp:76-88; nearest keeps depth edges crisp)."""
    if img.dim() >= 3 and img.shape[-1] in (1, 2, 3, 4):  # channel-last
        return img[..., ::factor, ::factor, :]
    return img[..., ::factor, ::factor]


def voxel_downsample(points, voxel_size: float) -> np.ndarray:
    """An [N, 3] cloud as the centroids of its occupied voxels, float32
    (reference Utils::downsamplePointCloud, PCL VoxelGrid, src/Utils.cpp:
    133-141, on model clouds at load with vox_size 0.015)."""
    pts = np.asarray(points, np.float64)
    if len(pts) == 0:
        return pts.astype(np.float32)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))  # group the voxels by sorting
    keys_s, pts_s = keys[order], pts[order]
    starts = np.concatenate([[0], np.nonzero(np.any(np.diff(keys_s, axis=0) != 0, axis=1))[0] + 1])
    sums = np.add.reduceat(pts_s, starts, axis=0)
    counts = np.diff(np.concatenate([starts, [len(pts_s)]]))
    return (sums / counts[:, None]).astype(np.float32)


def statistical_outlier_removal(points, num_neighbors: int = 30, std_mul: float = 3.0):
    """Drop the points whose mean distance to their k nearest neighbours
    exceeds the mean of that over the cloud + std_mul standard deviations
    (PCL StatisticalOutlierRemoval, reference src/Utils.h:106, configured by
    depth_processing.outlier_removal).  Brute force, for model clouds.
    Returns (kept points, keep mask)."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    if n <= num_neighbors:
        return pts, np.ones(n, bool)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(num_neighbors, n - 1)
    mean_d = np.sqrt(np.partition(d2, k - 1, axis=1)[:, :k]).mean(axis=1)
    keep = mean_d <= mean_d.mean() + std_mul * mean_d.std()
    return pts[keep], keep
