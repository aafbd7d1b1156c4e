"""Multi-frame depth fusion.

Counterpart of bundletrack_tpu/ops/fusion.py (reference:
CUDACache::fuseDepthFrames, src/cuda/CUDACache.cpp:90-120 and
CUDACache.cu:14-114: the cached depth frames fused into one frame's view,
off BundleTrack's main path).  Every frame's pixels are reprojected at once
and summed with one `index_add_` per buffer into H*W bins.  A dropped
pixel (no depth, behind the camera, outside the image) lands in a spare
bin past the image, the one of its own pixel position, and the spare half
is cut off.  Most of a masked frame is dropped, and one spare bin for all
of them serialises their atomic adds on the card on one address (15.9 ms
for 16 maps at 480x640 on NVIDIA H100 80GB HBM3, 700.00 W,
`chip_smoke.py`).

The relative poses are composed with broadcast multiply-adds in the order
of a 4x4 product, not with a matrix product: elementwise f32 arithmetic
rounds alike on the CPU and the card, where a library product may sum in
another order, and an ulp in a projected coordinate at a half pixel moves
a depth sample into the next bin.  Only the atomic adds on the card sum
in another order (ulps of the fused depth).
"""

from __future__ import annotations

import torch

from bundletrack_tpu_torch.geometry.camera import unproject
from bundletrack_tpu_torch.geometry.se3 import rotate_points


def _relative_poses(T_target: torch.Tensor, poses: torch.Tensor):
    """(R [K, 3, 3], t [K, 3]) of inv(T_target) @ poses[k], elementwise."""
    Rt = T_target[:3, :3].transpose(0, 1)
    t_inv = -rotate_points(Rt, T_target[None, :3, 3])[0]
    R = rotate_points(Rt, poses[:, :3, :3].transpose(-1, -2)).transpose(-1, -2)
    t = rotate_points(Rt, poses[:, None, :3, 3])[:, 0] + t_inv
    return R, t


def fuse_depth_frames(
    depths: torch.Tensor,  # [K, H, W] meters (0 invalid)
    poses: torch.Tensor,  # [K, 4, 4] cam->model
    K_mat: torch.Tensor,  # [3, 3]
    target_idx: int = 0,
    max_dist: float = 0.03,
) -> torch.Tensor:
    """Fuse all frames' depths into frame `target_idx`'s view: the average
    of the reprojected depths that land on a pixel, where it lies within
    max_dist of the target's own valid depth; the target's depth elsewhere."""
    Kf, H, W = depths.shape
    HW = H * W
    R_rel, t_rel = _relative_poses(poses[target_idx], poses)  # cam_k -> cam_target
    pts = unproject(depths, K_mat).reshape(Kf, HW, 3)
    p_t = rotate_points(R_rel, pts) + t_rel[:, None]
    fx, fy = K_mat[0, 0], K_mat[1, 1]
    cx, cy = K_mat[0, 2], K_mat[1, 2]
    z = p_t[..., 2]
    safe_z = torch.where(z > 1e-6, z, torch.ones_like(z))
    # saturate before the integer cast (the bounds test needs only the sign)
    lim = float(1 << 30)
    u = torch.round(torch.clamp(p_t[..., 0] / safe_z * fx + cx, -lim, lim)).to(torch.int64)
    v = torch.round(torch.clamp(p_t[..., 1] / safe_z * fy + cy, -lim, lim)).to(torch.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 1e-6) & (depths.reshape(Kf, HW) > 0)
    spare = HW + torch.arange(HW, device=depths.device)
    lin = torch.where(inb, v * W + u, spare).reshape(-1)  # frame-major, as the JAX loop adds
    acc = torch.zeros(2 * HW, dtype=depths.dtype, device=depths.device)
    acc.index_add_(0, lin, torch.where(inb, z, torch.zeros_like(z)).reshape(-1))
    wacc = torch.zeros(2 * HW, dtype=depths.dtype, device=depths.device)
    wacc.index_add_(0, lin, inb.to(depths.dtype).reshape(-1))
    acc, wacc = acc[:HW].reshape(H, W), wacc[:HW].reshape(H, W)
    fused = acc / torch.clamp(wacc, min=1.0)
    base = depths[target_idx]
    ok = (wacc > 0) & (torch.abs(fused - base) < max_dist) & (base > 0)
    return torch.where(ok, fused, base)
