"""Ground-truth correspondence fields from depth and pose.

The port's own copy of `warp_field_from_depth` from
bundletrack_tpu/data/pairs.py (the reference builds LF-Net's training pairs
the same way, lf-net-release/train_lfnet.py): the data `eval/frontend_eval`
scores keypoints against.  Host-side numpy; it rounds and clips on the
host exactly as the JAX package does, so both give the same field.
"""

from __future__ import annotations

import numpy as np


def warp_field_from_depth(
    depth1: np.ndarray,
    K: np.ndarray,
    ob_in_cam1: np.ndarray,
    ob_in_cam2: np.ndarray,
    depth2: np.ndarray | None = None,
    mask1: np.ndarray | None = None,
    occlusion_tol: float = 0.02,
):
    """Per-pixel correspondence field frame1 -> frame2.

    For each pixel of frame 1 with valid depth: unproject with K, move the
    point from camera-1 to camera-2 through the object poses
    (p2 = ob_in_cam2 @ ob_in_cam1^-1 @ p1 — the object is rigid, the camera
    moves), and project into frame 2.  Validity requires: valid source depth,
    the target landing inside the image, and (when depth2 is given) the
    projected depth agreeing with frame 2's depth within `occlusion_tol`
    meters (occlusion check).

    Returns (warp12 [H, W, 2] float32 xy, valid [H, W] bool).
    """
    H, W = depth1.shape
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    z = depth1.astype(np.float32)
    valid = z > 0
    if mask1 is not None:
        valid &= mask1.astype(bool)

    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    p1 = np.stack([x, y, z], axis=-1)  # [H, W, 3] in cam-1

    T21 = ob_in_cam2 @ np.linalg.inv(ob_in_cam1)
    p2 = p1 @ T21[:3, :3].T + T21[:3, 3]
    z2 = p2[..., 2]
    valid &= z2 > 1e-6
    z2s = np.where(z2 > 1e-6, z2, 1.0)
    u2 = p2[..., 0] / z2s * K[0, 0] + K[0, 2]
    v2 = p2[..., 1] / z2s * K[1, 1] + K[1, 2]
    inside = (u2 >= 0) & (u2 <= W - 1) & (v2 >= 0) & (v2 <= H - 1)
    valid &= inside

    if depth2 is not None:
        ui = np.clip(np.round(u2).astype(np.int32), 0, W - 1)
        vi = np.clip(np.round(v2).astype(np.int32), 0, H - 1)
        d2 = depth2[vi, ui]
        valid &= (d2 > 0) & (np.abs(d2 - z2) < occlusion_tol)

    warp = np.stack([u2, v2], axis=-1).astype(np.float32)
    warp = np.where(valid[..., None], warp, 0.0)
    return warp, valid
