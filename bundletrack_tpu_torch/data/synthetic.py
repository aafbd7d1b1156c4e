"""Synthetic RGB-D sequence renderer (ray-traced textured cube).

The port's own copy of bundletrack_tpu/data/synthetic.py (numpy only): the
same seed renders the same frames for both packages.

Ground-truth generator for integration tests and benchmarks: a textured
axis-aligned cube orbited by the camera, rendered analytically (slab-method
ray/box intersection) with exact depth, normals, and masks — the role the
real NOCS/YCBInEOAT datasets play for the reference (no datasets ship with
the repository).  Poses follow the reference convention ob_in_cam
(reference writes ob_in_cam = pose_in_model^-1 per frame,
src/Bundler.cpp:362-377).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticSequence(NamedTuple):
    gray: np.ndarray  # [F, H, W] float32 in [0, 1]
    depth: np.ndarray  # [F, H, W] float32 meters (0 = invalid)
    mask: np.ndarray  # [F, H, W] bool
    ob_in_cam: np.ndarray  # [F, 4, 4] ground-truth object pose in camera
    K: np.ndarray  # [3, 3]


def _hash01(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic integer-lattice hash -> [0, 1) floats."""
    h = (
        ix.astype(np.int64) * 374761393
        + iy.astype(np.int64) * 668265263
        + iz.astype(np.int64) * 2147483647
        + seed * 979025471
    )
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return (h & 0xFFFF).astype(np.float32) / 65535.0


def _texture(p: np.ndarray, cell: float = 0.02, seed: int = 0) -> np.ndarray:
    """Procedural corner-rich texture sampled at 3D surface points [N, 3]."""
    q = np.floor(p / cell)
    base = _hash01(q[..., 0], q[..., 1], q[..., 2], seed)
    # sub-cell gradient for shading variety
    frac = p / cell - q
    detail = 0.15 * _hash01(q[..., 0] * 3 + 1, q[..., 1] * 3 + 2, q[..., 2] * 3 + 3, seed)
    return np.clip(0.15 + 0.7 * base + detail * frac[..., 0], 0.0, 1.0)


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])):
    """Camera-to-world rotation/translation with +z forward (OpenCV)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)  # columns
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = eye
    return T  # cam -> world


def render_synthetic_sequence(
    num_frames: int = 12,
    H: int = 240,
    W: int = 320,
    box_size: float = 0.2,
    radius: float = 0.55,
    orbit_deg_per_frame: float = 3.0,
    elev_amp: float = 0.15,
    seed: int = 0,
    depth_noise: float = 0.0,
) -> SyntheticSequence:
    fx = fy = 0.9 * W
    K = np.array([[fx, 0, W / 2 - 0.5], [0, fy, H / 2 - 0.5], [0, 0, 1]], np.float32)
    half = box_size / 2.0

    grays, depths, masks, poses = [], [], [], []
    rng = np.random.RandomState(seed)

    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dirs_cam = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], axis=-1
    )  # z-normalized: depth = t

    for f in range(num_frames):
        ang = np.deg2rad(orbit_deg_per_frame * f)
        eye = np.array(
            [
                radius * np.sin(ang),
                elev_amp * np.sin(0.7 * ang),
                -radius * np.cos(ang),
            ]
        )
        T_cw = _look_at(eye, np.zeros(3))  # cam -> world (object frame)
        R_cw, t_cw = T_cw[:3, :3], T_cw[:3, 3]

        # rays in object frame
        o = t_cw
        d = dirs_cam @ R_cw.T  # [H, W, 3]

        # slab method for box [-half, half]^3
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_d = 1.0 / d
        t1 = (-half - o) * inv_d
        t2 = (half - o) * inv_d
        tmin = np.minimum(t1, t2).max(axis=-1)
        tmax = np.maximum(t1, t2).min(axis=-1)
        hit = (tmax > np.maximum(tmin, 0.0)) & np.isfinite(tmin)
        t_hit = np.where(hit, tmin, 0.0)

        p_obj = o + t_hit[..., None] * d  # [H, W, 3] hit points (object frame)
        # face normal (object frame): the axis where |p| ~ half
        axes = np.abs(np.abs(p_obj) - half)
        face_axis = axes.argmin(axis=-1)
        n_obj = np.zeros_like(p_obj)
        idx0, idx1 = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        n_obj[idx0, idx1, face_axis] = np.sign(p_obj[idx0, idx1, face_axis])

        tex = _texture(p_obj, seed=seed)
        # simple lambertian w.r.t. view direction for stable shading
        shade = np.clip(-np.sum(n_obj * d, axis=-1) / np.linalg.norm(d, axis=-1), 0.2, 1.0)
        gray = np.where(hit, tex * (0.6 + 0.4 * shade), 0.05).astype(np.float32)

        depth = t_hit.astype(np.float32)  # z-depth (d normalized to z=1)
        if depth_noise > 0:
            depth = depth + (depth_noise * rng.randn(H, W)).astype(np.float32) * hit
        depth = np.where(hit, depth, 0.0).astype(np.float32)

        T_wc = np.linalg.inv(T_cw)  # world(object) -> cam = ob_in_cam
        grays.append(gray)
        depths.append(depth)
        masks.append(hit)
        poses.append(T_wc.astype(np.float32))

    return SyntheticSequence(
        gray=np.stack(grays),
        depth=np.stack(depths),
        mask=np.stack(masks),
        ob_in_cam=np.stack(poses),
        K=K,
    )
