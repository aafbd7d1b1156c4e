"""Debug visualization dumps (LOG-gated in the reference), numpy in, PNG out.

Counterpart of bundletrack_tpu/utils/viz.py (reference:
FeatureManager.cpp:125-139 keypoint viz, 760-796 per-pair match viz
before/after RANSAC, Bundler.cpp:379-411 color_viz with reprojected model
points).  Pure numpy drawing and the port's PNG writer, no OpenCV; pass
host arrays (`tensor.cpu().numpy()`).
"""

from __future__ import annotations

import os

import numpy as np

from bundletrack_tpu_torch.data.native_io import write_png


def _to_u8_rgb(gray_or_rgb: np.ndarray) -> np.ndarray:
    img = np.asarray(gray_or_rgb)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img.copy()


def _draw_disk(img: np.ndarray, u: int, v: int, color, radius: int = 2):
    H, W = img.shape[:2]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                y, x = v + dy, u + dx
                if 0 <= y < H and 0 <= x < W:
                    img[y, x] = color


def _draw_line(img: np.ndarray, u0, v0, u1, v1, color):
    n = int(max(abs(u1 - u0), abs(v1 - v0), 1))
    us = np.linspace(u0, u1, n + 1).astype(int)
    vs = np.linspace(v0, v1, n + 1).astype(int)
    H, W = img.shape[:2]
    ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    img[vs[ok], us[ok]] = color


def draw_keypoints(gray, kpts_uv, valid, path: str):
    """Keypoint overlay (reference FeatureManager.cpp:125-139)."""
    img = _to_u8_rgb(gray)
    for (u, v), ok in zip(np.asarray(kpts_uv), np.asarray(valid)):
        if ok:
            _draw_disk(img, int(round(u)), int(round(v)), (0, 255, 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)


def draw_matches(gray_a, kpts_a, gray_b, kpts_b, idx_a, idx_b, valid, path: str):
    """Side-by-side match visualization (reference vizCorresBetween,
    FeatureManager.cpp:760-796)."""
    a = _to_u8_rgb(gray_a)
    b = _to_u8_rgb(gray_b)
    H = max(a.shape[0], b.shape[0])
    W = a.shape[1] + b.shape[1]
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1] :] = b
    off = a.shape[1]
    ka = np.asarray(kpts_a)
    kb = np.asarray(kpts_b)
    for ia, ib, ok in zip(np.asarray(idx_a), np.asarray(idx_b), np.asarray(valid)):
        if not ok:
            continue
        u0, v0 = ka[ia]
        u1, v1 = kb[ib]
        _draw_line(canvas, int(u0), int(v0), int(u1) + off, int(v1), (255, 255, 0))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, canvas)


def draw_reprojection(gray, model_pts, ob_in_cam, K, path: str, color=(255, 0, 0)):
    """Project model points with the estimated pose onto the image
    (reference Bundler.cpp:379-411 color_viz / Utils::drawProjectPoints)."""
    img = _to_u8_rgb(gray)
    pts = np.asarray(model_pts) @ np.asarray(ob_in_cam)[:3, :3].T + np.asarray(ob_in_cam)[:3, 3]
    z = np.maximum(pts[:, 2], 1e-6)
    u = (pts[:, 0] / z * K[0, 0] + K[0, 2]).astype(int)
    v = (pts[:, 1] / z * K[1, 1] + K[1, 2]).astype(int)
    H, W = img.shape[:2]
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (pts[:, 2] > 0)
    img[v[ok], u[ok]] = color
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, img)
