"""NOCS-REAL275 evaluation protocol: symmetry-aware 5deg5cm, IoU-25,
rot/trans errors, and init-pose noise injection.

The port's own copy of bundletrack_tpu/eval/nocs_protocol.py (numpy only).
The reference's NOCS benchmark math (reference:
scripts/benchmark.py:65-160 — compute_3d_iou_new with y-axis symmetry sweep
for bottle/can/bowl/handle-hidden mug, transform_coordinates_3d,
compute_RT_degree_cm_symmetry; scripts/eval_nocs.py:63-116 — init pose
perturbed by +-0.02 m translation noise and the relative-trajectory
re-anchoring used for comparability with 6-PACK).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]
_Y_SYMMETRIC = {"bottle", "can", "bowl"}


def transform_coordinates_3d(coords: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """[3, N] homogeneous transform (reference benchmark.py:113-118)."""
    assert coords.shape[0] == 3
    hom = np.vstack([coords, np.ones((1, coords.shape[1]), np.float32)])
    out = RT @ hom
    return out[:3] / out[3]


def _axis_aligned_iou(b1: np.ndarray, b2: np.ndarray) -> float:
    """IoU of axis-aligned bounds of two [3, 8] corner sets."""
    b1_max, b1_min = b1.max(axis=1), b1.min(axis=1)
    b2_max, b2_min = b2.max(axis=1), b2.min(axis=1)
    omin = np.maximum(b1_min, b2_min)
    omax = np.minimum(b1_max, b2_max)
    if (omax - omin).min() < 0:
        inter = 0.0
    else:
        inter = float(np.prod(omax - omin))
    union = float(np.prod(b1_max - b1_min) + np.prod(b2_max - b2_min) - inter)
    return inter / union if union > 0 else 0.0


def compute_3d_iou(
    RT_gt: np.ndarray,
    RT_pred: np.ndarray,
    bbox: np.ndarray,  # [3, 8] model-frame bbox corners
    class_name: str,
    handle_visibility: int = 1,
) -> float:
    """3D bbox IoU, sweeping y-rotations for symmetric classes
    (reference compute_3d_iou_new, benchmark.py:65-111)."""
    symmetric = class_name in _Y_SYMMETRIC or (
        class_name == "mug" and handle_visibility == 0
    )
    b2 = transform_coordinates_3d(bbox, RT_pred)
    if not symmetric:
        return _axis_aligned_iou(transform_coordinates_3d(bbox, RT_gt), b2)
    best = 0.0
    for i in range(20):
        th = 2 * math.pi * i / 20.0
        rot = np.array(
            [
                [math.cos(th), 0, math.sin(th), 0],
                [0, 1, 0, 0],
                [-math.sin(th), 0, math.cos(th), 0],
                [0, 0, 0, 1],
            ]
        )
        best = max(best, _axis_aligned_iou(
            transform_coordinates_3d(bbox, RT_gt @ rot), b2))
    return best


def degree_cm_error(
    RT_gt: np.ndarray,
    RT_pred: np.ndarray,
    class_name: str,
    handle_visibility: int = 1,
):
    """(rotation deg, translation m) with symmetry handling
    (reference compute_RT_degree_cm_symmetry, benchmark.py:120-160)."""
    R1 = RT_gt[:3, :3] / np.cbrt(np.linalg.det(RT_gt[:3, :3]))
    R2 = RT_pred[:3, :3] / np.cbrt(np.linalg.det(RT_pred[:3, :3]))
    if class_name in _Y_SYMMETRIC or (class_name == "mug" and handle_visibility == 0):
        y = np.array([0.0, 1.0, 0.0])
        y1, y2 = R1 @ y, R2 @ y
        cos = y1.dot(y2) / (np.linalg.norm(y1) * np.linalg.norm(y2))
        theta = np.arccos(np.clip(cos, -1, 1))
    else:
        R = R1 @ R2.T
        theta = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    shift = np.linalg.norm(RT_gt[:3, 3] - RT_pred[:3, 3])
    return float(np.rad2deg(theta)), float(shift)


def perturb_init_pose(
    pose: np.ndarray,
    trans_noise: float = 0.02,
    rot_noise_deg: float = 0.0,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Init-pose noise injection (reference eval_nocs.py:95-106; default
    noise_pair=[0.02, 0] for 6-PACK comparability)."""
    rng = rng or np.random.RandomState(0)
    out = pose.copy()
    out[:3, 3] += rng.uniform(-trans_noise, trans_noise, 3)
    if rot_noise_deg > 0:
        direction = rng.randn(3)
        direction /= np.linalg.norm(direction)
        mag = rng.uniform(-np.deg2rad(rot_noise_deg), np.deg2rad(rot_noise_deg))
        w = direction * mag
        th = np.linalg.norm(w)
        if th > 1e-12:
            k = w / th
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            out[:3, :3] = out[:3, :3] @ R
    return out


def reanchor_trajectory(poses: Sequence[np.ndarray], noisy_init: np.ndarray):
    """Re-express a trajectory relative to a perturbed initial pose
    (reference eval_nocs.py:108-111: cam_in_firstcam = init @ inv(pred);
    pred_new = inv(cam_in_firstcam) @ noisy_init)."""
    init = poses[0]
    out = [noisy_init.copy()]
    for p in poses[1:]:
        cam_in_first = init @ np.linalg.inv(p)
        out.append(np.linalg.inv(cam_in_first) @ noisy_init)
    return out


def evaluate_nocs(
    preds: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    bbox: np.ndarray,  # [3, 8]
    class_name: str,
    handle_visibility: int = 1,
):
    """Per-sequence NOCS metrics (reference benchmark.py:163-320 aggregation:
    5deg5cm requires IoU>0.25 as a validity gate)."""
    n = len(preds)
    n_5d5cm = 0
    n_iou25 = 0
    rots, trans = [], []
    for p, g in zip(preds, gts):
        iou = compute_3d_iou(g, p, bbox, class_name, handle_visibility)
        r, t = degree_cm_error(g, p, class_name, handle_visibility)
        if iou > 0.25:
            n_iou25 += 1
            if r <= 5.0 and t <= 0.05:
                n_5d5cm += 1
            rots.append(r)
            trans.append(t)
    return {
        "5deg5cm": 100.0 * n_5d5cm / max(n, 1),
        "IoU25": 100.0 * n_iou25 / max(n, 1),
        "rot_err_deg_mean": float(np.mean(rots)) if rots else None,
        "trans_err_cm_mean": float(np.mean(trans)) * 100 if trans else None,
        "num_frames": n,
    }
