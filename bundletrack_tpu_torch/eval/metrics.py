"""Pose accuracy metrics: ADD and ADD-S with the VOCap AUC, pose errors and
5deg5cm.

The port's own copy of bundletrack_tpu/eval/metrics.py (reference:
scripts/Utils.py add/adi, scripts/eval_ycbineoat.py VOCap with a 0.1 m
cutoff x100, scripts/benchmark.py NOCS 5deg5cm).  Host-side numpy + scipy.
"""

from __future__ import annotations

import numpy as np
from scipy import spatial
from scipy.spatial.transform import Rotation


def _transform(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:3, :3].T + pose[:3, 3]


def add_error(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """ADD: mean distance between the model points under the predicted and
    the true pose (non-symmetric objects)."""
    return float(np.linalg.norm(_transform(pred, model_pts) - _transform(gt, model_pts), axis=1).mean())


def adi_error(pred: np.ndarray, gt: np.ndarray, model_pts: np.ndarray) -> float:
    """ADD-S: mean nearest-neighbour distance between the model under the
    predicted and the true pose."""
    dists, _ = spatial.cKDTree(_transform(pred, model_pts)).query(_transform(gt, model_pts), k=1)
    return float(dists.mean())


def vocap_auc(errors, max_val: float = 0.1) -> float:
    """AUC of the error-threshold curve, x100."""
    rec = np.sort(np.asarray(errors, dtype=np.float64))
    n = len(rec)
    if n == 0:
        return 0.0
    prec = np.arange(1, n + 1) / float(n)
    idx = np.where(rec < max_val)[0]
    if len(idx) == 0:
        return 0.0
    rec = rec[idx]
    prec = prec[idx]
    mrec = np.concatenate([[0], rec, [max_val]])
    mpre = np.concatenate([[0], prec, [prec[-1]]])
    for i in range(1, len(mpre)):
        mpre[i] = max(mpre[i], mpre[i - 1])
    i = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[i] - mrec[i - 1]) * mpre[i]) * (1.0 / max_val) * 100.0)


def add_auc(preds, gts, model_pts, max_val: float = 0.1) -> float:
    return vocap_auc([add_error(p, g, model_pts) for p, g in zip(preds, gts)], max_val)


def adds_auc(preds, gts, model_pts, max_val: float = 0.1) -> float:
    return vocap_auc([adi_error(p, g, model_pts) for p, g in zip(preds, gts)], max_val)


def pose_errors(pred: np.ndarray, gt: np.ndarray):
    """(rotation error in degrees, translation error in meters)."""
    rot = Rotation.from_matrix(pred[:3, :3] @ gt[:3, :3].T).magnitude()
    return float(np.rad2deg(rot)), float(np.linalg.norm(pred[:3, 3] - gt[:3, 3]))


def five_deg_five_cm(preds, gts) -> float:
    """Share (%) of frames within 5 degrees and 5 cm (the NOCS protocol,
    reference benchmark.py:296-320)."""
    preds = list(preds)
    ok = sum(r <= 5.0 and t <= 0.05 for r, t in (pose_errors(p, g) for p, g in zip(preds, gts)))
    return 100.0 * ok / max(len(preds), 1)
