"""Pose accuracy metrics: ADD-S with the VOCap AUC, and pose errors.

The port's own copy of the parts of bundletrack_tpu/eval/metrics.py the
tracker checks use (reference: scripts/Utils.py adi, scripts/eval_ycbineoat.py
VOCap with a 0.1 m cutoff x100).  Host-side numpy + scipy.
"""

from __future__ import annotations

import numpy as np
from scipy import spatial
from scipy.spatial.transform import Rotation


def _transform(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:3, :3].T + pose[:3, 3]


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


def adds_auc(preds, gts, model_pts, max_val: float = 0.1) -> float:
    return vocap_auc([adi_error(p, g, model_pts) for p, g in zip(preds, gts)], max_val)


def pose_errors(pred: np.ndarray, gt: np.ndarray):
    """(rotation error in degrees, translation error in meters)."""
    rot = Rotation.from_matrix(pred[:3, :3] @ gt[:3, :3].T).magnitude()
    return float(np.rad2deg(rot)), float(np.linalg.norm(pred[:3, 3] - gt[:3, 3]))
