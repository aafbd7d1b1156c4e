"""Evaluation: pose-accuracy metrics (ADD and ADD-S AUC, rotation and
translation errors, 5deg5cm), frontend quality, VOS mask IoU, and the
hard-world suites (eval/hard_suite.py)."""

from bundletrack_tpu_torch.eval.frontend_eval import evaluate_frontend, make_feature_fn
from bundletrack_tpu_torch.eval.metrics import (
    add_auc,
    add_error,
    adds_auc,
    adi_error,
    five_deg_five_cm,
    pose_errors,
    vocap_auc,
)
from bundletrack_tpu_torch.eval.vos_eval import evaluate_vos, mask_iou

__all__ = [
    "evaluate_frontend",
    "evaluate_vos",
    "mask_iou",
    "make_feature_fn",
    "add_error",
    "adi_error",
    "vocap_auc",
    "add_auc",
    "adds_auc",
    "pose_errors",
    "five_deg_five_cm",
]
