"""Evaluate tracked poses against ground truth (ADD / ADD-S AUC).

Counterpart of bundletrack_tpu/apps/eval_ycbineoat.py: the reference
evaluation protocol (reference:
scripts/eval_ycbineoat.py:105-164 — per-frame np.loadtxt of predicted
poses/<id>.txt vs annotated_poses/<id>.txt, ADD and ADD-S via
scripts/Utils.py:69-95, VOCap AUC over 0-0.1 m x100).

Usage:
    python -m bundletrack_tpu_torch.apps.eval_ycbineoat \
        --pred_dir out/poses --gt_dir data/annotated_poses --model points.xyz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from bundletrack_tpu_torch.eval.metrics import add_error, adi_error, vocap_auc


def load_model_points(path: str, max_points: int = 2000) -> np.ndarray:
    """Load .xyz (text Nx3[+...]) or .obj vertex points."""
    if path.endswith(".obj"):
        pts = []
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    pts.append([float(x) for x in line.split()[1:4]])
        pts = np.asarray(pts, np.float32)
    else:
        pts = np.loadtxt(path).astype(np.float32)[:, :3]
    if len(pts) > max_points:
        idx = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[idx]
    return pts


def evaluate(pred_dir: str, gt_dir: str, model_pts: np.ndarray):
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(gt_dir) if f.endswith(".txt"))
    adds, adis = [], []
    missing = 0
    for fid in ids:
        pred_file = os.path.join(pred_dir, fid + ".txt")
        if not os.path.exists(pred_file):
            missing += 1
            continue
        pred = np.loadtxt(pred_file).reshape(4, 4)
        gt = np.loadtxt(os.path.join(gt_dir, fid + ".txt")).reshape(4, 4)
        adds.append(add_error(pred, gt, model_pts))
        adis.append(adi_error(pred, gt, model_pts))
    return {
        "num_frames": len(adds),
        "missing": missing,
        "ADD_AUC": vocap_auc(adds),
        "ADDS_AUC": vocap_auc(adis),
        "ADD_mean_m": float(np.mean(adds)) if adds else None,
        "ADDS_mean_m": float(np.mean(adis)) if adis else None,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--model", required=True, help=".xyz or .obj model points")
    args = p.parse_args(argv)
    model_pts = load_model_points(args.model)
    res = evaluate(args.pred_dir, args.gt_dir, model_pts)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
