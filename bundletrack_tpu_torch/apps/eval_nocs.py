"""CLI app: NOCS-REAL275 benchmark metrics over tracked pose outputs.

Counterpart of bundletrack_tpu/apps/eval_nocs.py: the reference's two-stage
NOCS evaluation (reference: scripts/eval_nocs.py:63-116 — load per-frame
pred/GT poses, perturb the init pose by +-0.02 m translation noise,
re-anchor the predicted trajectory to the noisy init for 6-PACK
comparability; scripts/benchmark.py:163-320 — 5deg5cm, IoU-25, mean
rotation/translation errors with y-axis symmetry sweeps).  Host numpy only.

Usage:
    python -m bundletrack_tpu_torch.apps.eval_nocs --pred_dir out/poses \
        --gt_dir data/gt_poses --model model.xyz --class_name can \
        [--noise_trans 0.02] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from bundletrack_tpu_torch.apps.eval_ycbineoat import load_model_points
from bundletrack_tpu_torch.eval.nocs_protocol import (
    SYNSET_NAMES,
    evaluate_nocs,
    perturb_init_pose,
    reanchor_trajectory,
)


def model_bbox_corners(model_pts: np.ndarray) -> np.ndarray:
    """[3, 8] axis-aligned bbox corners of the model cloud
    (reference benchmark.py get_3d_bbox)."""
    mn = model_pts.min(axis=0)
    mx = model_pts.max(axis=0)
    corners = np.array(
        [
            [mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]],
            [mn[0], mx[1], mn[2]], [mn[0], mx[1], mx[2]],
            [mx[0], mn[1], mn[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mn[2]], [mx[0], mx[1], mx[2]],
        ],
        np.float32,
    )
    return corners.T


def _load_pose_dir(d: str):
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(".txt"))
    return ids, {i: np.loadtxt(os.path.join(d, i + ".txt")).reshape(4, 4) for i in ids}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred_dir", required=True, help="tracker poses/<id>.txt dir")
    p.add_argument("--gt_dir", required=True, help="GT ob_in_cam <id>.txt dir")
    p.add_argument("--model", required=True, help=".xyz or .obj model points")
    p.add_argument("--class_name", required=True, choices=SYNSET_NAMES[1:])
    p.add_argument("--handle_visibility", type=int, default=1)
    p.add_argument("--noise_trans", type=float, default=0.02,
                   help="init-pose translation noise (reference default 0.02)")
    p.add_argument("--noise_rot_deg", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    bbox = model_bbox_corners(load_model_points(args.model))
    gt_ids, gts = _load_pose_dir(args.gt_dir)
    pred_ids, preds = _load_pose_dir(args.pred_dir)
    common = [i for i in gt_ids if i in preds]
    if not common:
        raise SystemExit("no overlapping frame ids between pred and gt dirs")

    pred_seq = [preds[i] for i in common]
    gt_seq = [gts[i] for i in common]
    if args.noise_trans > 0 or args.noise_rot_deg > 0:
        rng = np.random.RandomState(args.seed)
        noisy_init = perturb_init_pose(gt_seq[0], args.noise_trans, args.noise_rot_deg, rng)
        pred_seq = reanchor_trajectory(pred_seq, noisy_init)

    result = evaluate_nocs(pred_seq, gt_seq, bbox, args.class_name, args.handle_visibility)
    result["missing"] = len(gt_ids) - len(common)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
