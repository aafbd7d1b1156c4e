"""VOS propagation quality: mask IoU over a sequence.

Counterpart of bundletrack_tpu/eval/vos_eval.py.  The reference reports
DAVIS J (region IoU) for its VOS subproject
(transductive-vos.pytorch/README.md:18-24); this is the same measure over a
sequence with ground-truth masks: initialise from frame 0's mask, propagate
through the remaining frames, score the IoU of each frame.
"""

from __future__ import annotations

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, b).sum() / union)


def rgb_of(seq, f: int) -> np.ndarray:
    """Frame f of a gray sequence as the [H, W, 3] image in [0, 1] VOS takes."""
    return np.repeat(seq.gray[f][..., None], 3, axis=-1)


def evaluate_vos(model, seg_cfg, seq, num_frames: int = 0, history_cap: int | None = None,
                 device=None):
    """Propagate seq.mask[0] through the seq.gray frames; returns
    dict(mean_iou, min_iou, per_frame list, and for frames 1.. the masks
    [H, W] bool and the soft labels [L, h, w] as numpy arrays).

    seq: gray [F, H, W] in [0, 1], mask [F, H, W] bool.  A sequence with a
    `mask_gt` (the hard renderer's exact silhouette, beside a mask degraded
    to mimic VOS failures) is scored against, and seeded from, `mask_gt`.
    Runs on the card unless `device` says otherwise."""
    from bundletrack_tpu_torch.models.vos import VOSPropagator

    masks = getattr(seq, "mask_gt", None)
    if masks is None:
        masks = seq.mask
    F, H, W = seq.gray.shape
    n = min(num_frames or F, F)
    if n < 2:
        raise ValueError(
            f"evaluate_vos needs >= 2 frames to propagate (got n={n}); frame 0 only seeds the history"
        )
    prop = VOSPropagator(model, seg_cfg, H, W, history_cap=history_cap, device=device)
    prop.first_frame(rgb_of(seq, 0), np.asarray(masks[0], bool))
    out, soft = [], []
    for f in range(1, n):
        mask, s = prop.step(rgb_of(seq, f))
        out.append(mask.cpu().numpy())
        soft.append(s.cpu().numpy())
    ious = [mask_iou(m, masks[f]) for f, m in enumerate(out, start=1)]
    return {"mean_iou": float(np.mean(ious)), "min_iou": float(np.min(ious)), "per_frame": ious,
            "masks": out, "soft": soft}
