"""Hard-world evaluation suites: ADD-S AUC over hostile synthetic passes.

Counterpart of bundletrack_tpu/eval/hard_suite.py.  Runs the tracker over
the hard passes (data/hard_world.py: multi-shape, degraded depth, imperfect
masks, scale change, fast rotation) and scores each against ground truth
with the reference's ADD-S AUC protocol (reference:
scripts/eval_ycbineoat.py:54-83 + scripts/Utils.py:69-95); and the
long-horizon passes with a drift and status report per pass, optionally
re-tracked on masks that the VOS network propagates online.  Tracking runs
on the card unless `device` says otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from bundletrack_tpu_torch.data.hard_world import hard_passes, long_hard_passes, model_points
from bundletrack_tpu_torch.eval.metrics import adds_auc, pose_errors
from bundletrack_tpu_torch.eval.vos_eval import mask_iou
from bundletrack_tpu_torch.tracker.driver import track_sequence

# shape used by each named pass (for the ADD-S model point cloud)
PASS_SHAPES = {
    "cube": "cube",
    "cylinder": "cylinder",
    "lshape": "lshape",
    "scale2x": "lshape",
    "fastrot": "lshape",
}
LONG_PASS_SHAPES = {"orbit": "lshape", "occluder": "cube", "scale2x": "lshape"}


def evaluate_pass(cfg, seq, shape: str, lfnet_apply=None, size: float = 0.2, device=None):
    """Track one hard sequence; returns (auc, n_bad_statuses)."""
    poses, statuses, _ = track_sequence(cfg, seq, lfnet_apply=lfnet_apply, device=device)
    pts = model_points(shape, size=size)
    auc = adds_auc(list(poses), list(seq.ob_in_cam), pts)
    return float(auc), int(np.sum(statuses != 0))


def run_hard_suite(
    cfg,
    lfnet_apply=None,
    H: int = 480,
    W: int = 640,
    num_frames: int = 20,
    seed: int = 0,
    passes: Optional[Dict] = None,
    device=None,
) -> Dict[str, float]:
    """Returns {pass_name: adds_auc, ..., "mean": mean_auc}.

    `passes` lets the caller pre-render (and share between frontends).
    """
    if passes is None:
        passes = hard_passes(H=H, W=W, num_frames=num_frames, seed=seed)
    out = {}
    for name, seq in passes.items():
        auc, _ = evaluate_pass(cfg, seq, PASS_SHAPES.get(name, "cube"), lfnet_apply=lfnet_apply,
                               device=device)
        out[name] = round(auc, 2)
    out["mean"] = round(float(np.mean([v for k, v in out.items() if k != "mean"])), 2)
    return out


def pass_report(poses, statuses, seq, shape: str, size: float = 0.2) -> Dict:
    """ADD-S AUC plus the drift/failure summary for one tracked pass."""
    pts = model_points(shape, size=size)
    errs_r, errs_t = [], []
    for p, g in zip(poses, seq.ob_in_cam):
        r, t = pose_errors(np.asarray(p), np.asarray(g))
        errs_r.append(r)
        errs_t.append(t)
    errs_r = np.asarray(errs_r)
    errs_t = np.asarray(errs_t)
    st = np.asarray(statuses)
    return {
        "adds_auc": round(float(adds_auc(list(poses), list(seq.ob_in_cam), pts)), 2),
        "frames": int(len(st)),
        "mean_trans_err_mm": round(1e3 * float(errs_t.mean()), 2),
        "max_trans_err_mm": round(1e3 * float(errs_t.max()), 2),
        # tail error ~= where the run ENDED: small tail after a mid-run
        # failure means the tracker re-acquired instead of drifting away
        "tail10_trans_err_mm": round(1e3 * float(errs_t[-10:].mean()), 2),
        "mean_rot_err_deg": round(float(errs_r.mean()), 2),
        "max_rot_err_deg": round(float(errs_r.max()), 2),
        "n_fail": int((st == 1).sum()),
        "n_no_ba": int((st == 2).sum()),
    }


def generate_vos_masks(seq, model, seg_cfg, work_hw=(96, 96), device=None):
    """Run the VOS propagator over a sequence to produce the tracker's masks
    (the reference's deployment: transductive-vos run_video.py writes mask
    PNGs that Frame::segmentationByMaskFile consumes, src/Frame.cpp:236-319).

    `model` is the VOSNet with its weights (models/vos.load_vos_npz).  VOS
    runs at `work_hw` on frames downscaled by nearest index, square by
    default, the training frame shape; its masks go back up to the
    sequence's resolution by nearest index.  Frame 0 uses the sequence's own
    init mask, the protocol's single ground-truth input.
    """
    from bundletrack_tpu_torch.models.vos import VOSPropagator

    F, H, W = seq.gray.shape
    h, w = work_hw
    yi = (np.arange(h) * H // h).clip(0, H - 1)
    xi = (np.arange(w) * W // w).clip(0, W - 1)
    yo = (np.arange(H) * h // H).clip(0, h - 1)
    xo = (np.arange(W) * w // W).clip(0, w - 1)

    def down(img):
        return img[yi[:, None], xi[None, :]]

    def up(m):
        return m[yo[:, None], xo[None, :]]

    def rgb(f):
        return np.repeat(down(seq.gray[f])[..., None], 3, axis=-1)

    prop = VOSPropagator(model, seg_cfg, h, w, device=device)
    init_mask = np.asarray(seq.mask[0], bool)
    prop.first_frame(rgb(0), down(init_mask))
    masks = [init_mask]
    for f in range(1, F):
        masks.append(up(prop.propagate(rgb(f))))
    return np.stack(masks)


def run_long_suite(
    cfg,
    lfnet_apply=None,
    H: int = 480,
    W: int = 640,
    num_frames: int = 128,
    seed: int = 0,
    passes: Optional[Dict] = None,
    vos_ckpt: Optional[str] = None,
    device=None,
) -> Dict[str, Dict]:
    """Track every long pass; returns {"passes": {pass: report},
    "mean_adds_auc": mean}.

    With `vos_ckpt` (an npz of VOSNet weights), adds an "orbit_vosmask"
    pass: the orbit pass re-tracked with masks generated online by the VOS
    network (only frame 0's mask is ground-truth-derived), the full
    deployment loop of the reference.
    """
    if passes is None:
        passes = long_hard_passes(H=H, W=W, num_frames=num_frames, seed=seed)
    out = {}
    for name, seq in passes.items():
        poses, statuses, _ = track_sequence(cfg, seq, lfnet_apply=lfnet_apply, device=device)
        out[name] = pass_report(poses, statuses, seq, LONG_PASS_SHAPES.get(name, "cube"))
    if vos_ckpt is not None:
        from bundletrack_tpu_torch.config import SegmentationConfig
        from bundletrack_tpu_torch.models.vos import load_vos_npz

        model, _ = load_vos_npz(vos_ckpt)
        seq = passes["orbit"]
        # long pass -> widen the sparse-reference window to the whole arc
        seg_cfg = SegmentationConfig().long_range(len(seq.gray))
        vos_masks = generate_vos_masks(seq, model, seg_cfg, device=device)
        poses, statuses, _ = track_sequence(cfg, seq._replace(mask=vos_masks), lfnet_apply=lfnet_apply,
                                            device=device)
        rep = pass_report(poses, statuses, seq, LONG_PASS_SHAPES["orbit"])
        # VOS mask quality alongside, against the exact silhouette
        gt = getattr(seq, "mask_gt", seq.mask)
        ious = [mask_iou(vos_masks[f], gt[f]) for f in range(1, len(vos_masks))]
        rep["vos_mask_mean_iou"] = round(float(np.mean(ious)), 3)
        rep["vos_mask_min_iou"] = round(float(np.min(ious)), 3)
        out["orbit_vosmask"] = rep
    out_mean = float(np.mean([r["adds_auc"] for r in out.values()]))
    return {"passes": out, "mean_adds_auc": round(out_mean, 2)}
