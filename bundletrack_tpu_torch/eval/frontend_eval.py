"""Frontend quality metrics: detector repeatability + matching inlier rate.

Counterpart of bundletrack_tpu/eval/frontend_eval.py.  The reference never
evaluates its keypoint frontend in isolation (LF-Net quality is validated
end-to-end through pose accuracy); these metrics make frontends comparable
directly, using the ground-truth correspondence fields the synthetic
renderers provide (reference analog: the repeatability / matching
objectives LF-Net is trained on, lf-net-release/train_lfnet.py).

  * repeatability: fraction of frame-i keypoints (valid + GT-warpable) whose
    warped location lies within eps_px of some detected frame-j keypoint.
  * inlier rate: fraction of mutual-NN descriptor matches consistent with
    the ground-truth warp within eps_px.

Host-side numpy around one feature extraction per frame, which runs on the
card unless `device` says otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bundletrack_tpu_torch.config import FrontendConfig
from bundletrack_tpu_torch.data.pairs import warp_field_from_depth
from bundletrack_tpu_torch.device import resolve_device
from bundletrack_tpu_torch.frontend.pipeline import extract_frame_features
from bundletrack_tpu_torch.ops.pointcloud import depth_to_cloud_and_normals


def make_feature_fn(cfg: FrontendConfig, lfnet_apply=None):
    """(gray, depth, mask, K) tensors -> FrameFeatures at full resolution."""

    @torch.no_grad()
    def fn(gray, depth, mask, K):
        pts, nrm, val = depth_to_cloud_and_normals(depth, K)
        return extract_frame_features(gray, mask, pts, nrm, val & mask, cfg, lfnet_apply)

    return fn


def _pair_metrics(fa, fb, warp, warp_valid, eps_px: float):
    """Metrics for one (frame a -> frame b) pair; all numpy."""
    uv_a = np.asarray(fa.uv)
    uv_b = np.asarray(fb.uv)
    val_a = np.asarray(fa.valid)
    val_b = np.asarray(fb.valid)
    H, W = warp_valid.shape

    ui = np.clip(np.round(uv_a[:, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(uv_a[:, 1]).astype(int), 0, H - 1)
    warped = warp[vi, ui]  # [N, 2] location in frame b
    warpable = val_a & warp_valid[vi, ui]

    if warpable.sum() == 0 or val_b.sum() == 0:
        return dict(repeatability=0.0, inlier_rate=0.0, n_matches=0)

    d2 = np.sum(
        (warped[:, None, :] - uv_b[None, :, :]) ** 2, axis=-1
    )  # [Na, Nb]
    d2[:, ~val_b] = np.inf
    nearest = np.sqrt(d2.min(axis=1))
    repeat = float((nearest[warpable] < eps_px).mean())

    # mutual-NN descriptor matching
    da = np.asarray(fa.desc, np.float32)
    db = np.asarray(fb.desc, np.float32)
    dist = (
        np.sum(da * da, -1)[:, None]
        - 2.0 * (da @ db.T)
        + np.sum(db * db, -1)[None, :]
    )
    dist[~val_a] = np.inf
    dist[:, ~val_b] = np.inf
    ab = dist.argmin(axis=1)
    ba = dist.argmin(axis=0)
    mutual = (ba[ab] == np.arange(len(da))) & val_a & val_b[ab] & warpable
    n_matches = int(mutual.sum())
    if n_matches == 0:
        return dict(repeatability=repeat, inlier_rate=0.0, n_matches=0)
    err = np.linalg.norm(warped[mutual] - uv_b[ab[mutual]], axis=-1)
    inlier = float((err < eps_px).mean())
    return dict(repeatability=repeat, inlier_rate=inlier, n_matches=n_matches)


def evaluate_frontend(
    seq,
    cfg: FrontendConfig,
    lfnet_apply=None,
    gap: int = 1,
    eps_px: float = 3.0,
    max_pairs: Optional[int] = None,
    device=None,
):
    """Average repeatability / inlier rate over (i, i+gap) pairs of `seq`.

    Returns dict(repeatability, inlier_rate, n_matches) averaged over pairs.
    """
    dev = resolve_device(device)
    fn = make_feature_fn(cfg, lfnet_apply)
    F = seq.gray.shape[0]

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    K = up(seq.K, np.float32)
    feats = []
    for i in range(F):
        f = fn(up(seq.gray[i], np.float32), up(seq.depth[i], np.float32), up(seq.mask[i], bool), K)
        feats.append(type(f)(*((t.float() if t.is_floating_point() else t).cpu().numpy() for t in f)))
    pairs = [(i, i + gap) for i in range(F - gap)]
    if max_pairs:
        pairs = pairs[:max_pairs]
    rows = []
    for i, j in pairs:
        warp, wvalid = warp_field_from_depth(
            seq.depth[i], seq.K, seq.ob_in_cam[i], seq.ob_in_cam[j],
            depth2=seq.depth[j], mask1=seq.mask[i],
        )
        rows.append(_pair_metrics(feats[i], feats[j], warp, wvalid, eps_px))
    return {
        "repeatability": float(np.mean([r["repeatability"] for r in rows])),
        "inlier_rate": float(np.mean([r["inlier_rate"] for r in rows])),
        "n_matches": float(np.mean([r["n_matches"] for r in rows])),
    }
