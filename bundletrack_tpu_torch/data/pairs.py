"""Training pairs and clips: ground-truth warp fields from depth and pose.

The port's own copy of bundletrack_tpu/data/pairs.py (the reference builds
LF-Net's training pairs the same way, lf-net-release/train_lfnet.py, and
trains VOS on labelled clips, transductive-vos.pytorch/main.py): the warp
field `eval/frontend_eval` scores keypoints against, the LF-Net pair
batches and the VOS clip batches of the trainers.  Host-side numpy; it
rounds, clips and draws its random numbers on the host exactly as the JAX
package does, so both give the same arrays.
"""

from __future__ import annotations

import numpy as np


def warp_field_from_depth(
    depth1: np.ndarray,
    K: np.ndarray,
    ob_in_cam1: np.ndarray,
    ob_in_cam2: np.ndarray,
    depth2: np.ndarray | None = None,
    mask1: np.ndarray | None = None,
    occlusion_tol: float = 0.02,
):
    """Per-pixel correspondence field frame1 -> frame2.

    For each pixel of frame 1 with valid depth: unproject with K, move the
    point from camera-1 to camera-2 through the object poses
    (p2 = ob_in_cam2 @ ob_in_cam1^-1 @ p1 — the object is rigid, the camera
    moves), and project into frame 2.  Validity requires: valid source depth,
    the target landing inside the image, and (when depth2 is given) the
    projected depth agreeing with frame 2's depth within `occlusion_tol`
    meters (occlusion check).

    Returns (warp12 [H, W, 2] float32 xy, valid [H, W] bool).
    """
    H, W = depth1.shape
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    z = depth1.astype(np.float32)
    valid = z > 0
    if mask1 is not None:
        valid &= mask1.astype(bool)

    x = (u - K[0, 2]) / K[0, 0] * z
    y = (v - K[1, 2]) / K[1, 1] * z
    p1 = np.stack([x, y, z], axis=-1)  # [H, W, 3] in cam-1

    T21 = ob_in_cam2 @ np.linalg.inv(ob_in_cam1)
    p2 = p1 @ T21[:3, :3].T + T21[:3, 3]
    z2 = p2[..., 2]
    valid &= z2 > 1e-6
    z2s = np.where(z2 > 1e-6, z2, 1.0)
    u2 = p2[..., 0] / z2s * K[0, 0] + K[0, 2]
    v2 = p2[..., 1] / z2s * K[1, 1] + K[1, 2]
    inside = (u2 >= 0) & (u2 <= W - 1) & (v2 >= 0) & (v2 <= H - 1)
    valid &= inside

    if depth2 is not None:
        ui = np.clip(np.round(u2).astype(np.int32), 0, W - 1)
        vi = np.clip(np.round(v2).astype(np.int32), 0, H - 1)
        d2 = depth2[vi, ui]
        valid &= (d2 > 0) & (np.abs(d2 - z2) < occlusion_tol)

    warp = np.stack([u2, v2], axis=-1).astype(np.float32)
    warp = np.where(valid[..., None], warp, 0.0)
    return warp, valid


def lfnet_pair_batch(seq, frame_pairs):
    """Build LFNetTrainBatch arrays from a SyntheticSequence.

    frame_pairs: list of (i, j) index pairs; each contributes one batch row
    (img1=frame i, img2=frame j, warp from depth_i + relative pose).
    Returns dict of numpy arrays matching models.LFNetTrainBatch fields.
    """
    img1, img2, warps, valids = [], [], [], []
    for i, j in frame_pairs:
        w, val = warp_field_from_depth(
            seq.depth[i], seq.K, seq.ob_in_cam[i], seq.ob_in_cam[j],
            depth2=seq.depth[j], mask1=seq.mask[i],
        )
        img1.append(seq.gray[i][..., None])
        img2.append(seq.gray[j][..., None])
        warps.append(w)
        valids.append(val)
    return {
        "img1": np.stack(img1).astype(np.float32),
        "img2": np.stack(img2).astype(np.float32),
        "warp12": np.stack(warps),
        "warp_valid": np.stack(valids),
    }


def _clean_channels(seq):
    """(gray, depth, mask) with GROUND-TRUTH depth/mask when the sequence
    carries degraded sensing (data/hard_world.HardSequence) — training
    correspondence must come from exact geometry, not simulated sensor
    noise (3 mm depth noise alone is ~3 px of reprojection error)."""
    depth = getattr(seq, "depth_gt", None)
    mask = getattr(seq, "mask_gt", None)
    return (
        seq.gray,
        depth if depth is not None else seq.depth,
        mask if mask is not None else seq.mask,
    )


def _roi_square(mask: np.ndarray):
    """Mask ROI -> (umin, vmin, side) of the square crop box (mirrors
    ops/resize.crop_resize_square: side = max(w, h), anchored at the ROI's
    top-left, matching the serving-path affine exactly).  An empty mask
    (full occlusion / degraded segmentation) falls back to the full frame."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return 0, 0, max(mask.shape)
    umin, umax = int(xs.min()), int(xs.max())
    vmin, vmax = int(ys.min()), int(ys.max())
    side = max(umax - umin + 1, vmax - vmin + 1)
    return umin, vmin, side


def _crop_resize_np(img: np.ndarray, umin: int, vmin: int, side: int, out: int):
    """Host-side bilinear equivalent of crop_resize_square for [H, W] f32."""
    H, W = img.shape
    s = out / side
    xs = umin + np.arange(out, dtype=np.float32) / s
    ys = vmin + np.arange(out, dtype=np.float32) / s
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    p00 = img[y0[:, None], x0[None, :]]
    p01 = img[y0[:, None], x1[None, :]]
    p10 = img[y1[:, None], x0[None, :]]
    p11 = img[y1[:, None], x1[None, :]]
    return (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    ).astype(np.float32)


def lfnet_roi_pair_batch(
    seq,
    frame_pairs,
    out_size: int,
    rng: np.random.RandomState | None = None,
    photometric: bool = True,
):
    """Serving-faithful LF-Net training rows: ROI crops + composed warps.

    The serving pipeline feeds the net the mask-ROI crop resized to
    cfg.input_size (frontend/pipeline.py:74-79, mirroring the reference's
    crop->square->400x400 chain, src/FeatureManager.cpp:851-884).  Training
    on full frames creates a train/serve scale mismatch; this function crops
    each frame exactly like serving and composes the ground-truth warp
    through both crop affines, so the descriptor trains on the distribution
    it will see.  Optional photometric augmentation (gain/bias/noise) per
    crop teaches brightness robustness.
    """
    gray_all, depth_all, mask_all = _clean_channels(seq)
    img1, img2, warps, valids = [], [], [], []
    for i, j in frame_pairs:
        w_full, val_full = warp_field_from_depth(
            depth_all[i], seq.K, seq.ob_in_cam[i], seq.ob_in_cam[j],
            depth2=depth_all[j], mask1=mask_all[i],
        )
        u1, v1, s1side = _roi_square(mask_all[i])
        u2, v2, s2side = _roi_square(mask_all[j])
        s1 = out_size / s1side
        s2 = out_size / s2side
        # masked crops: the serving path blanks background before the net
        # (frontend/pipeline.py, reference Frame::invalidatePixelsByMask)
        g_i = np.where(mask_all[i], gray_all[i], 0.0).astype(np.float32)
        g_j = np.where(mask_all[j], gray_all[j], 0.0).astype(np.float32)
        c1 = _crop_resize_np(g_i, u1, v1, s1side, out_size)
        c2 = _crop_resize_np(g_j, u2, v2, s2side, out_size)
        # compose: crop1 px -> orig1 -> warp -> orig2 -> crop2 px
        xs = u1 + np.arange(out_size, dtype=np.float32) / s1
        ys = v1 + np.arange(out_size, dtype=np.float32) / s1
        H, W = mask_all[i].shape
        # bilinear sample of the full-res warp field at the fractional crop
        # coordinates (nearest rounding adds up to ~0.5*s2 px of error to the
        # InfoNCE positives when the ROI is upscaled); validity requires all
        # four taps valid so interpolation never mixes invalid correspondences
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
        x1b = np.minimum(x0 + 1, W - 1)
        y1b = np.minimum(y0 + 1, H - 1)
        fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
        fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
        w_c = (
            w_full[y0[:, None], x0[None, :]] * (1 - fx) * (1 - fy)
            + w_full[y0[:, None], x1b[None, :]] * fx * (1 - fy)
            + w_full[y1b[:, None], x0[None, :]] * (1 - fx) * fy
            + w_full[y1b[:, None], x1b[None, :]] * fx * fy
        )  # [out, out, 2] orig2 coords
        val_c = (
            val_full[y0[:, None], x0[None, :]]
            & val_full[y0[:, None], x1b[None, :]]
            & val_full[y1b[:, None], x0[None, :]]
            & val_full[y1b[:, None], x1b[None, :]]
        )
        wx = (w_c[..., 0] - u2) * s2
        wy = (w_c[..., 1] - v2) * s2
        inside = (wx >= 0) & (wx <= out_size - 1) & (wy >= 0) & (wy <= out_size - 1)
        warp_c = np.stack([wx, wy], axis=-1).astype(np.float32)
        val_c = val_c & inside
        warp_c = np.where(val_c[..., None], warp_c, 0.0)
        if photometric and rng is not None:
            m1c = _crop_resize_np(
                mask_all[i].astype(np.float32), u1, v1, s1side, out_size) > 0.5
            m2c = _crop_resize_np(
                mask_all[j].astype(np.float32), u2, v2, s2side, out_size) > 0.5
            for c, mc in ((c1, m1c), (c2, m2c)):
                gain = 0.75 + 0.5 * rng.rand()
                bias = 0.1 * (rng.rand() - 0.5)
                c *= gain
                c += bias + (0.015 * rng.randn(*c.shape)).astype(np.float32)
                np.clip(c, 0.0, 1.0, out=c)
                c *= mc  # background stays blank, as served
        img1.append(c1[..., None])
        img2.append(c2[..., None])
        warps.append(warp_c)
        valids.append(val_c)
    return {
        "img1": np.stack(img1).astype(np.float32),
        "img2": np.stack(img2).astype(np.float32),
        "warp12": np.stack(warps),
        "warp_valid": np.stack(valids),
    }


def vos_clip_batch(seq, clip_starts, clip_len: int, stride: int = 1):
    """Build VOSTrainBatch arrays (clips + 0/1 labels from the object mask).

    Labels come from the EXACT mask when the sequence carries degraded
    sensing (HardSequence.mask_gt) — the net must learn the true silhouette,
    not the simulated VOS failure modes.

    `stride` subsamples the clip (frames s, s+stride, ...): at inference the
    sparse reference memory holds frames up to ~40 frames old
    (reference lib/predict.py:63-78), so training must expose the attention
    to large appearance gaps, not just consecutive frames."""
    _, _, mask = _clean_channels(seq)
    clips, labels = [], []
    for s in clip_starts:
        idx = s + stride * np.arange(clip_len)
        idx = np.clip(idx, 0, seq.gray.shape[0] - 1)
        g = seq.gray[idx]
        clips.append(np.repeat(g[..., None], 3, axis=-1))
        labels.append(mask[idx].astype(np.int32))
    return {
        "clips": np.stack(clips).astype(np.float32),
        "labels": np.stack(labels),
    }
