"""The long-horizon suite replayed on the JAX tracker's own RANSAC draws.

Re-acquisition and drift on the hostile long passes depend on the RANSAC
draws, and the port's trackers draw from `torch.Generator`, not JAX's
threefry.  The JAX tracker splits its key the same way on every frame,
whatever the data, so its draws depend only on its seed and on
(max_matches, ransac.max_iter, bundle.max_ba_frames): `jax_draws_seed0.npz`
holds those of a JAX `Tracker` seeded with 0 at bench.py's (256, 2000, 16)
for 128 frames, as uint8 (every phase lies in [0, 256)).  With them the
port tracks a pass on the JAX tracker's draws, and its reports can be held
to the JAX package's figures pass for pass.

`replay_long_suite` tracks the passes as `hard_suite.run_long_suite` does
(its pass order and `LONG_PASS_SHAPES`, `pass_report`, the VOS orbit on
`generate_vos_masks` with `SegmentationConfig().long_range`), each frame
given its draws through `Tracker.process_frame(..., phases=)`.  Tracking
runs on the card unless `device` says otherwise.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from bundletrack_tpu_torch.eval.hard_suite import LONG_PASS_SHAPES, generate_vos_masks, pass_report

DRAWS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_draws_seed0.npz")


def load_jax_draws(cfg, num_frames: int, path: str = DRAWS_NPZ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The JAX tracker's phases for frames 0..num_frames-1, each frame's
    (neighbour [3, n_rep], BA pairs [P, 3, n_rep]) as int64, the form
    `Tracker.process_frame(..., phases=)` takes.  Raises if the file was
    drawn for another (M, max_iter, K), holds fewer frames or other shapes."""
    with np.load(path) as data:
        neighbour, pairs = data["neighbour"], data["pairs"]
        drawn_for = tuple(int(data[k]) for k in ("max_matches", "max_iter", "max_ba_frames"))
    M, K = cfg.shapes.max_matches, cfg.bundle.max_ba_frames
    want = (M, cfg.ransac.max_iter, K)
    if drawn_for != want:
        raise ValueError(f"{path} holds draws for (M, max_iter, K) = {drawn_for}, not {want}")
    if len(neighbour) < num_frames:
        raise ValueError(f"{path} holds {len(neighbour)} frames of draws, not {num_frames}")
    n_rep = -(-cfg.ransac.max_iter // M)
    if neighbour.shape[1:] != (3, n_rep) or pairs.shape[1:] != (K * (K - 1) // 2, 3, n_rep):
        raise ValueError(f"{path}: draws of shapes {neighbour.shape}, {pairs.shape}")
    return [(neighbour[f].astype(np.int64), pairs[f].astype(np.int64)) for f in range(num_frames)]


class PassRun(NamedTuple):
    poses: np.ndarray  # [F, 4, 4] ob_in_cam
    statuses: np.ndarray  # [F]
    num_ba_edges: np.ndarray  # [F]
    frame_ms: np.ndarray  # [F] host clock from the upload to the outputs read back


def replay_pass(cfg, seq, draws, lfnet_apply=None, device=None) -> PassRun:
    """Track `seq` as `track_sequence` does, frame f on draws[f].  A frame's
    ms ends when its outputs are read back, which waits for the device."""
    from bundletrack_tpu_torch.tracker.driver import Tracker

    F, H, W = seq.gray.shape
    tracker = Tracker(cfg, H, W, lfnet_apply=lfnet_apply, device=device)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    poses, statuses, edges, frame_ms = [], [], [], []
    for f in range(F):
        t0 = time.perf_counter()
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose, phases=draws[f])
        poses.append(out.ob_in_cam.cpu().numpy())
        statuses.append(int(out.status))
        edges.append(int(out.num_ba_edges))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    return PassRun(np.stack(poses), np.asarray(statuses), np.asarray(edges), np.asarray(frame_ms))


def replay_long_suite(cfg, passes: Dict, draws, lfnet_apply=None, vos_model=None, device=None) -> Dict:
    """`run_long_suite` on the given draws, with `vos_model` (a VOSNet with
    its weights) in place of its `vos_ckpt`.  Returns {"passes": {pass:
    report}, "mean_adds_auc": mean} as it does, and beside them "runs":
    {pass: PassRun} and, with `vos_model`, the "orbit_vosmask" pass's
    "vos_masks"."""
    reports, runs = {}, {}
    for name, seq in passes.items():
        runs[name] = replay_pass(cfg, seq, draws, lfnet_apply, device)
        reports[name] = pass_report(runs[name].poses, runs[name].statuses, seq, LONG_PASS_SHAPES.get(name, "cube"))
    out = {}
    if vos_model is not None:
        from bundletrack_tpu_torch.config import SegmentationConfig
        from bundletrack_tpu_torch.eval.vos_eval import mask_iou

        seq = passes["orbit"]
        seg_cfg = SegmentationConfig().long_range(len(seq.gray))
        vos_masks = generate_vos_masks(seq, vos_model, seg_cfg, device=device)
        runs["orbit_vosmask"] = replay_pass(cfg, seq._replace(mask=vos_masks), draws, lfnet_apply, device)
        run = runs["orbit_vosmask"]
        rep = pass_report(run.poses, run.statuses, seq, LONG_PASS_SHAPES["orbit"])
        gt = getattr(seq, "mask_gt", seq.mask)
        ious = [mask_iou(vos_masks[f], gt[f]) for f in range(1, len(vos_masks))]
        rep["vos_mask_mean_iou"] = round(float(np.mean(ious)), 3)
        rep["vos_mask_min_iou"] = round(float(np.min(ious)), 3)
        reports["orbit_vosmask"] = rep
        out["vos_masks"] = vos_masks
    mean = float(np.mean([r["adds_auc"] for r in reports.values()]))
    return {"passes": reports, "mean_adds_auc": round(mean, 2), "runs": runs, **out}
