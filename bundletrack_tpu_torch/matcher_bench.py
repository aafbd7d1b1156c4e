"""The BA matcher at the main path's shapes, on the card.

    python3 -m bundletrack_tpu_torch.matcher_bench [--tree DIR] [--runs 25]

`ba_table` builds the table that the tracker matches at full width: the
keypoints of the first K=16 frames of the rendered 480x640 sequence
(default TrackerConfig: N=512, D=256) through the port's own preprocess
and frontend, in the model frame of their true poses, with all 120 pairs.
`chip_smoke.py` holds the kernel to its plain version on it.

Run as a module, it times the matcher's kernels on that table and prints
one JSON line:
- CUDA events, median of --runs calls after warm-up, of the kernel launch
  alone and of the wrapper;
- torch.profiler's device time of each kernel that one launch runs, per
  launch, over 3 launches;
- the device time of the same kernels inside 3 profiled tracker frames
  after 5 warm-up frames, per frame.
--tree DIR imports `bundletrack_tpu_torch` from another checkout, so that
one chip call can time two versions in turns.  Where that checkout's
matcher takes the gathered [P,N,D] sides (it has no
`fused_mutual_match_pairs`), its launch is timed on the operands its
wrapper prepares, prepared beforehand.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys

import numpy as np
import torch

TRACKER_WARMUP, PROFILED = 5, 3


def ba_table(seq, cfg, device, lfnet_apply=None):
    """((desc [K,N,D], world [K,N,3], wnrm [K,N,3], valid [K,N]), (pair_i, pair_j) int32)
    for the first K = cfg.bundle.max_ba_frames frames of `seq`, through the
    frontend cfg.frontend.kind (LF-Net needs `lfnet_apply`)."""
    from bundletrack_tpu_torch.frontend.pipeline import extract_frame_features
    from bundletrack_tpu_torch.geometry.se3 import transform_normals, transform_points
    from bundletrack_tpu_torch.tracker.bundler import _normalize_obs, _preprocess
    from bundletrack_tpu_torch.tracker.state import FrameObservation

    K_BA = cfg.bundle.max_ba_frames
    intr = torch.as_tensor(seq.K, device=device)
    feats = []
    for f in range(K_BA):
        obs = _normalize_obs(FrameObservation(
            gray=torch.as_tensor(seq.gray[f], device=device),
            depth=torch.as_tensor(seq.depth[f], device=device),
            mask=torch.as_tensor(seq.mask[f], device=device),
            K=intr,
        ))
        mask, pts_map, nrm_map, val_map, _, _ = _preprocess(obs, cfg)
        feats.append(extract_frame_features(obs.gray, mask, pts_map, nrm_map, val_map, cfg.frontend,
                                            lfnet_apply))
    desc, pts, nrm, valid = (torch.stack([getattr(ff, k) for ff in feats])
                             for k in ("desc", "pts", "normals", "valid"))
    poses = torch.as_tensor(np.linalg.inv(seq.ob_in_cam[:K_BA]), device=device)  # cam -> model
    pairs = tuple(torch.as_tensor(a.astype(np.int32), device=device)
                  for a in np.triu_indices(K_BA, k=1))
    return (desc, transform_points(poses, pts), transform_normals(poses, nrm), valid), pairs


def _use_tree(tree: str):
    """Import `bundletrack_tpu_torch` from `tree` from now on."""
    for name in [m for m in sys.modules if m.split(".")[0] == "bundletrack_tpu_torch"]:
        if name != __name__:
            del sys.modules[name]
    sys.path.insert(0, tree)


def _cuda_median_ms(fn, runs: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms_by_kernel(fn, calls: int):
    """torch.profiler's device time of each CUDA kernel over `calls` calls of fn."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] += e.time_range.elapsed_us() / 1e3
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default="", help="checkout to import bundletrack_tpu_torch from")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("matcher_bench: no CUDA device is available")
    if args.tree:
        _use_tree(os.path.abspath(args.tree))

    import bundletrack_tpu_torch
    from bundletrack_tpu_torch.cardrun import H, W, card_line, render_main_sequence
    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.kernels import matching as km
    from bundletrack_tpu_torch.tracker.driver import Tracker

    card = card_line()
    cfg = TrackerConfig()
    seq = render_main_sequence(cfg.bundle.max_ba_frames)
    (desc, world, wnrm, valid), (pi, pj) = ba_table(seq, cfg, torch.device("cuda"))
    fc = cfg.feature_corres
    gates = dict(max_dist=fc.max_dist_no_neighbor, max_normal_deg=fc.max_normal_no_neighbor)
    if hasattr(km, "fused_mutual_match_pairs"):
        design = "table form: fused_mutual_match_pairs on the [K,N,D] table"
        wrapper = lambda: km.fused_mutual_match_pairs(desc, world, wnrm, valid, pi, pj, **gates)  # noqa: E731
        launch = wrapper
    else:
        design = "gathered sides: fused_mutual_match on [P,N,D] copies"
        pl = pi.long()
        pr = pj.long()
        sides = (desc[pl], desc[pr], world[pl], world[pr], wnrm[pl], wnrm[pr], valid[pl], valid[pr])
        wrapper = lambda: km.fused_mutual_match(*sides, **gates)  # noqa: E731
        prepared = km._prepare(*sides, gates["max_dist"], gates["max_normal_deg"])
        launch = lambda: km._launch(*prepared)  # noqa: E731

    launch_ms = _cuda_median_ms(launch, args.runs)
    wrapper_ms = _cuda_median_ms(wrapper, args.runs)
    per_kernel = _device_ms_by_kernel(launch, PROFILED)
    per_launch = {name: ms / PROFILED for name, ms in per_kernel.items()}

    tracker = Tracker(cfg, H, W)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])
    frames = range(TRACKER_WARMUP + PROFILED)

    def track(fs):
        for f in fs:
            tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)

    track(frames[:TRACKER_WARMUP])
    in_frames = _device_ms_by_kernel(lambda: track(frames[TRACKER_WARMUP:]), 1)
    tracker_ms = sum(in_frames[name] for name in per_kernel) / PROFILED

    print(f"card: {card}")
    print(f"tree: {os.path.dirname(os.path.dirname(os.path.abspath(bundletrack_tpu_torch.__file__)))}")
    print(f"design: {design}")
    print(f"CUDA events, median of {args.runs}: launch {launch_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms")
    for name, ms in sorted(per_launch.items(), key=lambda kv: -kv[1]):
        print(f"  profiler {ms:.4f} ms per launch  {name[:100]}")
    print(f"profiler: all passes {sum(per_launch.values()):.4f} ms per launch; "
          f"{tracker_ms:.4f} ms per tracked frame over {PROFILED} frames")
    print(json.dumps({
        "card": card,
        "design": design,
        "shapes": dict(K=int(desc.shape[0]), P=int(pi.shape[0]), N=int(desc.shape[1]), D=int(desc.shape[2])),
        "launch_ms_median": launch_ms,
        "wrapper_ms_median": wrapper_ms,
        "profiler_ms_per_launch": per_launch,
        "profiler_all_passes_ms_per_launch": sum(per_launch.values()),
        "profiler_matcher_ms_per_tracked_frame": tracker_ms,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
