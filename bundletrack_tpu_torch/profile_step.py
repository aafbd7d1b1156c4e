"""Where a tracker step's time goes, on the card.

    python3 -m bundletrack_tpu_torch.profile_step [--frames 20] [--out DIR]

Tracks a rendered 480x640 sequence with the default TrackerConfig and
reports, after warm-up:

- the wall time of each stage of the step (host clock, with the device
  synchronised before and after the stage, so launch overhead counts
  where it is spent), median over the steady frames;
- from torch.profiler over three steady frames: the device time of the
  kernels launched per frame, the ten largest, and the device's busy share
  of the frames' wall time;
- the device-to-host synchronisations of one tracked frame, counted by
  torch's sync debug mode, with the lines that make them.

The stages are timed by wrapping the functions the step calls; the step
itself carries no instrumentation.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import statistics
import time
import warnings

import numpy as np
import torch

from bundletrack_tpu_torch.cardrun import (
    WARMUP_FRAMES,
    H,
    W,
    card_line,
    render_main_sequence,
    steady_median,
    timed_frames,
)
from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.tracker import bundler
from bundletrack_tpu_torch.tracker.driver import Tracker

# step stages, by the name the step calls them under
STAGES = (
    "_preprocess",
    "extract_frame_features",
    "match_pair",
    "ransac_pair",
    "select_ba_subset",
    "match_pairs_batched",
    "propagate_matches",
    "merge_matches",
    "optimize_pose_graph_verified",
    "update_mappoints",
)


def _timed(name, fn, sink):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink[name] += (time.perf_counter() - t0) * 1e3
        return out

    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=WARMUP_FRAMES)
    ap.add_argument("--out", default="", help="directory for the profiler's chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    card = card_line()

    cfg = TrackerConfig()
    seq = render_main_sequence(args.frames)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])

    # pass 1: stage wall times
    per_frame, frame_ms = [], []
    sink = collections.defaultdict(float)
    originals = {name: getattr(bundler, name) for name in STAGES}
    for name, fn in originals.items():
        setattr(bundler, name, _timed(name, fn, sink))
    try:
        tracker = Tracker(cfg, H, W)
        for _, _, ms in timed_frames(tracker, seq, range(args.frames), init_pose):
            frame_ms.append(ms)
            per_frame.append(dict(sink))
            sink.clear()
    finally:
        for name, fn in originals.items():
            setattr(bundler, name, fn)
    steady = range(max(args.warmup, 1), args.frames)
    stage_ms = {
        name: statistics.median(per_frame[f].get(name, 0.0) for f in steady) for name in STAGES
    }
    frame_med = steady_median(frame_ms, steady.start)
    print(f"card: {card}")
    print(f"frame (stage timers on): median {frame_med:.2f} ms over frames {steady.start}..{args.frames - 1}")
    for name, ms in sorted(stage_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:30s} {ms:9.2f} ms  {100 * ms / frame_med:5.1f} %")
    print(f"  {'(rest of the step)':30s} {frame_med - sum(stage_ms.values()):9.2f} ms")

    # pass 2: device time under the profiler, three steady frames
    tracker = Tracker(cfg, H, W)
    n_prof = 3
    first = args.frames - n_prof
    for f in range(first):
        tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in range(first, args.frames):
            tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3  # overlap ignored
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        counts[e.name] += 1
    print(f"profiler: {n_prof} frames in {wall_ms:.2f} ms wall; device kernels {busy_ms:.2f} ms "
          f"({len(kernels) / n_prof:.0f} launches per frame); device busy {100 * busy_ms / wall_ms:.1f} % "
          f"[{card}]")
    top = by_name.most_common(10)
    for name, ms in top:
        print(f"  {ms / n_prof:9.3f} ms/frame  x{counts[name] // n_prof:<5d} {name[:90]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "profile_step_trace.json"))

    # pass 3: device-to-host synchronisations of one steady frame, as
    # torch's sync debug mode reports them (one warning per synchronising op)
    f = args.frames - 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename, os.path.dirname(__file__))}:{w.lineno}"
        for w in caught if "synchronizing" in str(w.message)
    )
    print(f"syncs: {sum(syncs.values())} device-to-host synchronisations in one tracked frame")
    for where, n in syncs.most_common():
        print(f"  x{n:<3d} {where}")
    print(json.dumps({
        "card": card,
        "frame_ms_median": frame_med,
        "stage_ms_median": stage_ms,
        "profiled_frames": n_prof,
        "profiled_wall_ms": wall_ms,
        "device_kernel_ms": busy_ms,
        "kernel_launches_per_frame": len(kernels) / n_prof,
        "top_kernels_ms_per_frame": {name: ms / n_prof for name, ms in top},
        "syncs_per_tracked_frame": sum(syncs.values()),
        "sync_sites": dict(syncs),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
