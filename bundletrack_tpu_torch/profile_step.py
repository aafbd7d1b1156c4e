"""Where a tracker step's time goes, on the card.

    python3 -m bundletrack_tpu_torch.profile_step [--frames 20] [--out DIR]
                                                  [--frontend classical|lfnet]

Tracks a rendered 480x640 sequence with the default TrackerConfig (with
--frontend lfnet, the LF-Net frontend on checkpoints/lfnet_params.npz) and
reports, after warm-up:

- the wall time of each stage of the step (host clock, with the device
  synchronised before and after the stage, so launch overhead counts
  where it is spent), median over the steady frames;
- from torch.profiler over three steady frames: the device time of the
  kernels launched per frame, the ten largest, and the device's busy share
  of the frames' wall time;
- the device-to-host synchronisations of one tracked frame, counted by
  torch's sync debug mode, with the lines that make them;
- with --frontend lfnet, the LF-Net forward alone at input_size: CUDA
  events (median of 25 after warm-up), launches, device time and the ten
  largest kernels from torch.profiler, its products counted from the
  shapes of one forward (convs, dense layers, resize products) and its
  least bytes, and the bound they give.

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
    TIMED_RUNS,
    WARMUP_FRAMES,
    H,
    W,
    card_line,
    cuda_median_ms,
    masked_crop,
    render_main_sequence,
    shipped_lfnet,
    steady_median,
    timed_frames,
    with_lfnet,
)
from bundletrack_tpu_torch.config import TrackerConfig
from bundletrack_tpu_torch.frontend import lfnet as lfnet_mod
from bundletrack_tpu_torch.tracker import bundler
from bundletrack_tpu_torch.tracker.driver import Tracker

# Published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores (TF32 is off in the port)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

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


def _kernel_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def lfnet_forward_cost(lfnet, crop) -> dict:
    """Products of one LF-Net forward, counted from the shapes it runs at
    (2 FLOP per multiply-add), by layer group and by the dtype they run in;
    and its least bytes: the crop and the weights read once, the outputs
    written once."""
    flops = collections.Counter()  # (group, dtype) -> FLOP

    def hook(group):
        def count(mod, inp, out):
            per_output = mod.weight[0].numel()  # cin * k * k for a conv, in for a dense layer
            flops[group, str(mod.dtype)] += 2 * out.numel() * per_output
        return count

    resize = lfnet_mod.resize_bilinear

    def counted_resize(img, out_hw):
        H, W = img.shape[-2:]
        bc = img.numel() // (H * W)
        oh, ow = out_hw
        macs = (oh * H * W if oh != H else 0) + (oh * W * ow if ow != W else 0)
        flops["resize", str(img.dtype)] += 2 * bc * macs
        return resize(img, out_hw)

    hooks = []
    for name, m in lfnet.named_modules():
        if isinstance(m, (lfnet_mod.Conv, lfnet_mod.Dense)):
            part = "detector" if ".detector." in f".{name}." else "descriptor"
            kind = "conv" if isinstance(m, lfnet_mod.Conv) else "dense"
            hooks.append(m.register_forward_hook(hook(f"{part} {kind}")))
    lfnet_mod.resize_bilinear = counted_resize
    try:
        out = lfnet(crop[..., None])
    finally:
        lfnet_mod.resize_bilinear = resize
        for h in hooks:
            h.remove()
    by_dtype = collections.Counter()
    for (_, dtype), n in flops.items():
        by_dtype[dtype] += n
    weights = sum(p.numel() * p.element_size() for p in lfnet.parameters())
    outputs = sum(t.numel() * t.element_size() for t in out)
    nbytes = crop.numel() * crop.element_size() + weights + outputs
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "bf16 products": by_dtype["torch.bfloat16"] / BF16_FLOP_PER_S * 1e3,
        "f32 products": by_dtype["torch.float32"] / F32_FLOP_PER_S * 1e3,
    }
    return {"flops": dict(by_dtype), "flops_by_group": {f"{g} {d}": n for (g, d), n in flops.items()},
            "bytes": nbytes, "bound_terms_ms": terms,
            "bound_ms": max(terms.values()), "bound_by": max(terms, key=terms.get)}


# the sums kernel as the profiler names it (csrc/xla_order_sums.cu: one launch per call)
SUMS_KERNELS = ("xla_order_sums_kernel",)


def lfnet_forward_report(lfnet, cfg, seq, card: str) -> dict:
    """The LF-Net forward alone on frame 0's masked ROI crop."""
    S = cfg.frontend.input_size
    crop = masked_crop(seq, 0, S)
    fwd = lambda: lfnet(crop[..., None])  # noqa: E731
    ms = cuda_median_ms(fwd)
    n_prof = 3
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fwd()
        torch.cuda.synchronize()
    kernels = _kernel_events(prof)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_prof
    device_ms = sum(by_name.values())
    cost = lfnet_forward_cost(lfnet, crop)
    dtype = "bf16" if cfg.frontend.bf16 else "f32"
    print(f"lfnet forward at {S}x{S} {dtype}: median {ms:.4f} ms (CUDA events, {TIMED_RUNS} runs); "
          f"profiler {len(kernels) / n_prof:.0f} launches, {device_ms:.4f} ms device time per forward [{card}]")
    for name, t in by_name.most_common(10):
        print(f"  {t:9.4f} ms/forward  {name[:100]}")
    # the norm statistics' sums kernel (kernels/norm_sums.py) in the bf16 forward
    sums_ms = sum(t for name, t in by_name.items() if any(k in name for k in SUMS_KERNELS))
    sums_launches = sum(SUMS_KERNELS[-1] in e.name for e in kernels) / n_prof
    print(f"  sums kernel ({' + '.join(SUMS_KERNELS)}): {sums_launches:.0f} calls, {sums_ms:.4f} ms per forward, "
          f"{100 * sums_ms / max(device_ms, 1e-9):.1f} % of the device time")
    print("  products by group: " + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in cost["flops_by_group"].items())
          + " GFLOP")
    print(f"  products {', '.join(f'{k} {v / 1e9:.3f} GFLOP' for k, v in cost['flops'].items())}; "
          f"least bytes {cost['bytes'] / 1e6:.3f} MB; bound {cost['bound_ms']:.5f} ms ({cost['bound_by']}: "
          + ", ".join(f"{k} {v:.5f}" for k, v in cost["bound_terms_ms"].items()) + ")")
    return {"median_ms": ms, "launches_per_forward": len(kernels) / n_prof,
            "device_ms_per_forward": device_ms, "sums_kernel_ms_per_forward": sums_ms,
            "sums_kernel_launches_per_forward": sums_launches,
            "top_kernels_ms_per_forward": dict(by_name.most_common(10)), **cost}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=WARMUP_FRAMES)
    ap.add_argument("--out", default="", help="directory for the profiler's chrome trace")
    ap.add_argument("--frontend", choices=["classical", "lfnet"], default="classical")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device is available")
    card = card_line()

    cfg = TrackerConfig()
    lfnet = None
    if args.frontend == "lfnet":
        cfg = with_lfnet(cfg)
        lfnet = shipped_lfnet(cfg)
    seq = render_main_sequence(args.frames)
    init_pose = np.linalg.inv(seq.ob_in_cam[0])

    # pass 1: stage wall times
    per_frame, frame_ms = [], []
    sink = collections.defaultdict(float)
    originals = {name: getattr(bundler, name) for name in STAGES}
    for name, fn in originals.items():
        setattr(bundler, name, _timed(name, fn, sink))
    try:
        tracker = Tracker(cfg, H, W, lfnet_apply=lfnet)
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
    print(f"frontend: {args.frontend}")
    print(f"frame (stage timers on): median {frame_med:.2f} ms over frames {steady.start}..{args.frames - 1}")
    for name, ms in sorted(stage_ms.items(), key=lambda kv: -kv[1]):
        print(f"  {name:30s} {ms:9.2f} ms  {100 * ms / frame_med:5.1f} %")
    print(f"  {'(rest of the step)':30s} {frame_med - sum(stage_ms.values()):9.2f} ms")

    # pass 2: device time under the profiler, three steady frames
    tracker = Tracker(cfg, H, W, lfnet_apply=lfnet)
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
    kernels = _kernel_events(prof)
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
    lfnet_report = lfnet_forward_report(lfnet, cfg, seq, card) if lfnet is not None else None
    print(json.dumps({
        "card": card,
        "frontend": args.frontend,
        "lfnet_forward": lfnet_report,
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
