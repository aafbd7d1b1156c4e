"""Fleet tracking on the card: aggregate frames/s of S streams in one step.

    python3 -m bundletrack_tpu_torch.fleet_bench [--frontend classical|lfnet|both]
        [--streams S ...]

Mirrors bench.py's `_bench_fleet` and `_bench_fleet_table`: S identical
streams (the same rendered sequence in every stream; each stream draws its
own RANSAC phases), 2 warm-up fleet frames, then aggregate frames/s = S x
12 timed frames / wall seconds, on the host clock with the device
synchronised at both ends.  Two tables:

- 480x640, S = 1, 4, 8, on bench.py's tracking configuration
  (dense_src_capacity 2048, early_stop_delta 0.005);
- 240x320, S = 1, 4, 8, 16, 32 (dense_src_capacity 1024, early_stop_delta
  0.005), bench.py's stream-scaling table;
- with `--frontend lfnet` (or `both`), LF-Net rows: 480x640, S = 1, 4, 8, on
  the 480x640 configuration with frontend.kind "lfnet" and the shipped
  weights (checkpoints/lfnet_params.npz) at 400x400 in bf16; the S masked
  crops go through one batched forward per fleet frame.

Each row also gives: kernel launches per fleet frame and the device's busy
share, from torch.profiler's trace of two more fleet frames; the device-to-host
reads of one more fleet frame and where they are, from torch's sync debug
mode; the peak
device memory of the timed frames; the BA matcher's launches per fleet
frame; and the frames not tracked OK.  Every stream runs every width of
the configuration: no row cuts trials, pairs or widths, and none is split
into chunks of streams.

Sequences: a textured cube orbited at 2 deg/frame, as bench.py renders.
`--streams` keeps only the 480x640 rows with those S (the 240x320 table is
left out).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

from bundletrack_tpu_torch.cardrun import card_line, shipped_lfnet
from bundletrack_tpu_torch.config import BundleConfig, ShapeConfig, TrackerConfig
from bundletrack_tpu_torch.data import render_synthetic_sequence
from bundletrack_tpu_torch.kernels import matching as km
from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step
from bundletrack_tpu_torch.utils.profiling import kernel_records

WARMUP, TIMED, PROFILED = 2, 12, 2
TABLE_480 = (1, 4, 8)
TABLE_240 = (1, 4, 8, 16, 32)
TABLE_LFNET = (1, 4, 8)  # 480x640


def bench_config(H: int, W: int) -> TrackerConfig:
    """bench.py's fleet configurations: at 480x640 its tracking config, at
    240x320 its stream-scaling table's."""
    capacity = 2048 if (H, W) == (480, 640) else 1024
    return TrackerConfig(
        shapes=ShapeConfig(image_h=H, image_w=W),
        bundle=BundleConfig(dense_src_capacity=capacity, early_stop_delta=0.005),
    )


def lfnet_config(H: int, W: int) -> TrackerConfig:
    """bench_config with the LF-Net frontend at its defaults (400x400, bf16)."""
    cfg = bench_config(H, W)
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, kind="lfnet"))


def render(H: int, W: int, frames: int):
    return render_synthetic_sequence(num_frames=frames, H=H, W=W, orbit_deg_per_frame=2.0)


class FleetRun:
    """S identical streams of `seq` on the card, one fleet frame at a time."""

    def __init__(self, cfg, seq, S: int, lfnet_apply=None):
        F, H, W = seq.gray.shape
        self.S, self.seq = S, seq
        self.step = make_fleet_step(cfg, H, W, lfnet_apply=lfnet_apply)
        self.state = init_fleet_state(cfg, H, W, S)  # the card
        self.device = self.state.kf_pose.device
        self.init_pose = torch.as_tensor(
            np.broadcast_to(np.linalg.inv(seq.ob_in_cam[0]).astype(np.float32), (S, 4, 4)).copy(),
            device=self.device)
        self.frame = 0
        self.not_ok = 0

    def advance(self):
        f = self.frame
        tile = lambda a: np.repeat(a[None], self.S, axis=0)  # noqa: E731
        obs = fleet_observation(tile(self.seq.gray[f]), tile(self.seq.depth[f]), tile(self.seq.mask[f]),
                                tile(self.seq.K), self.device)
        self.state, out = self.step(self.state, obs, self.init_pose)
        self.frame += 1
        return out

    def timed(self, n: int) -> float:
        """Wall seconds of n fleet frames, device synchronised at both ends;
        counts the frames that are not OK."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [self.advance() for _ in range(n)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.not_ok += int(sum(int((o.status != 0).sum()) for o in outs))
        return dt


def fleet_row(cfg, seq, S: int, timed_frames: int, card: str, lfnet_apply=None) -> dict:
    """One row of the table; see the module docstring."""
    run = FleetRun(cfg, seq, S, lfnet_apply)
    run.timed(WARMUP)
    torch.cuda.reset_peak_memory_stats()
    km.launches = 0
    dt = run.timed(timed_frames)
    matcher_per_frame = km.launches / timed_frames
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    fps = S * timed_frames / dt

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        wall_s = run.timed(PROFILED)
    kernels = kernel_records(prof)
    busy_ms = sum(k.dur_us for k in kernels) / 1e3  # overlap ignored

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run.advance()  # the step's own reads: no status read here
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                if "synchronizing" in str(w.message))
    reads = sum(sites.values())

    H, W = seq.gray.shape[1:]
    row = {
        "frontend": cfg.frontend.kind, "H": H, "W": W, "S": S, "timed_frames": timed_frames,
        "aggregate_fps": fps, "fleet_frame_ms": 1e3 * dt / timed_frames,
        "launches_per_fleet_frame": len(kernels) / PROFILED,
        "device_ms_per_fleet_frame": busy_ms / PROFILED,
        "device_busy": busy_ms / (1e3 * wall_s),
        "reads_per_fleet_frame": reads,
        "read_sites": dict(sites),
        "peak_mib": peak_mib,
        "matcher_launches_per_fleet_frame": matcher_per_frame,
        "frames_not_ok": run.not_ok,
        "card": card,
    }
    print(f"fleet {cfg.frontend.kind} {H}x{W} S={S:2d}: {fps:8.3f} frames/s aggregate, {row['fleet_frame_ms']:8.2f} ms per fleet "
          f"frame, {row['launches_per_fleet_frame']:.0f} launches, device {row['device_ms_per_fleet_frame']:.2f} ms "
          f"(busy {100 * row['device_busy']:.1f} %), {reads} reads, peak {peak_mib:.1f} MiB, matcher "
          f"{matcher_per_frame:g} per frame, {run.not_ok} stream-frames not OK [{card}]", flush=True)
    print("  reads at " + ", ".join(f"{k} x{v}" for k, v in sites.most_common()), flush=True)
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frontend", choices=("classical", "lfnet", "both"), default="classical")
    parser.add_argument("--streams", type=int, nargs="+", help="only the 480x640 rows with these S")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fleet_bench: no CUDA device is available")
    card = card_line()
    print(f"card: {card}", flush=True)
    n = WARMUP + TIMED + PROFILED + 1
    seq480 = render(480, 640, n)
    result = collections.defaultdict(list)
    if args.frontend in ("classical", "both"):
        for S in args.streams or TABLE_480:
            result["table_480x640"].append(fleet_row(bench_config(480, 640), seq480, S, TIMED, card))
        if not args.streams:
            seq240 = render(240, 320, n)
            for S in TABLE_240:
                result["table_240x320"].append(fleet_row(bench_config(240, 320), seq240, S, TIMED, card))
    if args.frontend in ("lfnet", "both"):
        cfg = lfnet_config(480, 640)
        apply = shipped_lfnet(cfg)
        for S in TABLE_LFNET:
            result["table_lfnet_480x640"].append(fleet_row(cfg, seq480, S, TIMED, card, apply))
    print(json.dumps({"card": card, **result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
