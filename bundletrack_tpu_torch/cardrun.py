"""What the card-side scripts share: the card's line, the full-width
rendered sequence, the timed frame loop, CUDA-event timing, and the LF-Net
frontend on the shipped weights with its input crop.

Used by `chip_smoke.py` and `python3 -m bundletrack_tpu_torch.profile_step`,
so both time the same thing.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time

import torch

from bundletrack_tpu_torch.data import render_synthetic_sequence

H, W = 480, 640
WARMUP_FRAMES = 3
TIMED_RUNS = 25


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def render_main_sequence(num_frames: int):
    """A textured cube orbited at 3 deg/frame, rendered at 480x640."""
    return render_synthetic_sequence(num_frames=num_frames, H=H, W=W, orbit_deg_per_frame=3.0)


def timed_frames(tracker, seq, frames, init_pose):
    """Track `frames` of `seq`; yield (frame, TrackOutput, wall ms), the
    device synchronised before and after each `process_frame`."""
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tracker.process_frame(seq.gray[f], seq.depth[f], seq.mask[f], seq.K, init_pose)
        torch.cuda.synchronize()
        yield f, out, (time.perf_counter() - t0) * 1e3


def steady_median(frame_ms, warmup: int = WARMUP_FRAMES) -> float:
    """Median frame time after the warm-up frames."""
    return statistics.median(frame_ms[warmup:])


def cuda_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median of `runs` calls of fn after `warmup`, each between two CUDA
    events."""
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


def with_lfnet(cfg):
    """`cfg` with the LF-Net frontend."""
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, kind="lfnet"))


def shipped_lfnet(cfg):
    """The LF-Net apply module on the shipped weights, on the card."""
    from bundletrack_tpu_torch.apps.run_tracking import LFNET_CKPT
    from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply

    _, params = load_params_npz(LFNET_CKPT, cfg.frontend)
    return make_lfnet_apply(cfg.frontend, params).to("cuda")


def masked_crop(seq, frame: int, size: int) -> torch.Tensor:
    """The masked ROI crop [size, size] of one frame, as the LF-Net branch
    of the pipeline feeds the net."""
    from bundletrack_tpu_torch.ops.masks import mask_roi
    from bundletrack_tpu_torch.ops.resize import crop_resize_square

    gray = torch.as_tensor(seq.gray[frame], device="cuda")
    mask = torch.as_tensor(seq.mask[frame], device="cuda")
    return crop_resize_square(torch.where(mask, gray, 0.0), mask_roi(mask)[:4], size)[0]
