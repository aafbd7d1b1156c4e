"""What the card-side scripts share: the card's line, the full-width
rendered sequence, and the timed frame loop.

Used by `chip_smoke.py` and `python3 -m bundletrack_tpu_torch.profile_step`,
so both time the same thing.  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from bundletrack_tpu_torch.data import render_synthetic_sequence

H, W = 480, 640
WARMUP_FRAMES = 3


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
