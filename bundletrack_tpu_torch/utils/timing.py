"""Named-stage timing, the CUDATimer / TimingLog equivalent.

Counterpart of bundletrack_tpu/utils/timing.py (reference:
src/cuda/CUDATimer.h:28-120, cudaEvent-based named events with mean/sum
evaluation; src/cuda/TimingLog.h:6-60).  On the card a stage is timed with
CUDA events recorded on the current stream around it, so the time covers
the device work the stage enqueued; on the CPU, where torch runs
synchronously, with the host clock.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List

import torch

from bundletrack_tpu_torch.device import resolve_device


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def hard_sync(tree: Any) -> Any:
    """Wait until the device work producing every tensor in `tree` (a nest
    of dicts, lists and tuples) is done; returns `tree`.  Synchronises each
    CUDA device the tree's tensors live on, and nothing for CPU tensors."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Accumulates times per named stage across frames, on the card unless
    `device` says otherwise."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = resolve_device(device)
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            self.times[name].append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            yield
            self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.times[name].append(seconds)

    def evaluate(self) -> str:
        """Aggregate report (reference CUDATimer::evaluate)."""
        lines = ["=== StageTimer ==="]
        for name, ts in sorted(self.times.items()):
            total = sum(ts)
            lines.append(f"{name:32s} n={len(ts):5d} mean={1000 * total / len(ts):8.2f}ms total={total:8.3f}s")
        return "\n".join(lines)

    def reset(self) -> None:
        self.times.clear()
