"""Profiler hooks on torch.profiler.

Counterpart of bundletrack_tpu/utils/profiling.py (reference: CUDATimer
usage in SolverBundling.cu:831, CUDASolverBundling.h:39-48
evaluateTimings).  Wrap a region in `trace(log_dir)` and open the Chrome
trace it writes (`log_dir/trace.json`) in Perfetto or chrome://tracing;
`annotate(name)` marks a sub-region on the timeline.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextmanager
def trace(log_dir: str):
    """Profile the enclosed region (the host, and the card when there is
    one); yields the profiler, whose `key_averages()` sum the kernels, and
    writes its Chrome trace to log_dir/trace.json."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named sub-region inside a trace (shows up on the timeline)."""
    return record_function(name)
