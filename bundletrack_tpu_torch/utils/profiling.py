"""The port's tracing: spans on the profiler's timeline, and counters.

Counterpart of bundletrack_tpu/utils/profiling.py (reference: CUDATimer
usage in SolverBundling.cu:831, CUDASolverBundling.h:39-48
evaluateTimings).

Spans.  `annotate(name)` marks a region of the host's work.  While a torch
profiler records (`trace` below, or any `torch.profiler.profile`) it is a
`torch.profiler.record_function` span, written on the same clock as the
card's kernels, copies and fills, so a kernel is put down to the span it
was launched in and an idle stretch of the card to the span the host was
in.  Otherwise it is one shared null context: no span, no tensor, no
launch, no read.  The step's spans are named `bundletrack.<stage>` and nest
inside one `bundletrack.step` per fleet frame, on the launching thread:

    bundletrack.upload      parallel/fleet.fleet_observation, the Tracker's upload
    bundletrack.step        the whole of one (fleet) step
      bundletrack.preprocess  raw types to floats, the depth chain, normals, the dense tables
      bundletrack.frontend    extract_frame_features
        bundletrack.sums      the norm-sums kernel's wrappers (LF-Net)
      bundletrack.neighbour   neighbour match, RANSAC, refine, the fail gate
      bundletrack.ba_pairs    the BA subset, its table gathers, the BA pair section
        bundletrack.matcher   the fused matcher kernel's wrapper
      bundletrack.gn          optimize_pose_graph_verified
        bundletrack.gn.dense  each GN iteration's dense point-to-plane term (an
                              eager solve's only: a replayed CUDA graph has no spans)

Counters.  `count(name, n)` adds to one Counter of the process, fed only
from values the host already holds (no read, no launch); `counters()`
returns a copy, so a caller takes the difference of two copies.  The step
keeps: `frames` (steps), `reads.solve`, `reads.admit`, `reads.early_stop`
(each device-to-host read, made through `read`), `gn.solves` (streams
solved), `gn.iterations` (passes of the GN loop, replayed ones included),
`gn.captures` (solves captured as CUDA graphs), `gn.replays` (streams
solved by a replay: over `gn.solves`, the share replayed) and
`keyframes.admitted` (streams that admitted a keyframe).

Recording a run with the spans: wrap it in `trace(log_dir)` and open
`log_dir/trace.json` in Perfetto (ui.perfetto.dev) or chrome://tracing,
for instance

    from bundletrack_tpu_torch.apps import run_tracking
    from bundletrack_tpu_torch.utils import profiling
    with profiling.trace("trace_dir"):
        run_tracking.main(["config.yml", "--max-frames", "20"])

A trace of many frames is large: profile a few.

Reading a profiler's kernels: `kernel_records(prof)` lists every kernel
the card ran while `prof` recorded, from its Chrome trace, those that a
replayed CUDA graph ran included; `prof.events()` folds a graph's
kernels into fewer records with longer spans.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
from contextlib import contextmanager
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()
_counters: collections.Counter = collections.Counter()


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


class Kernel(NamedTuple):
    name: str
    start_us: float
    dur_us: float


def kernel_records(prof) -> list:
    """Every kernel the card ran while the finished profiler `prof`
    recorded, in start order, read from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, TRACE_FILE)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((Kernel(e["name"], float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel"), key=lambda k: k.start_us)


def annotate(name: str):
    """A span named `name` while a torch profiler records; else the shared
    null context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _counters[name] += n


def counters() -> collections.Counter:
    """A copy of every counter of the process."""
    return collections.Counter(_counters)


def read(name: str, t: torch.Tensor):
    """t.tolist(), the step's one way to read the device, counted under `name`."""
    _counters[name] += 1
    return t.tolist()
