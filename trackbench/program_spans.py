"""The program's own spans and counters, read from a profiled stretch.

The port marks the stages of its fleet step with `bundletrack.*` spans
while a profiler records, and counts its steps, device-to-host reads, GN
solves and iterations and admitted keyframes
(bundletrack_tpu_torch/utils/profiling.py).  `ProgramTrace` is the
benchmark's `Trace` of the same chrome trace, with per program span name:

- `program_span_s`, `program_span_calls`: host seconds and calls;
- `program_device_s`, `program_launches`: the kernels whose launch a span
  of that name encloses (the rule of `layer_device_s`);
- `program_idle_s`: each idle stretch of the card in the window, split
  over the innermost program span the host was in at each instant of it;
  time outside every program span goes under "outside".  The values add
  up to `window_s - busy_s`.

`READINGS` turns a ProgramTrace and the counters' difference over the
profiled frames into numbers per fleet frame.  Each gives None where the
program has no such span or counter.  They are not among the cells'
metrics: the harness does not build a ProgramTrace (PERF.md, Open
questions).  Run

    python3 -m trackbench.program_spans --workload classical.s8 --seed <n> [--frames 5] [--syncs]

on a machine with a card: set-up and warm-up as a run makes them, then
`--frames` fleet frames profiled with the benchmark's spans and the
program's; one JSON line with the readings beside the benchmark's own
layer metrics on the same frames.  `--syncs` adds one more fleet frame
(upload and step, as `host_reads_per_frame` counts it) under torch's sync
debug mode, with the program's lines that made each synchronisation.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time
import traceback
import warnings

from trackbench import arith, harness, spec
from trackbench.trace import LAUNCH_CATS, WINDOW_SPAN, Trace

PREFIX = "bundletrack."
OUTSIDE = "outside"
GN = PREFIX + "gn"


class ProgramTrace(Trace):
    """A Trace that also reads the program's `bundletrack.*` spans."""

    def __init__(self, events: list, frames: int):
        super().__init__(events, frames)
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
                       if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                       and e.get("name", "").startswith(PREFIX) and self.lo <= e["ts"] <= self.hi)
        self.program_span_s = collections.defaultdict(float)
        self.program_span_calls = collections.Counter()
        by_tid = collections.defaultdict(list)
        for s, e, name, tid in spans:
            self.program_span_s[name] += (e - s) * 1e-6
            self.program_span_calls[name] += 1
            by_tid[tid].append((s, e, name))
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.program_device_s = collections.defaultdict(float)
        self.program_launches = collections.Counter()
        for k in self.kernels:
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is None:
                continue
            rows = by_tid.get(launch["tid"], ())
            for name in {name for s, e, name in rows if s <= launch["ts"] <= e}:
                self.program_device_s[name] += k["dur"] * 1e-6
                self.program_launches[name] += 1
        self.program_idle_s = collections.defaultdict(float)
        idle = arith.gaps(self.device_intervals, self.lo, self.hi)
        for a, b, name in innermost([(s, e, name) for s, e, name, _ in spans], self.lo, self.hi):
            for s, e in idle:  # few segments and gaps per frame: a plain double loop
                if e > a and s < b:
                    self.program_idle_s[name] += (min(b, e) - max(a, s)) * 1e-6


def innermost(spans, lo, hi):
    """[lo, hi) cut into [(start, end, name)] pieces, each named after the
    innermost of `spans` (start, end, name) that covers it (the latest
    start, of two at one start the earlier end), or OUTSIDE."""
    points = sorted({lo, hi} | {t for s, e, _ in spans for t in (s, e) if lo < t < hi})
    out = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        covering = [(s, -e, name) for s, e, name in spans if s <= mid < e]
        out.append((a, b, max(covering)[2] if covering else OUTSIDE))
    return out


def _per_frame_ms(tr, seconds):
    return seconds / tr.frames * 1e3 if seconds else None


def gn_idle_ms(tr, counts):
    """Card idle ms per fleet frame while the host is inside the GN solve."""
    return _per_frame_ms(tr, sum(s for name, s in tr.program_idle_s.items()
                                 if name == GN or name.startswith(GN + ".")))


def gn_launches_per_frame(tr, counts):
    """Kernels launched inside `bundletrack.gn`, per fleet frame."""
    n = tr.program_launches.get(GN)
    return n / tr.frames if n else None


def gn_dense_device_ms(tr, counts):
    """Device ms per fleet frame of the kernels launched in the GN dense term."""
    return _per_frame_ms(tr, tr.program_device_s.get(GN + ".dense"))


def preprocess_device_ms(tr, counts):
    """Device ms per fleet frame of the kernels launched in `bundletrack.preprocess`."""
    return _per_frame_ms(tr, tr.program_device_s.get(PREFIX + "preprocess"))


def upload_ms(tr, counts):
    """Host ms per fleet frame inside `bundletrack.upload`."""
    return _per_frame_ms(tr, tr.program_span_s.get(PREFIX + "upload"))


def between_steps_idle_ms(tr, counts):
    """Card idle ms per fleet frame while the host is in no program span:
    neither a step nor an upload, so the caller's time between frames."""
    if not tr.program_span_calls.get(PREFIX + "step"):
        return None
    return tr.program_idle_s.get(OUTSIDE, 0.0) / tr.frames * 1e3


def step_reads_per_frame(tr, counts):
    """Device-to-host reads per fleet frame by the step's own count."""
    if not counts or not counts.get("frames"):
        return None
    return sum(v for k, v in counts.items() if k.startswith("reads.")) / counts["frames"]


# name -> (unit, better, layer, source, reader(ProgramTrace, counters' difference))
READINGS = {
    "gn_idle_ms": ("ms", "lower", "solver", "program_span", gn_idle_ms),
    "gn_launches_per_frame": ("launches", "lower", "solver", "program_span", gn_launches_per_frame),
    "gn_dense_device_ms": ("ms", "lower", "solver", "program_span", gn_dense_device_ms),
    "preprocess_device_ms": ("ms", "lower", "frontend", "program_span", preprocess_device_ms),
    "upload_ms": ("ms", "lower", "fleet step", "program_span", upload_ms),
    "between_steps_idle_ms": ("ms", "lower", "fleet step", "program_span", between_steps_idle_ms),
    "step_reads_per_frame": ("reads", "lower", "fleet step", "program_counter", step_reads_per_frame),
}


def readings(tr: ProgramTrace, counts) -> dict:
    """Every reading that has something to read."""
    out = {name: row[-1](tr, counts) for name, row in READINGS.items()}
    return {k: v for k, v in out.items() if v is not None}


def twins(tr: ProgramTrace) -> dict:
    """The benchmark's outside layer readings beside the program-side spans
    that would replace them, ms (launches) per fleet frame."""
    ms = lambda s: s / tr.frames * 1e3  # noqa: E731
    dev, prog = tr.layer_device_s, tr.program_device_s
    return {
        "gn_device_ms": [ms(dev.get("gn", 0.0)), ms(prog.get(GN, 0.0))],
        "gn_span_ms": [ms(tr.span_s.get("gn", 0.0)), ms(tr.program_span_s.get(GN, 0.0))],
        "frontend_device_ms": [ms(dev.get("frontend", 0.0)), ms(prog.get(PREFIX + "frontend", 0.0))],
        "ransac_device_ms": [ms(dev.get("matching", 0.0)),
                             ms(prog.get(PREFIX + "neighbour", 0.0) + prog.get(PREFIX + "ba_pairs", 0.0))],
        "matcher_device_ms": [ms(dev.get("matcher", 0.0)), ms(prog.get(PREFIX + "matcher", 0.0))],
        "sums_device_ms": [ms(dev.get("sums", 0.0)), ms(prog.get(PREFIX + "sums", 0.0))],
        "launches_per_frame": [len(tr.kernels) / tr.frames,
                               sum(tr.program_launches[PREFIX + s] for s in ("step", "upload")) / tr.frames],
    }


def profile_frames(fleet, n: int, on_card: bool, path: str):
    """Profile n fleet frames with the benchmark's spans on (as the traced
    stretch does); (ProgramTrace, the counters' difference, host seconds of
    the n frames)."""
    import torch

    from bundletrack_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    fleet.hooks.spans = True
    before = profiling.counters() if hasattr(profiling, "counters") else None
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            for _ in range(n):
                fleet.frame()
            if on_card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    fleet.hooks.spans = False
    counts = None if before is None else profiling.counters() - before
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    os.remove(path)
    return ProgramTrace(doc["traceEvents"] if isinstance(doc, dict) else doc, n), counts, seconds


def sync_sites(fleet) -> list:
    """Each synchronisation of one fleet frame's upload and step under
    torch's sync debug mode: the innermost frames of the program's (or
    the benchmark's) code that made it, "file:line function"."""
    import torch

    sites = []
    root = os.path.dirname(spec.ROOT)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(root)]
            sites.append([f"{os.path.relpath(f.filename, root)}:{f.lineno} {f.name}" for f in ours[::-1][:4]])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            obs = fleet.streams.observation(fleet.t)
            fleet.state, _ = fleet.step(fleet.state, fleet.observe(*obs, fleet.device), fleet.init_pose)
            fleet.t += 1
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def setup(workload: str, seed: int, device=None, overrides=None):
    """The cell's fleet after its set-up and warm-up, as a run makes them;
    (fleet, cell, on_card)."""
    import torch

    cell = spec.load_cell(workload, overrides)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("trackbench.program_spans: no CUDA device")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.set_num_threads(1)
    fleet = harness.Run(cell, seed, device)
    for _ in range(int(cell.cell["warmup_frames"])):
        fleet.frame()
    if on_card:
        torch.cuda.synchronize()
    return fleet, cell, on_card


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="The program's spans and counters over profiled fleet frames.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--syncs", action="store_true")
    args = ap.parse_args(argv)
    fleet, cell, on_card = setup(args.workload, args.seed)
    os.makedirs(harness.OUT, exist_ok=True)
    tr, counts, seconds = profile_frames(fleet, args.frames, on_card,
                                         os.path.join(harness.OUT, f"{cell.name}.program.json"))
    result = {
        "workload": cell.name, "seed": args.seed, "card": torch.cuda.get_device_name(0), "frames": args.frames,
        "profiled_ms_per_frame": seconds / args.frames * 1e3,
        "readings": readings(tr, counts), "twins": twins(tr),
        "window_s": tr.window_s, "busy_s": tr.busy_s, "idle_s": tr.window_s - tr.busy_s,
        "program_idle_s": dict(tr.program_idle_s),
        "program_device_ms": {k: v / args.frames * 1e3 for k, v in tr.program_device_s.items()},
        "program_span_ms": {k: v / args.frames * 1e3 for k, v in tr.program_span_s.items()},
        "program_span_calls": dict(tr.program_span_calls),
        "program_launches": dict(tr.program_launches),
        "counters": dict(counts or {}),
    }
    if args.syncs:
        from bundletrack_tpu_torch.utils import profiling

        before = profiling.counters()
        result["syncs"] = sync_sites(fleet)
        result["sync_frame_counters"] = dict(profiling.counters() - before)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
