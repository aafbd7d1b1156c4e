"""Reduce a torch.profiler chrome trace to what the per-layer metrics read.

The traced stretch runs inside one `trackbench.window` span.  From the
trace: every device operation (kernels, copies, fills) with its interval;
each kernel's launch on the host, found through its correlation id, and
from that launch the benchmark's spans (capture.py) that enclose it, so
that a layer's device time is the time of the kernels launched inside its
span, whatever their names; the host spans' own durations.
"""

from __future__ import annotations

import bisect
import collections
import json

from trackbench import arith
from trackbench.capture import SPAN_PREFIX

WINDOW_SPAN = SPAN_PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """What a traced stretch of `frames` fleet frames showed (times in s)."""

    def __init__(self, events: list, frames: int):
        self.frames = frames
        win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW_SPAN]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        w = win[0]
        self.lo, self.hi = w["ts"], w["ts"] + w["dur"]  # us
        self.window_s = w["dur"] * 1e-6
        inside = lambda e: self.lo <= e["ts"] <= self.hi  # noqa: E731
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and inside(e)]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        self.device_intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
        self.busy_s = arith.union_length(self.device_intervals, self.lo, self.hi) * 1e-6
        # host spans of the benchmark, per thread, for attribution
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                 and e.get("name", "").startswith(SPAN_PREFIX) and e["name"] != WINDOW_SPAN and inside(e)]
        self.span_s = collections.defaultdict(float)
        self.span_calls = collections.Counter()
        by_tid = collections.defaultdict(list)
        for e in spans:
            name = e["name"][len(SPAN_PREFIX):]
            self.span_s[name] += e["dur"] * 1e-6
            self.span_calls[name] += 1
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name))
        self._spans = {tid: sorted(v) for tid, v in by_tid.items()}
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.layer_device_s = collections.defaultdict(float)
        self.unattributed = 0
        for k in self.kernels:
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is None:
                self.unattributed += 1
                continue
            for name in self.enclosing(launch["tid"], launch["ts"]):
                self.layer_device_s[name] += k["dur"] * 1e-6
        # host cpu ops on the launching threads, to name idle gaps
        self._ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                           if e.get("cat") == "cpu_op" and e.get("ph") == "X" and inside(e))

    def enclosing(self, tid, ts) -> set:
        """Names of the benchmark's spans on thread `tid` that contain time ts."""
        rows = self._spans.get(tid, ())
        i = bisect.bisect_right(rows, (ts, float("inf"), ""))
        return {name for s, e, name in rows[:i] if s <= ts <= e}

    def host_at(self, ts) -> str:
        """What the host was in at time ts: the innermost benchmark span,
        else the innermost torch operator, else 'host'."""
        names = [(s, name) for rows in self._spans.values() for s, e, name in rows if s <= ts <= e]
        if names:
            return max(names)[1]
        i = bisect.bisect_right(self._ops, (ts, float("inf"), ""))
        ops = [(s, name) for s, e, name in self._ops[max(0, i - 200):i] if s <= ts <= e]
        return max(ops)[1] if ops else "host"

    def breakdown(self, top: int = 10) -> dict:
        by_name = collections.Counter()
        for k in self.kernels:
            by_name[k["name"]] += k["dur"] * 1e-6
        idle = sorted(arith.gaps(self.device_intervals, self.lo, self.hi), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:120], s] for name, s in by_name.most_common(top)],
            "idle_gaps": [[self.host_at(s), (e - s) * 1e-6] for s, e in idle],
        }


def load(path: str, frames: int) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    return Trace(doc["traceEvents"] if isinstance(doc, dict) else doc, frames)
