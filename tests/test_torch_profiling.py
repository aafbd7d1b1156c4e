"""The port's spans and counters (utils/profiling.py) on the CPU, and the
benchmark-side reduction of a trace that holds them
(trackbench/program_spans.py).

The fleet runs the tiny cell of trackbench/tests/tiny.py: 2 streams at
120x160, small capacities, each frontend.  Checked: under a profiler every
span of the step appears with its calls per fleet frame, nested in
`bundletrack.step`; without one `annotate` is a shared null context and the
step's outputs and state are bit for bit those of a profiled run; the
counters agree with the outputs and the configuration; no device-to-host
read escapes `profiling.read`; and on hand-made chrome-trace events the
benchmark's Trace reads the same with and without the program's spans, the
program's idle split adds up to the window's idle time, and each reading
gives its value.
"""

import collections
import contextlib
import json
import os
import sys

import pytest
import torch

from bundletrack_tpu_torch.tracker.state import STATUS_OK
from bundletrack_tpu_torch.utils import profiling
from trackbench import program_spans as ps
from trackbench.tests.tiny import SEED, TINY
from trackbench.trace import Trace

WORKLOADS = {"classical": "classical.s8", "lfnet": "lfnet.s8"}
TRACKED = 2  # fleet frames stepped after the tiny cell's warm-up


def _fleet(frontend, overrides=TINY):
    torch.set_num_threads(1)
    fleet, _, _ = ps.setup(WORKLOADS[frontend], SEED, device="cpu", overrides=overrides)
    return fleet


def _step(fleet):
    """One fleet frame: upload and step; the full output."""
    obs = fleet.streams.observation(fleet.t)
    pre = fleet.state
    fleet.state, out = fleet.step(fleet.state, fleet.observe(*obs, fleet.device), fleet.init_pose)
    fleet.t += 1
    return pre, out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.Generator):
        yield tree.get_state()
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


# ---- spans ---------------------------------------------------------------------

CALLS = {  # calls per tracked fleet frame
    "bundletrack.upload": 1, "bundletrack.step": 1, "bundletrack.preprocess": 1, "bundletrack.frontend": 1,
    "bundletrack.neighbour": 1, "bundletrack.ba_pairs": 1, "bundletrack.matcher": 1, "bundletrack.gn": 1,
}
PARENT = {"bundletrack.preprocess": "bundletrack.step", "bundletrack.frontend": "bundletrack.step",
          "bundletrack.sums": "bundletrack.frontend", "bundletrack.neighbour": "bundletrack.step",
          "bundletrack.ba_pairs": "bundletrack.step", "bundletrack.matcher": "bundletrack.ba_pairs",
          "bundletrack.gn": "bundletrack.step", "bundletrack.gn.dense": "bundletrack.gn"}


@pytest.mark.parametrize("frontend", ["classical", "lfnet"])
def test_every_span_appears_per_fleet_frame_nested_in_the_step(frontend, tmp_path):
    fleet = _fleet(frontend)
    iterations = fleet.cfg.bundle.num_iter_outer
    with profiling.trace(str(tmp_path)):
        for _ in range(TRACKED):
            _step(fleet)
    events = json.load(open(tmp_path / profiling.TRACE_FILE))["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("bundletrack."))
    calls = collections.Counter(name for _, _, name, _ in spans)
    expected = {**CALLS, "bundletrack.gn.dense": iterations}
    if frontend == "lfnet":
        expected["bundletrack.sums"] = 13  # the norms of one batched forward
    assert calls == {k: v * TRACKED for k, v in expected.items()}
    assert len({tid for *_, tid in spans}) == 1  # one launching thread
    for s, e, name, _ in spans:
        parents = [(ps_, n) for ps_, pe, n, _ in spans if ps_ <= s and e <= pe and n != name]
        if name in ("bundletrack.step", "bundletrack.upload"):
            assert not parents, (name, parents)
            continue
        assert "bundletrack.step" in {n for _, n in parents}, name
        assert max(parents)[1] == PARENT[name], (name, parents)


def test_annotate_is_the_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.annotate("bundletrack.step")
    assert isinstance(off, contextlib.nullcontext) and off is profiling.annotate("bundletrack.gn")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = profiling.annotate("bundletrack.step")
        assert isinstance(on, torch.profiler.record_function) and on is not off


def test_the_step_is_bit_equal_with_and_without_a_profiler(tmp_path):
    plain, profiled = _fleet("classical"), _fleet("classical")
    for _ in range(TRACKED):
        _, out_a = _step(plain)
        with profiling.trace(str(tmp_path)):
            _, out_b = _step(profiled)
        for a, b in zip(_tensors((out_a, plain.state)), _tensors((out_b, profiled.state))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert plain.state.frame_count == profiled.state.frame_count


# ---- counters ------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["classical", "lfnet"])
def test_counters_match_the_outputs_and_the_configuration(frontend):
    fleet = _fleet(frontend)
    cfg = fleet.cfg
    assert cfg.bundle.early_stop_delta == 0 and not cfg.bundle.use_verification
    solving, solves, admitted = 0, 0, 0
    before = profiling.counters()
    for _ in range(TRACKED):
        pre, out = _step(fleet)
        ok = (out.status == STATUS_OK).tolist()  # run and not rejected: the verification is off
        solving += any(ok)
        solves += sum(ok)
        # an admitted frame takes a pool slot under the stream's frame count before the step
        counts = torch.tensor(pre.frame_count)[:, None]
        admitted += int(((fleet.state.kf_frame_id == counts).any(1) & ~(pre.kf_frame_id == counts).any(1)).sum())
    got = profiling.counters() - before
    assert got == collections.Counter({
        "frames": TRACKED, "reads.solve": TRACKED, "reads.admit": TRACKED, "gn.solves": solves,
        "gn.iterations": cfg.bundle.num_iter_outer * solving, "keyframes.admitted": admitted,
    }), got
    assert solves > 0 and admitted > 0


def test_the_early_stop_read_is_counted():
    overrides = {**TINY, "tracker": {**TINY["tracker"], "bundle": {**TINY["tracker"]["bundle"],
                                                                      "early_stop_delta": 1e3}}}
    fleet = _fleet("classical", overrides)
    before = profiling.counters()
    solving = sum(any((_step(fleet)[1].status == STATUS_OK).tolist()) for _ in range(TRACKED))
    got = profiling.counters() - before
    # every graph stops after its first update: one pass and one read per solve
    assert solving and got["gn.iterations"] == solving and got["reads.early_stop"] == solving
    assert got["reads.solve"] == got["reads.admit"] == TRACKED


def test_counters_returns_a_copy():
    profiling.count("test.copy", 2)
    copy = profiling.counters()
    copy["test.copy"] += 5
    assert profiling.counters()["test.copy"] - copy["test.copy"] == -5
    assert profiling.read("test.read", torch.tensor([True, False])) == [True, False]
    assert profiling.counters()["test.read"] >= 1


@pytest.mark.parametrize("frontend", ["classical", "lfnet"])
def test_no_device_read_of_the_step_escapes_the_counting_helper(frontend, monkeypatch):
    """Every way Python reads a tensor's values, counted while the step runs,
    but float() of the f32 constants ops/numerics.py builds from Python
    floats on the host (those are no device reads)."""
    fleet = _fleet(frontend)
    reads = collections.Counter()
    for name in ("tolist", "item", "__bool__", "__int__", "__index__", "__float__"):
        original = getattr(torch.Tensor, name)

        def counted(self, *args, _name=name, _original=original):
            host_constant = sys._getframe(1).f_code.co_filename.endswith(os.path.join("ops", "numerics.py"))
            if not (_name == "__float__" and host_constant):
                reads[_name] += 1
            return _original(self, *args)

        monkeypatch.setattr(torch.Tensor, name, counted)
    before = profiling.counters()
    for _ in range(TRACKED):
        _step(fleet)
    monkeypatch.undo()
    got = profiling.counters() - before
    assert reads == {"tolist": 2 * TRACKED}
    assert sum(v for k, v in got.items() if k.startswith("reads.")) == 2 * TRACKED


# ---- the benchmark's reduction of a trace with the program's spans ---------------

def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def _kernel(name, ts, dur, corr, launch_ts, tid=1):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7, "pid": 0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch_ts, "dur": 1, "tid": tid,
             "pid": 1, "args": {"correlation": corr}}]


def _events(program=True):
    """Two fleet frames in a 200 us window (us): the benchmark's spans and
    torch ops, kernels and a copy; with `program`, the program's spans."""
    ev = [_span("trackbench.window", 0, 200),
          _span("trackbench.gn", 40, 50), _span("trackbench.frontend", 20, 10),
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 2, "dur": 6, "tid": 1, "pid": 1},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 3, "dur": 4, "tid": 7, "pid": 0}]
    ev += _kernel("pre", 12, 4, 1, 11) + _kernel("front", 22, 6, 2, 21) + _kernel("dense", 50, 10, 3, 45)
    ev += _kernel("solve", 70, 5, 4, 65) + _kernel("late", 150, 20, 5, 140)
    if program:
        ev += [_span("bundletrack.upload", 1, 8), _span("bundletrack.step", 10, 90),
               _span("bundletrack.preprocess", 10, 8), _span("bundletrack.frontend", 19, 11),
               _span("bundletrack.gn", 40, 50), _span("bundletrack.gn.dense", 44, 6),
               _span("bundletrack.upload", 101, 4), _span("bundletrack.step", 110, 80)]
    return ev


def test_the_benchmarks_trace_reads_the_same_with_the_programs_spans():
    a, b = Trace(_events(False), 2), Trace(_events(True), 2)
    for attr in ("frames", "lo", "hi", "window_s", "kernels", "device_intervals", "busy_s", "span_s",
                 "span_calls", "layer_device_s", "unattributed"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a.breakdown() == b.breakdown()


def test_the_programs_idle_split_adds_up_to_the_windows_idle_time():
    tr = ps.ProgramTrace(_events(), 2)
    idle = tr.window_s - tr.busy_s
    assert sum(tr.program_idle_s.values()) == pytest.approx(idle, rel=1e-12)
    # busy: 3-7, 12-16, 22-28, 50-60, 70-75, 150-170 us
    us = {k: round(v * 1e6, 6) for k, v in tr.program_idle_s.items()}
    # idle: 0-3, 7-12, 16-22, 28-50, 60-70, 75-150, 170-200 us
    assert us == {"outside": 1 + 1 + 1 + 5 + 10, "bundletrack.upload": 2 + 2 + 4, "bundletrack.preprocess": 2 + 2,
                  "bundletrack.frontend": 3 + 2, "bundletrack.step": 1 + 10 + 10 + 40 + 20,
                  "bundletrack.gn": 4 + 10 + 15, "bundletrack.gn.dense": 6}
    assert dict(tr.program_launches) == {"bundletrack.step": 5, "bundletrack.preprocess": 1,
                                         "bundletrack.frontend": 1, "bundletrack.gn": 2, "bundletrack.gn.dense": 1}
    assert tr.program_device_s["bundletrack.gn"] == pytest.approx(15e-6)


def test_each_reading_from_a_hand_made_trace_and_counters():
    tr = ps.ProgramTrace(_events(), 2)
    counts = collections.Counter({"frames": 2, "reads.solve": 2, "reads.admit": 2, "gn.iterations": 14})
    got = ps.readings(tr, counts)
    assert got == pytest.approx({
        "gn_idle_ms": 35e-3 / 2, "gn_launches_per_frame": 1.0, "gn_dense_device_ms": 10e-3 / 2,
        "preprocess_device_ms": 4e-3 / 2, "upload_ms": 12e-3 / 2, "between_steps_idle_ms": 18e-3 / 2,
        "step_reads_per_frame": 2.0,
    })
    assert set(got) == set(ps.READINGS)
    # a program without the spans and counters: nothing to read, nothing raised
    assert ps.readings(ps.ProgramTrace(_events(False), 2), None) == {}
    assert ps.twins(tr)["gn_device_ms"] == pytest.approx([15e-3 / 2, 15e-3 / 2])


def test_innermost_names_every_piece_of_the_window():
    pieces = ps.innermost([(2, 8, "a"), (3, 5, "b")], 0, 10)
    assert pieces == [(0, 2, "outside"), (2, 3, "a"), (3, 5, "b"), (5, 8, "a"), (8, 10, "outside")]
    assert sum(b - a for a, b, _ in pieces) == 10
