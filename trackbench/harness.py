"""One run of one cell: set up, warm up, measure, check, report.

    python3 -m trackbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's orbit loop on the card, builds the program's
fleet step (`make_fleet_step`) and state (`init_fleet_state`) for the
cell's configuration, and tracks `warmup_frames` fleet frames (the first
frame, then tracked frames, so every shape and path of the window has run
and every kernel is built).  The window then tracks fleet frames for
`--seconds` in a closed loop: a fleet frame's observations (u8 gray, u16
depth, bool mask, intrinsics, in host memory) go to the step only once
the previous frame's poses and statuses are on the host.

With `--trace 1` the same window runs, then `profiled_frames` more fleet
frames under torch.profiler with the benchmark's spans on (capture.py),
then one frame under torch's sync debug mode; the per-layer metrics
(trackbench/metrics/) are read from those.

Once the window has closed, the peak memory is read, the program's state
is freed and the reference checks the sampled frames (check.py).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import pkgutil
import sys
import time
import warnings

import numpy as np

from trackbench import arith, check, spec
from trackbench.capture import SPAN_PREFIX, Hooks
from trackbench.traffic import Streams

OUT = os.path.join(spec.ROOT, "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "bundletrack_tpu")
GIB = 2.0**30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def metric_readers(cell: str) -> list:
    """Every per-layer metric reader in trackbench/metrics/ that applies to `cell`."""
    import trackbench.metrics as pkg

    readers = []
    for info in sorted(pkgutil.iter_modules(pkg.__path__), key=lambda i: i.name):
        mod = importlib.import_module(f"trackbench.metrics.{info.name}")
        if getattr(mod, "WORKLOADS", None) is None or cell in mod.WORKLOADS:
            readers.append(mod)
    return readers


class Run:
    """The program's fleet on one device, stepping the cell's streams."""

    def __init__(self, cell: spec.Cell, seed: int, device, fault=None):
        import torch

        from bundletrack_tpu_torch.config import load_config
        from bundletrack_tpu_torch.parallel import fleet_observation, init_fleet_state, make_fleet_step

        self.cell, self.device = cell, device
        self.H, self.W = int(cell.config["image"]["H"]), int(cell.config["image"]["W"])
        self.cfg = load_config(cell.config["tracker"])
        self.S = int(cell.traffic["streams"])
        t = time.perf_counter()
        self.streams = Streams(cell.traffic, seed, self.H, self.W, device=device)
        self.render_s = time.perf_counter() - t
        sched = self.streams.schedule
        lfnet = None
        if self.cfg.frontend.kind == "lfnet":
            from bundletrack_tpu_torch.frontend.lfnet import load_params_npz, make_lfnet_apply

            _, params = load_params_npz(spec.weights_path(cell.config), self.cfg.frontend)
            lfnet = make_lfnet_apply(self.cfg.frontend, params).to(device)
        self.hooks = Hooks().install()
        self.observe = fleet_observation
        self.step = make_fleet_step(self.cfg, self.H, self.W, lfnet_apply=lfnet)
        if fault is not None:
            self.step = fault(self.step)
        self.state = init_fleet_state(self.cfg, self.H, self.W, self.S, device=device, seed=sched.tracker_seed)
        first = np.linalg.inv(self.streams.truth(0).astype(np.float64)).astype(np.float32)
        self.init_pose = torch.as_tensor(first, device=device)  # each stream's pose at its first frame
        self.t = 0

    def frame(self, sample=None):
        """Track one fleet frame; (ob_in_cam [S, 4, 4], status [S]) on the host."""
        obs = self.streams.observation(self.t)
        if sample is not None:
            sample.pre, sample.obs = self.state, obs
            sample.rng_states = [g.get_state() for g in self.state.rng]
            self.hooks.calls.clear()
            self.hooks.armed = True
        state, out = self.step(self.state, self.observe(*obs, self.device), self.init_pose)
        pose, status = out.ob_in_cam.cpu().numpy(), out.status.cpu().numpy()
        if sample is not None:
            self.hooks.armed = False
            calls = self.hooks.calls
            sample.post, sample.out = state, out
            sample.feats = calls["feats"][-1][2] if calls["feats"] else None
            sample.matcher = calls["matcher"][-1] if calls["matcher"] else None
            sample.gn = calls["gn"][-1] if calls["gn"] else None
            sample.truth = self.streams.truth(self.t)
        self.state = state
        self.t += 1
        return pose, status


def run(workload: str, seed: int, seconds: float, trace: bool, start: float, device=None,
        overrides=None, fault=None, control=False, log=sys.stderr) -> dict | None:
    """One run; returns the result line's object (None when the run cannot
    report: no card, or JAX loaded).  `device`, `overrides` and `fault` are
    for the tests; `control` (trackbench/readings.py) also reads the
    control's numbers on the same samples, under "control"."""
    cell = spec.load_cell(workload, overrides)
    chips = int(cell.cell.get("chips", 1))
    os.makedirs(OUT, exist_ok=True)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(OUT, "cache", sub)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"trackbench: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=log)
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.set_num_threads(1)  # one process, few threads: no idle worker threads beside the launching one
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    t_build = time.perf_counter()
    fleet = Run(cell, seed, device, fault)
    t_first = time.perf_counter()
    fleet.frame()
    fleet.frame()
    t_warm = time.perf_counter()
    for _ in range(int(cell.cell["warmup_frames"]) - 2):
        fleet.frame()
    sync()
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's scans in the window
    setup_s = time.perf_counter() - start
    setup = {"imports_s": t_build - start, "render_s": fleet.render_s,
             "build_s": t_first - t_build - fleet.render_s, "first_two_frames_s": t_warm - t_first,
             "warmup_s": time.perf_counter() - t_warm}

    sched = fleet.streams.schedule
    sample_at = set(sched.sample(seed, int(cell.cell["samples"]), int(cell.cell["sample_frames"])))
    samples, frame_ms, gt_err, failed = [], [], 0.0, 0
    failed_by_texture = dict.fromkeys(sorted(int(x) for x in sched.texture), 0)
    corners = _corners(cell)
    fleet.hooks.counts.clear()
    t0 = time.perf_counter()
    i = 0
    while True:
        sample = None
        if i in sample_at:
            sample = check.Sample()
            samples.append(sample)
        truth = fleet.streams.truth(fleet.t)
        f0 = time.perf_counter()
        pose, status = fleet.frame(sample)
        f1 = time.perf_counter()
        frame_ms.append((f1 - f0) * 1e3)
        if sample is not None:  # the copy to the host is the benchmark's, not the window's
            sample.move("cpu")
            t0 += time.perf_counter() - f1
        bad = (status != 0) | ~np.isfinite(pose).all(axis=(1, 2))
        failed += int(bad.sum())
        for tex in sched.texture[bad]:
            failed_by_texture[int(tex)] += 1
        gt_err = max(gt_err, arith.corner_gap_mm(pose, truth, corners))
        i += 1
        if f1 - t0 >= seconds and i > max(sample_at, default=-1):
            break
    window_s = f1 - t0
    gc.unfreeze()
    admitting = fleet.hooks.counts["admission"]  # fleet frames in which some stream admitted a keyframe
    n_frames = len(frame_ms)

    result_device = {"platform": "gpu" if on_card else device.type,
                     "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": 1}
    metrics = {}
    if trace:
        tr, reads, shapes = _traced_stretch(fleet, cell, on_card)
        result_device.update(busy_s=tr.busy_s, window_s=tr.window_s)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    result_device["memory_peak_bytes"] = int(peak)

    # the program's state goes before the reference runs
    keep = (fleet.init_pose, fleet.cfg, fleet.S)
    fleet.hooks.remove()
    fleet.state = fleet.step = None
    del fleet
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check.Reference(cell, device, spec.weights_path(cell.config) if "lfnet_weights" in cell.config else None)
    complete = [s for s in samples if s.gn is not None and s.matcher is not None]  # GN and matcher ran
    for s in complete:
        s.move(device)
    rows = [check.compare(s, ref, keep[0], corners) for s in complete]
    numbers = check.worst(rows) if rows else {k: float("inf") for k in check.NUMBERS}
    check_s = time.perf_counter() - t_check
    limits = cell.cell["limits"]
    numbers["gt_err_mm"] = gt_err
    correct = bool(rows) and check.verdict(numbers, limits)
    control_rows = [check.compare(s, ref, keep[0], corners, check.control_candidate(s, ref, keep[0]))
                    for s in complete] if control else []

    if trace:
        ctx = _context(cell, keep, tr, reads, shapes, window_s / n_frames, ref, device)
        for reader in metric_readers(cell.name):
            value = reader.read(ctx)
            if value is not None:
                metrics[reader.NAME] = {"value": float(value), "unit": reader.UNIT}
    else:
        metrics = {
            "frames_per_s": {"value": keep[2] * n_frames / window_s, "unit": "frames/s"},
            "frame_ms_p95": {"value": arith.percentile(frame_ms, 95), "unit": "ms"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    found = forbidden_modules()
    if found:
        print(f"trackbench: the run loaded {', '.join(found)}; no result", file=log)
        return None
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    info = {k: numbers[k] for k in numbers if k not in limits}
    result = {"correct": correct, "attempted": keep[2] * n_frames, "failed": failed, "metrics": metrics,
              "device": result_device}
    if trace:
        result["breakdown"] = tr.breakdown()
    result["info"] = {"samples": len(rows), "frames": n_frames, "window_s": window_s, "setup": setup,
                      "frame_ms": {f"p{q}": arith.percentile(frame_ms, q) for q in (50, 90, 95, 99, 100)},
                      "check_s": check_s, "admitting_frames": admitting,
                      "failed_by_texture": failed_by_texture, **info}
    if control:
        result["rows"] = rows
        result["control"] = check.worst(control_rows)
        result["control_rows"] = control_rows
    result["check"] = checked
    print("info setup " + " ".join(f"{k} {v:.3f}" for k, v in setup.items()), file=log)
    for k, v in info.items():
        print(f"info {k} = {v!r}", file=log)
    for k, v in checked.items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}", file=log)
    return result


def _corners(cell):
    from trackbench.render import corner_points

    return corner_points(float(cell.traffic["box_size"]))


def _traced_stretch(fleet: Run, cell, on_card: bool):
    """Profile `profiled_frames` fleet frames with the spans on; then count
    one frame's device-to-host reads under the sync debug mode."""
    import torch

    from trackbench import trace as tracemod

    n = int(cell.cell["profiled_frames"])
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fleet.hooks.shapes.clear()
    fleet.hooks.spans = True
    if on_card:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "window"):
            for _ in range(n):
                fleet.frame()
            if on_card:
                torch.cuda.synchronize()
    fleet.hooks.spans = False
    path = os.path.join(OUT, f"{cell.name}.trace.json")
    prof.export_chrome_trace(path)
    tr = tracemod.load(path, n)
    os.remove(path)
    reads = None
    if on_card:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                obs = fleet.streams.observation(fleet.t)
                fleet.state, _ = fleet.step(fleet.state, fleet.observe(*obs, fleet.device), fleet.init_pose)
                fleet.t += 1
            finally:
                torch.cuda.set_sync_debug_mode("default")
        reads = sum("synchronizing" in str(w.message) for w in caught)
    return tr, reads, dict(fleet.hooks.shapes)


def _context(cell, keep, tr, reads, shapes, frame_s, ref, device):
    """What the metric readers read."""
    _, cfg, S = keep
    ctx = {"cell": cell.name, "trace": tr, "reads_per_frame": reads, "frame_s": frame_s, "streams": S,
           "shapes": shapes,
           "K": cfg.bundle.max_ba_frames, "N": cfg.frontend.top_k, "D": cfg.frontend.desc_dim,
           "M": cfg.shapes.max_matches, "C": cfg.bundle.dense_src_capacity,
           "iterations": cfg.bundle.num_iter_outer, "trials": cfg.ransac.max_iter,
           "frontend": cfg.frontend.kind, "lfnet_flop": None}
    if cfg.frontend.kind == "lfnet":
        from trackbench.flops import lfnet_flop

        ctx["lfnet_flop"] = lfnet_flop(ref.lfnet, S, cfg.frontend.input_size, device)
    return ctx


def main(argv=None, start=None) -> int:
    import argparse

    start = time.perf_counter() if start is None else start
    ap = argparse.ArgumentParser(description="One run of one trackbench cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), start)
    if result is None:
        return 2
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
