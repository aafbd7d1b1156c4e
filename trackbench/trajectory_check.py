"""Track a benchmark cell's streams for a fixed count of fleet frames and
keep every frame's poses and statuses, to hold two checkouts to the same
trajectory bit for bit.  From the root of each checkout (for an older one,
copy this file into its trackbench/ first):

    python3 -m trackbench.trajectory_check --workload classical.s8 --seed N --out a.npz
    python3 -m trackbench.trajectory_check --compare a.npz b.npz

A run builds the cell's fleet as the benchmark does (`trackbench.harness.Run`:
the seed's streams, configuration and initial state), tracks `--frames`
fleet frames (default 524: the cell's 124 warm-up frames and 400 more) on
the card, and writes to `--out` the poses [F, S, 4, 4], the statuses
[F, S], and a JSON line of what it saw: the card, the seconds per frame,
the device memory (at the end: allocated at most, reserved, reserved at
most, and reserved in the CUDA graphs' private pools), and the program's
counters over the frames after the warm-up (`gn.replays` / `gn.solves` is
the share of the streams' solves that replayed a CUDA graph).  `--compare` prints where two runs part, if they do, and each run's failed
stream-frames (a status other than OK, or a pose that is not finite, as
the benchmark counts them) per `--bucket` frames after the warm-up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def track(workload: str, seed: int, frames: int, out: str) -> dict:
    """Track `frames` fleet frames of the cell; write them to `out`."""
    import torch

    from bundletrack_tpu_torch.cardrun import card_line
    from bundletrack_tpu_torch.utils.profiling import counters
    from trackbench import spec
    from trackbench.harness import Run

    if not torch.cuda.is_available():
        raise SystemExit("trajectory_check: no CUDA device is available")
    torch.set_num_threads(1)  # as the benchmark runs the cell
    cell = spec.load_cell(workload)
    warmup = int(cell.cell["warmup_frames"])
    fleet = Run(cell, seed, torch.device("cuda", 0))
    poses, status, before = [], [], None
    t0 = time.perf_counter()
    for i in range(frames):
        if i == warmup:
            torch.cuda.synchronize()
            before, t0 = counters(), time.perf_counter()
        pose, st = fleet.frame()
        poses.append(pose)
        status.append(st)
    seconds = time.perf_counter() - t0
    after = counters()
    counted = {k: after[k] - before[k] for k in sorted(after)} if before is not None else {}
    meta = {"workload": workload, "seed": seed, "frames": frames, "warmup": warmup, "card": card_line(),
            "ms_per_frame_after_warmup": 1e3 * seconds / max(frames - warmup, 1),
            "counters_after_warmup": counted, **memory_gib()}
    np.savez(out, poses=np.stack(poses), status=np.stack(status), meta=json.dumps(meta))
    return meta


def memory_gib() -> dict:
    """The card's memory now, in GiB: allocated at most, reserved, reserved
    at most, and the part of the reserved memory that private pools (the
    CUDA graphs') hold."""
    import torch

    segments = torch.cuda.memory_snapshot()
    private = sum(s["total_size"] for s in segments if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    return {"peak_mem_gib": torch.cuda.max_memory_allocated() / 2.0**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2.0**30,
            "max_reserved_gib": torch.cuda.max_memory_reserved() / 2.0**30,
            "graph_pools_gib": private / 2.0**30}


def _failed(run) -> np.ndarray:
    """[F, S] bool: the stream-frames the benchmark counts as failed."""
    return (run["status"] != 0) | ~np.isfinite(run["poses"]).all(axis=(-2, -1))


def compare(a_path: str, b_path: str, bucket: int) -> bool:
    """Print where two runs part and their failures per bucket; True if
    their poses and statuses are equal bit for bit on every frame."""
    a, b = np.load(a_path), np.load(b_path)
    warmup = json.loads(str(a["meta"]))["warmup"]
    n = min(len(a["status"]), len(b["status"]))
    pa, pb = a["poses"][:n], b["poses"][:n]
    frame_eq = (pa.view(np.uint32) == pb.view(np.uint32)).all(axis=(1, 2, 3)) & \
        (a["status"][:n] == b["status"][:n]).all(axis=1)
    same = bool(frame_eq.all())
    first = None if same else int(np.argmin(frame_eq))
    print(f"{n} fleet frames: poses and statuses equal bit for bit on {int(frame_eq.sum())}; "
          f"first frame that differs: {first}")
    for path, run in ((a_path, a), (b_path, b)):
        fail = _failed(run)[warmup:n]
        per = [int(fail[i:i + bucket].sum()) for i in range(0, len(fail), bucket)]
        print(f"{path}: failed stream-frames in warm-up {int(_failed(run)[:warmup].sum())}, after it "
              f"{int(fail.sum())} of {fail.size}; per {bucket} frames {per}")
        print(f"  {str(run['meta'])}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="classical.s8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=524)
    ap.add_argument("--out", default="")
    ap.add_argument("--compare", nargs=2, metavar="NPZ")
    ap.add_argument("--bucket", type=int, default=40)
    args = ap.parse_args(argv)
    if args.compare:
        return 0 if compare(*args.compare, args.bucket) else 1
    if not args.out:
        raise SystemExit("trajectory_check: --out is required for a run")
    print(json.dumps(track(args.workload, args.seed, args.frames, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
