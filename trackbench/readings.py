"""The readings that the limits of `correct` are set from (PERF.md §2).

    python3 -m trackbench.readings --workload <cell> --seeds <n> ... [--control]
        [--seconds S]

Runs the cell once per seed in one process (set-up shared where it can
be: the imports, the card, the built kernels), each with a short window
that reaches the cell's sampled frames, and prints per seed one JSON line
with the program's numbers against the reference and, with --control,
the control's numbers on the same samples: the reference computed one
precision below the configuration's (reference/precision.py) in the
program's place.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from trackbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False, t, control=args.control)
        if res is None:
            return 2
        line = {"seed": seed, "correct": res["correct"], "failed": res["failed"], "info": res["info"],
                "program": {k: v["value"] for k, v in res["check"].items()}}
        if args.control:
            line.update(control=res["control"], rows=res["rows"], control_rows=res["control_rows"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
