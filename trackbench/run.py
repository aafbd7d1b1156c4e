"""Entry point: `python3 -m trackbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`.

Prints one JSON object as the last line of standard output, and the
numbers that decide `correct`, each beside its limit, as the last lines of
standard error.  Exits 2, with no result, without the CUDA devices the
cell needs or if JAX, Flax or the JAX package was loaded.
"""

import time

START = time.perf_counter()

import sys  # noqa: E402

from trackbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(start=START))
