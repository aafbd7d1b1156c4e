"""The normal-blocks kernel on the card: bit for bit, device us, wrapper ms, index_add_ beside it, the launch floor.

    python3 -m bundletrack_tpu_torch.blocks_bench

For each case (`CASES`: the tracked frame's K=16 frames and P=120 pairs at
batch 1, 4 and the fleet's 8; 300 pairs of two frames, one output block
with more terms than the kernel lists at a time; 1500 pairs over 16 frames,
more than one tile of pair indices) the kernel's H and g (kernels/
normal_blocks.py, csrc/normal_blocks.cu) must equal its plain version's on
CPU copies of the same inputs bit for bit, twice.  Then CUDA events (median
of 25 after warm-up) time the wrapper `scatter_blocks`, its launch alone
(`_launch`: no checks), and index_add_ alone into H and into g (the rows,
values and outputs made beforehand, as the plain version gathers them); the
profiler gives the device us per call of the kernel and of index_add_
alone, beside the bytes bound (each input read once, H and g written once,
at 3.35 TB/s).  One line gives the card's launch floor: the device us of an
empty kernel, built here with nvcc, at one block of 32 threads and at the
fleet's grid of 2048 blocks of 64, and the host us of its ctypes launch.
Another gives the host us per call at
batch 1 (the host clock over HOST_CALLS calls with no sync between them:
the card keeps up with these short kernels, so this is the time to
enqueue) of the wrapper, `_launch`, index_add_ alone, and the pieces of
the wrapper's host path.

To time another checkout's kernel on the same inputs (e.g. the parent,
unpacked with `git archive` into the git-ignored `_parent/`), run this
script by its path with `--root`, in turns with this checkout:

    python3 bundletrack_tpu_torch/blocks_bench.py --root _parent
"""

from __future__ import annotations

import argparse
import sys

# name: (K, the pair graph's name, batch)
CASES = {
    "K=16 P=120 batch 1": (16, "all_pairs", (1,)),
    "K=16 P=120 batch 4": (16, "all_pairs", (4,)),
    "K=16 P=120 batch 8": (16, "all_pairs", (8,)),
    "K=2 P=300 tiled list": (2, "tiled_list", (1,)),
    "K=16 P=1500 with replacement": (16, "beyond_a_tile", (1,)),
}
PROFILED_CALLS = 10
HOST_CALLS = 200
HBM_BYTES_PER_S = 3.35e12
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def pair_graph(name: str, K: int):
    """(pair_i, pair_j) of a named graph, int64 numpy, seeded."""
    import numpy as np

    rng = np.random.RandomState(0)
    if name == "all_pairs":
        return np.triu_indices(K, k=1)
    if name == "tiled_list":  # most pairs on (0, 0), (0, 1) and (1, 0): ~640 terms on block (0, 0)
        pairs = np.array([(0, 0), (0, 1), (1, 0), (1, 1)])[rng.choice(4, 300, p=[0.4, 0.3, 0.25, 0.05])]
        return pairs[:, 0], pairs[:, 1]
    return rng.randint(0, K, 1500), rng.randint(0, K, 1500)


def case_inputs(K: int, graph: str, batch):
    """(K, pair_i, pair_j, Hii, Hjj, Hij, gi, gj) on the CPU: entries of
    either sign with magnitude 10^U(-3, 3)."""
    import numpy as np
    import torch

    i, j = pair_graph(graph, K)
    rng = np.random.RandomState(1)
    P = len(i)

    def draw(shape):
        return torch.from_numpy((rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32))

    blocks = [draw((*batch, P, 6, 6)) for _ in range(3)] + [draw((*batch, P, 6)) for _ in range(2)]
    return (K, torch.from_numpy(np.asarray(i, np.int64)), torch.from_numpy(np.asarray(j, np.int64)), *blocks)


def bytes_bound_us(K: int, P: int, B: int) -> float:
    """The five block arrays and the pair indices read once, H and g
    written once, at the card's memory rate."""
    floats = B * P * (3 * 36 + 2 * 6) + B * K * (K * 36 + 6)
    return (4 * floats + 2 * 8 * P) / HBM_BYTES_PER_S * 1e6


def _device_us(fn) -> tuple:
    """(device us, kernel launches) per call of fn, from the profiler."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / PROFILED_CALLS, len(kernels) / PROFILED_CALLS


def launch_floor(card: str) -> None:
    """The device us of an empty kernel (built with nvcc into the
    checkout's build directory) at one block and at the fleet's grid."""
    import ctypes
    import os
    import subprocess

    import torch

    from bundletrack_tpu_torch.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src, lib_path = (os.path.join(build.BUILD_DIR, f"empty_kernel.{ext}") for ext in ("cu", "so"))
    with open(src, "w") as f:
        f.write(EMPTY_KERNEL)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib_path, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the empty kernel:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    floors = {}
    for blocks, threads in ((1, 32), (2048, 64)):
        if lib.empty_launch(blocks, threads, stream):
            raise RuntimeError("the empty kernel did not launch")
        floors[(blocks, threads)] = _device_us(lambda: lib.empty_launch(blocks, threads, stream))[0]
    host = _host_us(lambda: lib.empty_launch(1, 32, stream))
    print("launch floor: empty kernel " + ", ".join(f"<<<{b}, {t}>>> {us:.2f} device us" for (b, t), us in
                                                   floors.items()) +
          f"; its ctypes launch (3 arguments) {host:.2f} host us per call [{card}]", flush=True)


def _host_us(fn) -> float:
    """Host us per call of fn, over HOST_CALLS calls after a warm-up, with
    no sync between them."""
    import time

    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - start) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def host_report(card: str) -> None:
    """The host us of the wrapper, `_launch`, index_add_ alone and the
    wrapper's pieces at K=16, P=120, batch 1."""
    import torch

    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    K, graph, batch = CASES["K=16 P=120 batch 1"]
    args = (K, *(t.cuda() for t in case_inputs(K, graph, batch)[1:]))
    dev = args[3].device
    blk, vals, row, gvals = nb.flat_rows(*args)
    H, g = nb._launch(*args)
    nH, nG = H.numel(), g.numel()
    H0, g0 = torch.zeros_like(H).view(-1, 36), torch.zeros_like(g).view(-1, 6)
    ptrs = [t.data_ptr() for t in (*args[1:], H, g)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = nb._library()
    saved = nb.launches
    pieces = {
        "wrapper": lambda: nb.scatter_blocks(*args),
        "_launch": lambda: nb._launch(*args),
        "index_add_ alone": lambda: (H0.index_add_(0, blk, vals), g0.index_add_(0, row, gvals)),
        "ctypes launch alone": lambda: lib.normal_blocks_launch(1, K, len(args[1]), *ptrs, stream),
        "two torch.empty": lambda: (torch.empty(nH, device=dev), torch.empty(nG, device=dev)),
        "one torch.empty split into two views": lambda: [
            t.view(-1) for t in torch.empty(nH + nG, device=dev).split_with_sizes((nH, nG))],
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "9 data_ptr": lambda: [t.data_ptr() for t in (*args[1:], H, g)],
    }
    us = {name: _host_us(fn) for name, fn in pieces.items()}
    nb.launches = saved
    print("host us per call at K=16 P=120 batch 1 (host clock over 200 calls, no sync): " +
          ", ".join(f"{name} {v:.2f}" for name, v in us.items()) + f" [{card}]", flush=True)


def case_report(name: str, card: str) -> bool:
    import numpy as np
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    K, graph, batch = CASES[name]
    cpu = case_inputs(K, graph, batch)
    want = nb.scatter_blocks_reference(*cpu)
    args = (K, *(t.cuda() for t in cpu[1:]))
    equal = []
    for _ in range(2):
        got = nb.scatter_blocks(*args)
        torch.cuda.synchronize()
        equal.append(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)))
    ms = cuda_median_ms(lambda: nb.scatter_blocks(*args))
    launch_ms = cuda_median_ms(lambda: nb._launch(*args))
    blk, vals, row, gvals = nb.flat_rows(*args)
    B, P = int(np.prod(batch)), len(cpu[1])
    H0 = torch.zeros((B * K * K, 36), dtype=vals.dtype, device=vals.device)
    g0 = torch.zeros((B * K, 6), dtype=gvals.dtype, device=gvals.device)
    library = lambda: (H0.index_add_(0, blk, vals), g0.index_add_(0, row, gvals))  # noqa: E731
    library_ms = cuda_median_ms(library)
    us, n = _device_us(lambda: nb._launch(*args))
    lib_us, lib_n = _device_us(library)
    print(f"normal blocks {name} (batch {list(batch)}): equal bits {equal}; wrapper {ms:.4f} ms, _launch "
          f"{launch_ms:.4f} ms, index_add_ alone {library_ms:.4f} ms (CUDA events); device us per call: kernel "
          f"{us:.2f} in {n:.0f} launches, index_add_ alone {lib_us:.2f} in {lib_n:.0f}; bytes bound "
          f"{bytes_bound_us(K, P, B):.3f} us [{card}]", flush=True)
    return all(equal)


def _use_checkout(root: str) -> None:
    """Import the package (kernel, wrapper) from the checkout at `root`: the
    script must run by its path, before the package is loaded."""
    import os

    if "bundletrack_tpu_torch" in sys.modules:
        raise SystemExit("blocks_bench --root: run the script by its path, "
                         "python3 bundletrack_tpu_torch/blocks_bench.py --root DIR")
    sys.path.insert(0, os.path.abspath(root))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="", help="time the kernel of the checkout at this directory on these cases "
                    "(run the script by its path)")
    args = ap.parse_args(argv)
    if args.root:
        _use_checkout(args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("blocks_bench: no CUDA device is available")
    from bundletrack_tpu_torch.cardrun import card_line
    from bundletrack_tpu_torch.kernels import normal_blocks as nb

    card = card_line()
    print(f"card: {card}; kernel from {nb.__file__}")
    launch_floor(card)
    ok = all([case_report(name, card) for name in CASES])
    host_report(card)
    print("normal blocks: " + ("every case equal to the plain version" if ok else "DIFFERS from its plain version"))
    return 0 if ok else 1


if __name__ == "__main__":
    if not __package__:  # run by its path: the checkout's root on the path, not the package's directory
        import os

        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
