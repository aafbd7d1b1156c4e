"""The norm statistics' sums kernel on the card: bit for bit, times, bounds, and the bf16 forward.

    python3 -m bundletrack_tpu_torch.sums_bench

For each shape the bf16 LF-Net gives the sums kernel (kernels/norm_sums.py,
csrc/xla_order_sums.cu: the detector's GroupNorms at 400x400, one crop and
the fleet's 8, the descriptor's norms at 512 keypoints, the instance norms
of the photo and of the score maps, and ragged shapes), the kernel's sums
must equal its plain version's bit for bit, twice (the ticket counter is
reset); then each is timed with CUDA events beside torch.sum of the same
tensor, and the profiler gives the device time of its two passes (the
window layout and the chains) beside the least time of the dependent chain
(4 cycles per f32 add at 1.98 GHz; and at the add latency and SM clock the
probe reads on the card: one warp adding a chain of 2^20 dependent f32
adds) and of the bytes.  Last, the 400x400 bf16
LF-Net forward on the shipped weights (`profile_step.lfnet_forward_report`:
launches, device ms, the sums kernel's share).

To compare the forward with another checkout (e.g. the parent, unpacked
with `git archive` into the git-ignored `_parent/`), run in turns from each
checkout's directory `python3 -m bundletrack_tpu_torch.profile_step
--frontend lfnet`, which ends with the same forward report.
"""

from __future__ import annotations

import argparse
import sys

# (shape, per_channel, round_bf16, shift)
CASES = [
    ((1, 16, 400, 400), False, True, False), ((8, 16, 400, 400), False, True, False),
    ((512, 64, 16, 16), False, True, False), ((512, 128, 8, 8), False, True, False),
    ((512, 256, 4, 4), False, True, False), ((512, 512), False, True, False),
    ((4096, 64, 16, 16), False, True, False),
    ((1, 1, 400, 400), True, False, False), ((1, 1, 400, 400), True, False, True),
    ((1, 1, 800, 800), True, False, True), ((1, 1, 283, 283), True, False, False),
    ((1, 1, 200, 200), True, False, True), ((1, 1, 68, 68), True, False, True),
    ((2, 16, 96, 96), False, False, False), ((1, 16, 192, 192), False, True, False),
    ((3, 48, 7, 9), False, False, False),
]
PROFILED_CALLS = 10
PASSES = ("window_layout_kernel", "window_chains_kernel")  # profiler names
ADD_CYCLES, SM_CLOCK_HZ, HBM_BYTES_PER_S = 4, 1.98e9, 3.35e12


def chain_bound_ms(shape, per_channel: bool) -> float:
    """The longest dependent chain of f32 adds: a window, then the window
    partials of its group."""
    import numpy as np

    from bundletrack_tpu_torch.kernels.norm_sums import axis_windows

    B, C, H, W = tuple(shape) + (1, 1) if len(shape) == 2 else tuple(shape)
    win = [axis_windows(n) for n in (H, W, 1 if per_channel else C)]
    chain = int(np.prod([w for w, _, _ in win])) + int(np.prod([nw for _, nw, _ in win]))
    return chain * ADD_CYCLES / SM_CLOCK_HZ * 1e3


def kernel_report(card: str) -> bool:
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    ns.add_probe(1 << 12)  # the first launch loads the module
    cycles, ghz = ns.add_probe()
    print(f"add probe: {cycles:.3f} SM cycles per dependent f32 add, SM clock {ghz:.3f} GHz "
          f"({cycles / ghz:.3f} ns per add) [{card}]", flush=True)
    ok = True
    gen = torch.Generator().manual_seed(0)
    for shape, per_channel, round_bf16, shift in CASES:
        x = torch.randn(shape, generator=gen) * 0.7 + 0.3
        G = shape[0] * (shape[1] if per_channel else 1)
        sh = torch.randn(G, generator=gen) if shift else None
        want = ns.xla_order_sums_reference(x, per_channel, round_bf16, sh)
        xc, shc = x.cuda(), (None if sh is None else sh.cuda())
        equal = []
        for _ in range(2):
            got = ns.xla_order_sums(xc, per_channel, round_bf16, shc)
            torch.cuda.synchronize()
            equal.append(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)))
        ok = ok and all(equal)
        ms = cuda_median_ms(lambda: ns.xla_order_sums(xc, per_channel, round_bf16, shc))
        dims = (2, 3) if per_channel else tuple(range(1, xc.dim()))
        sum_ms = cuda_median_ms(lambda: torch.sum(xc, dim=dims))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_CALLS):
                ns.xla_order_sums(xc, per_channel, round_bf16, shc)
            torch.cuda.synchronize()
        us = {p: 0.0 for p in PASSES}
        for e in prof.events():
            for p in PASSES:
                if p in e.name:
                    us[p] += e.time_range.elapsed_us() / PROFILED_CALLS
        bytes_ms = (4 * x.numel() + 8 * G) / HBM_BYTES_PER_S * 1e3
        chain_us = 1e3 * chain_bound_ms(shape, per_channel)
        print(f"sums {list(shape)} per_channel={per_channel} round_bf16={round_bf16} shift={shift}: equal bits "
              f"{equal}; {ms:.4f} ms (CUDA events), torch.sum {sum_ms:.4f} ms; device us per call: layout "
              f"{us[PASSES[0]]:.2f}, chains {us[PASSES[1]]:.2f}; "
              f"bounds: chain {chain_us:.2f} us ({chain_us * cycles / ADD_CYCLES * SM_CLOCK_HZ / 1e9 / ghz:.2f} at "
              f"the probe's latency and clock), bytes {1e3 * bytes_ms:.2f} us [{card}]", flush=True)
    print("sums kernel: " + ("every case equal to the plain version" if ok else "DIFFERS from its plain version"))
    return ok


def forward_report(card: str) -> None:
    from bundletrack_tpu_torch.cardrun import render_main_sequence, shipped_lfnet, with_lfnet
    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.profile_step import lfnet_forward_report

    cfg = with_lfnet(TrackerConfig())
    rep = lfnet_forward_report(shipped_lfnet(cfg), cfg, render_main_sequence(2), card)
    print(f"forward: {rep['median_ms']:.4f} ms (CUDA events), "
          f"{rep['device_ms_per_forward']:.4f} device ms, {rep['launches_per_forward']:.0f} launches [{card}]")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sums_bench: no CUDA device is available")
    from bundletrack_tpu_torch.cardrun import card_line

    card = card_line()
    print(f"card: {card}")
    ok = kernel_report(card)
    forward_report(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
