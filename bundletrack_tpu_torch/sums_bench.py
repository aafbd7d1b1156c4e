"""The norm statistics' sums kernel on the card: bit for bit, times, bounds, and the bf16 forward.

    python3 -m bundletrack_tpu_torch.sums_bench

For each shape the bf16 LF-Net gives the sums kernel (kernels/norm_sums.py,
csrc/xla_order_sums.cu: the detector's GroupNorms at 400x400, one crop and
the fleet's 8, the descriptor's norms at 512 keypoints and at the fleet's
4096, the instance norms of the photo and of the score maps, and ragged
shapes), the kernel's sums
must equal its plain version's bit for bit, twice (the ticket counters are
reset); then each is timed with CUDA events beside torch.sum of the same
tensor, and the profiler gives the device time of its launch beside
the least time of the dependent chain (4 cycles per f32 add at 1.98 GHz;
and at the add latency and SM clock the probe reads on the card: one warp
adding a chain of 2^20 dependent f32 adds) and of the bytes.  The same for
the instance norms' statistics of the lists the forward gives them in one
launch (`INSTANCE_CASES`: the photo, the five score maps, the fleet's 8
crops' of both), beside torch.var_mean of each map.  Last, the 400x400
bf16 LF-Net forward on the shipped weights
(`profile_step.lfnet_forward_report`: launches, device ms, the sums
kernel's share), and the fleet's batched forward of 8 crops (the same
figures).

To time another checkout's kernel on these cases (e.g. the parent,
unpacked with `git archive` into the git-ignored `_parent/`), run this
script by its path with `--root`, in turns with this checkout:

    python3 bundletrack_tpu_torch/sums_bench.py --root _parent

Device us count every kernel a call launches (a checkout whose wrapper
makes two launches per call, or computes the instance statistics map by
map with two sums calls each, is timed whole).
"""

from __future__ import annotations

import argparse
import sys

# (shape, per_channel, round_bf16, shift)
CASES = [
    ((1, 16, 400, 400), False, True, False), ((8, 16, 400, 400), False, True, False),
    ((512, 64, 16, 16), False, True, False), ((512, 128, 8, 8), False, True, False),
    ((512, 256, 4, 4), False, True, False), ((512, 512), False, True, False),
    ((4096, 64, 16, 16), False, True, False), ((4096, 128, 8, 8), False, True, False),
    ((4096, 256, 4, 4), False, True, False), ((4096, 512), False, True, False),
    ((1, 1, 400, 400), True, False, False), ((1, 1, 400, 400), True, False, True),
    ((1, 1, 800, 800), True, False, True), ((1, 1, 283, 283), True, False, False),
    ((1, 1, 200, 200), True, False, True), ((1, 1, 68, 68), True, False, True),
    ((2, 16, 96, 96), False, False, False), ((1, 16, 192, 192), False, True, False),
    ((3, 48, 7, 9), False, False, False),
]
# the instance norms' statistics of a 400x400 forward, one launch per list:
# the photo, then the five score maps (input x 0.5 ... 2); the fleet's 8 crops
SCORE_SIZES = (200, 283, 400, 566, 800)
INSTANCE_CASES = {
    "photo": [(1, 1, 400, 400)], "score maps": [(1, 1, n, n) for n in SCORE_SIZES],
    "fleet photo": [(8, 1, 400, 400)], "fleet score maps": [(8, 1, n, n) for n in SCORE_SIZES],
}
PROFILED_CALLS = 10
PASSES = ("xla_order_sums_kernel",)  # the profiler's name of the kernel: one launch per call
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


def instance_chain_bound_ms(shapes) -> float:
    """The instance statistics' longest dependent chain: per map a window,
    then its group's window partials, twice (the sums, then the squares)."""
    return max(2 * chain_bound_ms(shape, True) for shape in shapes)


def _device_us(fn) -> tuple:
    """(device us per call of fn, of it in the sums kernel (`PASSES`), launches
    per call): every kernel fn launches, from the profiler."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels)
    sums = sum(e.time_range.elapsed_us() for e in kernels if any(p in e.name for p in PASSES))
    return total / PROFILED_CALLS, sums / PROFILED_CALLS, len(kernels) / PROFILED_CALLS


def _instance_stats(ns):
    """The instance statistics of a list of maps as `ns` (a norm_sums module)
    computes them: one launch, or, in a checkout without
    `xla_order_instance_stats`, per map the two sums calls and the two
    products instance_norm made there."""
    if hasattr(ns, "xla_order_instance_stats"):
        return ns.xla_order_instance_stats
    from bundletrack_tpu_torch.ops.numerics import reciprocal_f32

    def per_map(maps):
        means, variances = [], []
        for x in maps:
            inv = reciprocal_f32(x.shape[2] * x.shape[3])
            mu = ns.xla_order_sums(x, per_channel=True)[0] * inv
            means.append(mu.view(x.shape[:2]))
            variances.append((ns.xla_order_sums(x, per_channel=True, shift=mu)[1] * inv).view(x.shape[:2]))
        return means, variances

    return per_map


def instance_report(card: str, cycles: float, ghz: float) -> bool:
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms
    from bundletrack_tpu_torch.kernels import norm_sums as ns

    ok = True
    gen = torch.Generator().manual_seed(1)
    for name, shapes in INSTANCE_CASES.items():
        xs = [torch.rand(s, generator=gen) * 0.8 - 0.1 for s in shapes]
        stats = _instance_stats(ns)
        want = stats(xs)  # on the CPU: the plain version
        xc = [x.cuda() for x in xs]
        equal = []
        for _ in range(2):
            got = stats(xc)
            torch.cuda.synchronize()
            equal.append(all(torch.equal(a.cpu(), b) for g, w in zip(got, want) for a, b in zip(g, w)))
        ok = ok and all(equal)
        ms = cuda_median_ms(lambda: stats(xc))
        lib_ms = cuda_median_ms(lambda: [torch.var_mean(x, dim=(2, 3), unbiased=False) for x in xc])
        us, _, n = _device_us(lambda: stats(xc))
        chain_us = 1e3 * instance_chain_bound_ms(shapes)
        bytes_us = 1e3 * sum(4 * x.numel() + 8 * x.shape[0] * x.shape[1] for x in xs) / HBM_BYTES_PER_S * 1e3
        print(f"instance stats {name} {[list(s) for s in shapes]}: equal bits {equal}; {ms:.4f} ms (CUDA events), "
              f"torch.var_mean per map {lib_ms:.4f} ms; device us per call: {us:.2f} in {n:.0f} launches; bounds: chain "
              f"{chain_us:.2f} us ({chain_us * cycles / ADD_CYCLES * SM_CLOCK_HZ / 1e9 / ghz:.2f} at the probe's "
              f"latency and clock), bytes {bytes_us:.2f} us [{card}]", flush=True)
    return ok


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
        us, _, n = _device_us(lambda: ns.xla_order_sums(xc, per_channel, round_bf16, shc))
        bytes_ms = (4 * x.numel() + 8 * G) / HBM_BYTES_PER_S * 1e3
        chain_us = 1e3 * chain_bound_ms(shape, per_channel)
        print(f"sums {list(shape)} per_channel={per_channel} round_bf16={round_bf16} shift={shift}: equal bits "
              f"{equal}; {ms:.4f} ms (CUDA events), torch.sum {sum_ms:.4f} ms; device us per call: {us:.2f} in {n:.0f} launches; "
              f"bounds: chain {chain_us:.2f} us ({chain_us * cycles / ADD_CYCLES * SM_CLOCK_HZ / 1e9 / ghz:.2f} at "
              f"the probe's latency and clock), bytes {1e3 * bytes_ms:.2f} us [{card}]", flush=True)
    ok = instance_report(card, cycles, ghz) and ok
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


def fleet_forward_report(card: str, crops: int = 8) -> None:
    """The batched forward of the fleet's crops (frames 0..crops-1's masked
    ROI crops, [crops, S, S, 1]): CUDA-event ms, device ms, launches and the
    sums kernel's share (its names as the checkout's profile_step gives them)."""
    import torch

    from bundletrack_tpu_torch.cardrun import cuda_median_ms, masked_crop, render_main_sequence, shipped_lfnet, \
        with_lfnet
    from bundletrack_tpu_torch.config import TrackerConfig
    from bundletrack_tpu_torch.profile_step import SUMS_KERNELS

    cfg = with_lfnet(TrackerConfig())
    lfnet, S = shipped_lfnet(cfg), cfg.frontend.input_size
    seq = render_main_sequence(crops)
    batch = torch.stack([masked_crop(seq, f, S) for f in range(crops)])[..., None]
    fwd = lambda: lfnet(batch)  # noqa: E731
    ms = cuda_median_ms(fwd)
    torch.cuda.synchronize()
    n_prof = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fwd()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_prof
    sums = [e for e in kernels if any(k in e.name for k in SUMS_KERNELS)]
    sums_ms = sum(e.time_range.elapsed_us() for e in sums) / 1e3 / n_prof
    print(f"fleet forward, {crops} crops at {S}x{S} bf16 in one batch: {ms:.4f} ms (CUDA events), {device_ms:.4f} "
          f"device ms, {len(kernels) / n_prof:.0f} launches; sums kernel ({' + '.join(SUMS_KERNELS)}) "
          f"{sums_ms:.4f} ms in {len(sums) / n_prof:.0f} launches [{card}]")


def _use_checkout(root: str) -> None:
    """Import the package (kernel, wrappers, forward) from the checkout at
    `root`: the script must run by its path, before the package is loaded."""
    import os

    if "bundletrack_tpu_torch" in sys.modules:
        raise SystemExit("sums_bench --root: run the script by its path, "
                         "python3 bundletrack_tpu_torch/sums_bench.py --root DIR")
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
        raise SystemExit("sums_bench: no CUDA device is available")
    from bundletrack_tpu_torch.cardrun import card_line

    card = card_line()
    print(f"card: {card}")
    ok = kernel_report(card)
    forward_report(card)
    fleet_forward_report(card)
    return 0 if ok else 1


if __name__ == "__main__":
    if not __package__:  # run by its path: the checkout's root on the path, not the package's directory
        import os

        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
