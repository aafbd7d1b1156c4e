"""The whole fleet step's share of the card's peak: the least time the
card could spend on the step's counted work (the LF-Net forward's
products, the matcher's bf16 products, RANSAC's trial scoring, the GN
normal equations), each at the published peak of its precision, over the
untraced window's seconds per fleet frame."""

from trackbench import arith

NAME, UNIT, BETTER, SOURCE = "step_mfu_pct", "%", "higher", "host_clock"
LAYER, MOVES, WORKLOADS = "device", "frames_per_s", None


def counted_flop(ctx) -> dict:
    S, K, N, D, M = ctx["streams"], ctx["K"], ctx["N"], ctx["D"], ctx["M"]
    P = K * (K - 1) // 2
    flop = {"bf16": arith.matcher_flop(S * P, N, D),
            "f32": arith.ransac_flop(S * (P + 1), ctx["trials"], M)
            + arith.gn_flop(ctx["iterations"], S * P, M, ctx["C"])}
    for dtype, n in (ctx.get("lfnet_flop") or {}).items():
        flop[dtype] = flop.get(dtype, 0) + n
    return flop


def read(ctx):
    return 100.0 * arith.least_seconds(counted_flop(ctx)) / ctx["frame_s"]
