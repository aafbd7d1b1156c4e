"""The norm-sums kernel's least time over its measured device time in the
LF-Net forward: every call inside the sums span, bytes (the input once,
two floats per group) against f32 operations, by arith.sums_bound_s."""

import math

from trackbench import arith

NAME, UNIT, BETTER, SOURCE = "sums_roofline_pct", "%", "higher", "device_trace"
LAYER, MOVES, WORKLOADS = "kernels", "frames_per_s", ["lfnet.s8"]


def call_bound_s(args) -> float:
    first = args[0]
    if isinstance(first, list):  # the instance statistics of a list of [B, C, H, W] maps
        n = sum(math.prod(s) for s in first)
        return arith.sums_bound_s(n, sum(s[0] * s[1] for s in first), 4)
    return arith.sums_bound_s(math.prod(first), first[0], 3)  # one group per sample


def read(ctx):
    tr = ctx["trace"]
    device_s = tr.layer_device_s.get("sums")
    calls = ctx["shapes"].get("sums", [])
    if not device_s or not calls:
        return None
    return 100.0 * sum(call_bound_s(args) for args in calls) / device_s
