"""The BA matcher's least time over its measured device time: the kernels
launched inside the matcher's span, against arith.matcher_bound_s at each
call's table and pairs (S*K frames, S*P pairs)."""

from trackbench import arith

NAME, UNIT, BETTER, SOURCE = "matcher_roofline_pct", "%", "higher", "device_trace"
LAYER, MOVES, WORKLOADS = "kernels", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    device_s = tr.layer_device_s.get("matcher")
    calls = ctx["shapes"].get("matcher", [])
    if not device_s or not calls:
        return None
    bound = sum(arith.matcher_bound_s(*args[0], args[4][0]) for args in calls)
    return 100.0 * bound / device_s
