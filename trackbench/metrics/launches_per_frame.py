"""Kernel launches per fleet frame in the profiled frames."""

NAME, UNIT, BETTER, SOURCE = "launches_per_frame", "launches", "lower", "device_trace"
LAYER, MOVES, WORKLOADS = "fleet step", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    return len(tr.kernels) / tr.frames if tr.kernels else None
