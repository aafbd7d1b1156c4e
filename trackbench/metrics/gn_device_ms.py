"""Device ms per fleet frame of the kernels launched inside the 'gn' span."""

NAME, UNIT, BETTER, SOURCE = "gn_device_ms", "ms", "lower", "device_trace"
LAYER, MOVES, WORKLOADS = "solver", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    s = tr.layer_device_s.get("gn")
    return s / tr.frames * 1e3 if s else None
