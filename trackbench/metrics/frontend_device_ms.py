"""Device ms per fleet frame of the kernels launched inside the 'frontend' span."""

NAME, UNIT, BETTER, SOURCE = "frontend_device_ms", "ms", "lower", "device_trace"
LAYER, MOVES, WORKLOADS = "frontend", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    s = tr.layer_device_s.get("frontend")
    return s / tr.frames * 1e3 if s else None
