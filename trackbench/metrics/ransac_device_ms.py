"""Device ms per fleet frame of the kernels launched inside the 'matching' span."""

NAME, UNIT, BETTER, SOURCE = "ransac_device_ms", "ms", "lower", "device_trace"
LAYER, MOVES, WORKLOADS = "matching and RANSAC", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    s = tr.layer_device_s.get("matching")
    return s / tr.frames * 1e3 if s else None
