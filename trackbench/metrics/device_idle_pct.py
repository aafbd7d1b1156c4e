"""Share of the profiled window in which no device operation ran: one
minus the union of the kernel, copy and fill intervals over the window."""

NAME, UNIT, BETTER, SOURCE = "device_idle_pct", "%", "lower", "device_trace"
LAYER, MOVES, WORKLOADS = "device", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_s > 0 else None
