"""Host ms per fleet frame inside the Gauss-Newton solve's span: where the
host-launch bound shows."""

NAME, UNIT, BETTER, SOURCE = "gn_span_ms", "ms", "lower", "program_span"
LAYER, MOVES, WORKLOADS = "solver", "frames_per_s", None


def read(ctx):
    tr = ctx["trace"]
    s = tr.span_s.get("gn")
    return s / tr.frames * 1e3 if s else None
