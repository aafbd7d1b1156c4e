"""The per-layer metrics, one reader per file.

Each module declares NAME, UNIT, BETTER, SOURCE, LAYER, MOVES (the
end-to-end metric it should move) and, where it is not read in every cell,
WORKLOADS; `read(ctx)` returns the value or None when there is nothing to
read.  `ctx` is what the traced run saw (harness._context): "trace" (a
trackbench.trace.Trace of the profiled fleet frames), "frame_s" (seconds
per fleet frame of the untraced window), the cell's sizes, the calls'
shapes under each span, and the LF-Net forward's counted products.
"""
