"""Device-to-host synchronisations of one fleet frame (upload and step),
counted by torch's sync debug mode."""

NAME, UNIT, BETTER, SOURCE = "host_reads_per_frame", "reads", "lower", "program_counter"
LAYER, MOVES, WORKLOADS = "fleet step", "frames_per_s", None


def read(ctx):
    return ctx["reads_per_frame"]
