"""A cell cut to a size the CPU tests can run: 120x160, 2 streams, small
capacities.  For the tests only; the benchmark's cells are never cut."""

TINY = {
    "image": {"H": 120, "W": 160},
    "tracker": {"shapes": {"max_matches": 64, "max_landmarks": 256, "image_h": 120, "image_w": 160},
                "bundle": {"max_ba_frames": 4, "dense_src_capacity": 256},
                "ransac": {"max_iter": 128}, "keyframe": {"pool_size": 8},
                "frontend": {"top_k": 128, "input_size": 96}},
    "traffic": {"streams": 2, "directions": [1, -1]},
    "cell": {"warmup_frames": 3, "samples": 2, "sample_frames": 3, "profiled_frames": 2},
}
SEED = 2**31 + 17


def tiny_run(workload="classical.s8", seed=SEED, trace=False, fault=None, control=False):
    import io
    import time

    import torch

    from trackbench import harness

    torch.set_num_threads(1)  # the tests run in several workers at once

    return harness.run(workload, seed, 0.5, trace, time.perf_counter(), device="cpu", overrides=TINY,
                       fault=fault, control=control, log=io.StringIO())
