"""trackbench: the benchmark of the PyTorch and CUDA port (bundletrack_tpu_torch).

Run one cell with `python3 -m trackbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`; see README.md.
"""
