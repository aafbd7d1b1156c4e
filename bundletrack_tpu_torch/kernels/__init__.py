"""Hand-written CUDA kernels (built from csrc/ with nvcc) and their plain versions."""
