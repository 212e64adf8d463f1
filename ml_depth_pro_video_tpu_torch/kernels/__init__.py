"""Build and binding of the CUDA kernels under ``csrc/``."""
