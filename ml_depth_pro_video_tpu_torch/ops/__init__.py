"""Tensor ops; the attention and resblock modules hold the hand-written CUDA kernels beside their plain PyTorch versions."""
