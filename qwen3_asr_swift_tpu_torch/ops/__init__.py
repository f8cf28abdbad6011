"""Tensor ops of the port: plain PyTorch, plus the wrappers of the CUDA kernels."""
