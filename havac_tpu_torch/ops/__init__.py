"""Sweep kernels: the CUDA kernel's wrapper and its plain PyTorch version."""
