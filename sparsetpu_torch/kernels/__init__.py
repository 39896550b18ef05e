"""Kernels of the port: hand-written CUDA kernels with their plain PyTorch versions."""
