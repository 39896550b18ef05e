"""Kernels of the port: hand-written CUDA kernels with their plain PyTorch
versions, and the block-band product (``bandmm``), plain torch as the JAX
package's is XLA."""
