"""sparsetpu_torch — the PyTorch/CUDA port of ``sparsetpu`` for NVIDIA Hopper.

``sparsetpu`` (JAX/XLA/Pallas on a TPU) stays in the repository as the
reference; this package re-implements it for PyTorch on an H100, one slice
at a time, and is held against it by differential tests.  Module names
mirror the JAX package's, so ``sparsetpu_torch.kernels.spmm`` is the
counterpart of ``sparsetpu.kernels.spmm_pallas`` and so on.

The package imports ``torch`` and numpy only: it never imports ``jax`` or
``sparsetpu`` (importing any ``sparsetpu`` module pulls in jax through its
package ``__init__``).  The numpy-only host helpers it needs are ported, not
imported, and the shared C++ oracle is compiled from its source by path.

Slice 1 covers the headline workload: the A^2..A^7 dense-accumulator chain on
the thinned 30^3 Moore torus, run as ``python -m sparsetpu_torch.bench.chain``.
Slice 2 adds the chain's fold-band form (``kernels.bandplanes``, ``--algo
foldband``) and its group-dot form (``kernels.groupdot``, ``--kernel
group-dot``).  Slice 3 adds the exact-semiring foundation (``semiring``, the
device ``csr.SparseCSR``, ``ops.segments``, the ESC ``ops.spgemm``) and the
attention-scores path on it: dense, element-sparse (ESC) and block-sparse
(``kernels.blocksparse``, the SDD kernel) scores, swept by
``python -m sparsetpu_torch.bench.tipover``.
"""
