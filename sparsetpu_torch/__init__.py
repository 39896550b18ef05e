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
``python -m sparsetpu_torch.bench.tipover``.  Slices 4-5 add the general
SpGEMM routes (``ops.escb``, ``ops.rowcat`` with the sort-merge kernel,
``ops.slab`` and ``ops.colchunk`` with the coalesce kernel) and the sweep
``python -m sparsetpu_torch.bench.spgemm_bench``.  Slice 6 adds the dense
routes (``ops.denseacc``, ``ops.spmm``), the block-band product
(``kernels.bandmm``, ``ops.hybrid``), ``ops.elementwise``, the
``torch.sparse`` comparator (``utils.bcoo``) and the public router
``spgemm_auto``, so the chain takes every ``bench.py --algo`` and the sweep
all eight of JAX's algorithms.  Slice 7 adds the last ``SparseCSR``
methods (``from_dense_device``, ``get``, ``lookup``, ``transpose``), numpy
copies of ``utils.stdrng``, ``utils.oracle`` and ``einsum.parser``, the
dense int8 pattern engine (``graphs.patterns``, ``torch._int_mm``), the
graph algorithms (``graphs.algos``) and the real-graph study
``python -m sparsetpu_torch.bench.real_graphs``.

The JAX package's doctest, on the CPU (the entry points default to the
card)::

    >>> from sparsetpu_torch import SparseCSR, U64, spgemm_auto
    >>> a = SparseCSR.from_coo_host([0, 0, 1], [1, 2, 2], [1, 2, 3], 3, sr=U64,
    ...                             device="cpu")
    >>> c = spgemm_auto(a, a)          # A^2 on the saturating u64 semiring
    >>> int(c.nnz)
    1
    >>> int(c.get(0, 2))               # one path 0->1->2 of weight 1*3
    3
    >>> from sparsetpu_torch.ops.spgemm import spadd
    >>> s = spadd(a, a)                # elementwise saturating add
    >>> int(s.get(0, 2))
    4
    >>> bad = a.__class__.from_coo_host([0], [0], [2**63], 2, sr=U64, device="cpu")
    >>> int(spgemm_auto(bad, bad).nnz) # 2^126 saturates to u64::MAX
    1
    >>> int(spgemm_auto(bad, bad).get(0, 0)) == 2**64 - 1
    True
"""

from .csr import SparseCSR
from .ops.spgemm import spadd, spgemm, spgemm_auto, symbolic_flops
from .semiring import F32SR, U32, U64, Semiring, by_name

__all__ = ["F32SR", "U32", "U64", "Semiring", "by_name", "SparseCSR", "spadd", "spgemm",
           "spgemm_auto", "symbolic_flops"]
