"""The Moore torus thinned as the reference thins it, renamed by a symmetry
of the lattice drawn from the run's seed.

The thinning draws come from the reference's generator,
``StdRng::from_seed([thin_seed; 32])`` (``frozen.thin_reference``), so the
graph is the reference's matrix and every run multiplies it: the same
entry counts and products, so the seed does not change the work.  The run's seed picks an axis order, a reflection
of each axis and a translation; each maps the lattice onto itself, so the
renamed graph is another subgraph of the same lattice with the same band
structure, its entries in another order.
"""

from __future__ import annotations

import numpy as np

from spbench import frozen


def symmetry(dims, seed: int) -> np.ndarray:
    """perm[i]: node i's index after an automorphism of the torus drawn from
    ``seed`` (axes are permuted only among axes of equal length)."""
    dims = np.asarray(dims, np.int64)
    rng = np.random.default_rng(seed)
    axes = rng.permutation(len(dims)) if np.all(dims == dims[0]) else np.arange(len(dims))
    flip = rng.choice(np.array([-1, 1]), size=len(dims))
    shift = rng.integers(0, dims)
    coords = np.stack(np.unravel_index(np.arange(int(dims.prod())), tuple(dims)), axis=-1)
    new = (coords[:, axes] * flip + shift) % dims
    return np.ravel_multi_index(tuple(new.T), tuple(dims))


def build(cfg: dict, seed: int):
    rows, cols, vals, n = frozen.lattice(cfg["dims"], torus=True)
    rng = frozen.StdRng(bytes([cfg["thin_seed"]]) * 32)
    coo = frozen.dedup_coo(n, *frozen.thin_reference(rows, cols, vals, cfg["density"], rng))
    return frozen.relabel(coo, symmetry(cfg["dims"], seed))
