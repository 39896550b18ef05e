"""The port's K-ary search tree (``sparsetpu_torch.utils.dense_btree``)
against the JAX package's (``sparsetpu.utils.dense_btree``), on the CPU.

- ``DenseBTree`` / ``DenseBTreeList``: the same levels, strides and index
  answers; ``overhead_sweep``'s CSV equal to the JAX package's text.
- The device lookup: the same flat level layout, and (pos, hit) equal to
  the JAX package's and to ``torch.searchsorted`` plus equality, on hits,
  misses, keys at 0 and near the sentinel, padded and unpadded arrays (n a
  power of 16), and a query above every key.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.utils import dense_btree as jbt

from sparsetpu_torch.utils import dense_btree as bt


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 255, 256, 257, 4096, 5000])
def test_host_tree_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, max(4 * n, 8), size=n).astype(np.uint32))
    got, want = bt.DenseBTree.from_sorted(keys), jbt.DenseBTree.from_sorted(keys)
    assert got.strides == want.strides and got.overhead() == want.overhead()
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)
    for probe in np.concatenate([keys, rng.integers(0, max(4 * n, 8) + 3, size=50)]):
        assert got.index(np.uint32(probe)) == want.index(np.uint32(probe))


def test_list_packing_matches_jax():
    rows = [np.array([1, 5, 9], np.uint32), np.array([], np.uint32),
            np.arange(100, dtype=np.uint32)]
    got, want = bt.DenseBTreeList.from_rows(rows), jbt.DenseBTreeList.from_rows(rows)
    np.testing.assert_array_equal(got.data_start, want.data_start)
    for row, key in ((0, 5), (0, 4), (2, 42), (1, 1), (2, 99), (2, 100)):
        assert got.index(row, key) == want.index(row, key)


def test_overhead_sweep_csv_matches_jax():
    assert bt.overhead_sweep() == jbt.overhead_sweep()
    assert bt.overhead_sweep(max_n=500, step=7) == jbt.overhead_sweep(max_n=500, step=7)


@pytest.mark.parametrize("n", [1, 16, 100, 256, 4097])
def test_device_lookup_matches_jax_and_searchsorted(n):
    rng = np.random.default_rng(7 + n)
    keys = np.sort(rng.choice(np.uint32(0xFFFFFFF0), size=n, replace=False).astype(np.uint32))
    keys[0] = 0
    q = np.concatenate([rng.choice(keys, 64), rng.integers(0, 0xFFFFFFF0, 64, dtype=np.uint32),
                        keys[:3] + 1, np.array([0, 0xFFFFFFFE], np.uint32)]).astype(np.uint32)
    levels, padded = bt.build_device_btree(keys, device="cpu")
    jlevels, jpadded = jbt.build_device_btree(keys)
    assert len(levels) == len(jlevels)
    for a, b in zip(levels + [padded], jlevels + [jpadded]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    pos, hit = bt.btree_lookup_device(levels, padded, torch.from_numpy(q.astype(np.int64)))
    jpos, jhit = jbt.btree_lookup_device(jlevels, jpadded, jnp.asarray(q))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    kt = torch.from_numpy(keys.astype(np.int64))
    qt = torch.from_numpy(q.astype(np.int64))
    want_pos = torch.searchsorted(kt, qt)
    want_hit = kt[want_pos.clamp(max=n - 1)] == qt
    assert torch.equal(hit, want_hit)
    # an unpadded array with levels (n a power of 16 above 16) sends a query
    # above every key past n, as JAX's clamped gathers do; every other
    # query lands where searchsorted does
    above = qt > kt[-1]
    assert torch.equal(pos[~above], want_pos[~above])
    if n == 256:
        assert bool((pos[above] > n).all())
    else:
        assert torch.equal(pos[above], want_pos[above])


def test_device_build_takes_a_tensor_on_its_device():
    keys = torch.arange(0, 600, 3)
    levels, padded = bt.build_device_btree(keys)
    assert padded.device.type == "cpu" and padded.numel() == 16 ** 2
    pos, hit = bt.btree_lookup_device(levels, padded, torch.tensor([3, 4, 597, 0]))
    assert pos.tolist() == [1, 2, 199, 0] and hit.tolist() == [True, False, True, True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bt.build_device_btree(np.arange(5, dtype=np.uint32))
