"""The port's sort-merge (sparsetpu_torch.kernels.sortmerge) against the JAX
package's Pallas kernel (sparsetpu.kernels.sortmerge, interpret mode on the
CPU, as tests/test_sortmerge.py runs it).

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it and against the plain form of its own formulation (packed keys,
``sortmerge_rows_keys_reference``) where a card is present (marker
``cuda``).  Tolerances: u32/u64 and integer-valued f32 bit for bit; f32 of
normal values 1e-5 relative (the two packages add a column's products in
different orders).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sparsetpu.kernels import sortmerge as jsm

from sparsetpu_torch.kernels import sortmerge as psm
from sparsetpu_torch.ops.segments import INT32_SENTINEL

NLIMBS = {"u64": 2, "u32": 1, "f32": 1}


def _case(R, L, n_cols, sr_name, seed, sentinel_frac=0.3, normal=False):
    """(cols int32, limbs) in JAX's form: uint32 limbs, or float32."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_cols, (R, L)).astype(np.int32)
    sent = rng.random((R, L)) < sentinel_frac
    cols[sent] = INT32_SENTINEL
    if sr_name == "f32":
        vals = (rng.standard_normal((R, L)) if normal
                else rng.integers(0, 50, (R, L))).astype(np.float32)
        vals[sent] = 0.0
        return cols, [vals]
    lo = rng.integers(0, 1 << 32, (R, L), dtype=np.uint64).astype(np.uint32)
    lo[sent] = 0
    if sr_name == "u32":
        return cols, [lo]
    hi = rng.integers(0, 1 << 32, (R, L), dtype=np.uint64).astype(np.uint32)
    hi[sent] = 0
    return cols, [lo, hi]


def _jax(cols, limbs, sr_name):
    c, l = jsm.sortmerge_rows(jnp.asarray(cols), tuple(jnp.asarray(x) for x in limbs), sr_name)
    return np.asarray(c), [np.asarray(x) for x in l]


def _port(cols, limbs, sr_name, fn=psm.sortmerge_rows, device="cpu"):
    dtype = torch.float32 if sr_name == "f32" else torch.int64
    c, l = fn(torch.tensor(cols, device=device),
              tuple(torch.tensor(x.astype(np.float32 if sr_name == "f32" else np.int64),
                                 dtype=dtype, device=device) for x in limbs), sr_name)
    return c.cpu().numpy(), [x.cpu().numpy() for x in l]


def _assert_same(got, want, sr_name, rtol=0.0):
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w)


def _special_rows(L, sr_name):
    """8 rows: two all sentinels, two of one column at the largest values
    (the u32/u64 sums saturate), two with a single product (the second
    zero, so dropped), two of one column and value 1."""
    cols = np.full((8, L), INT32_SENTINEL, np.int32)
    top = 49 if sr_name == "f32" else 0xFFFFFFFF
    vals = np.zeros((8, L), np.float32 if sr_name == "f32" else np.uint32)
    cols[2:4], vals[2:4] = 5, top
    cols[4, L // 3], vals[4, L // 3] = 9, 7
    cols[5, L - 1] = 11
    cols[6:8], vals[6:8] = 3, 1
    return cols, [vals] * NLIMBS[sr_name]


@pytest.fixture(scope="module")
def jax_rows():
    """(sr_name, L) -> (cols, limbs, JAX's result) on 24 rows: 16 random
    ones (few columns: long runs of duplicates, and the u64 sums saturate)
    above the 8 special rows; one interpret-mode call each, shared."""
    cache = {}

    def get(sr_name, L):
        if (sr_name, L) not in cache:
            cols, limbs = _case(16, L, 40, sr_name, seed=L + len(sr_name))
            s_cols, s_limbs = _special_rows(L, sr_name)
            cols = np.concatenate([cols, s_cols])
            limbs = [np.concatenate([x, y]) for x, y in zip(limbs, s_limbs)]
            cache[sr_name, L] = cols, limbs, _jax(cols, limbs, sr_name)
        return cache[sr_name, L]

    return get


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("sr_name", ["u64", "u32", "f32"])
def test_sortmerge_matches_jax(sr_name, L, jax_rows):
    cols, limbs, want = jax_rows(sr_name, L)
    got = _port(cols[:16], [x[:16] for x in limbs], sr_name)
    _assert_same(got, (want[0][:16], [x[:16] for x in want[1]]), sr_name)


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("sr_name", ["u64", "u32", "f32"])
def test_packed_key_formulation_matches_jax(sr_name, L, jax_rows):
    """The kernel's formulation (one (column << 32) | slot key a slot, the
    pack as a scan of the keep flags) against JAX's kernel, with saturating,
    all-sentinel and single-product rows."""
    cols, limbs, want = jax_rows(sr_name, L)
    got = _port(cols, limbs, sr_name, fn=psm.sortmerge_rows_keys_reference)
    _assert_same(got, want, sr_name)
    assert (got[0][16:18] == INT32_SENTINEL).all()
    assert (got[0][18:20, 0] == 5).all() and (got[0][18:20, 1:] == INT32_SENTINEL).all()
    top = 49 * L if sr_name == "f32" else 0xFFFFFFFF
    assert all((x[18:20, 0] == top).all() for x in got[1])
    assert [int(c) for c in got[0][20:22, 0]] == [9, INT32_SENTINEL]


@pytest.mark.parametrize("sr_name", ["u64", "u32", "f32"])
def test_packed_keys_equal_the_plain_version_at_any_length(sr_name):
    """Both plain versions agree bit for bit at lengths JAX's kernel does not
    take (1, 2, 48, 96), with negative columns (signed order) and ties."""
    for R, L in ((7, 1), (5, 2), (6, 48), (3, 96)):
        cols, limbs = _case(R, L, 9, sr_name, seed=R * L)
        cols[0, : L // 2 + 1] = -3 - np.arange(L // 2 + 1)
        _assert_same(_port(cols, limbs, sr_name, fn=psm.sortmerge_rows_keys_reference),
                     _port(cols, limbs, sr_name, fn=psm.sortmerge_rows_reference), sr_name)


def test_sortmerge_f32_normal_values_match_jax():
    cols, limbs = _case(16, 128, 40, "f32", seed=5, normal=True)
    _assert_same(_port(cols, limbs, "f32"), _jax(cols, limbs, "f32"), "f32", rtol=1e-5)


@pytest.mark.parametrize("sr_name", ["u64", "u32"])
def test_sortmerge_saturation_matches_jax(sr_name):
    cols = np.full((8, 128), 7, np.int32)
    limbs = [np.full((8, 128), 0xFFFFFFFF, np.uint32)]
    if sr_name == "u64":
        limbs.append(np.full((8, 128), 0xFFFFFFF0, np.uint32))
    got = _port(cols, limbs, sr_name)
    _assert_same(got, _jax(cols, limbs, sr_name), sr_name)
    assert (got[0][:, 0] == 7).all() and (got[0][:, 1:] == INT32_SENTINEL).all()
    assert all((x[:, 0] == 0xFFFFFFFF).all() for x in got[1])


def test_sortmerge_all_sentinel_and_single_product_rows():
    cols = np.full((8, 128), INT32_SENTINEL, np.int32)
    lo = np.zeros((8, 128), np.uint32)
    hi = np.zeros((8, 128), np.uint32)
    # rows 4..7 hold one product each, at varying lanes; row 7's is zero
    for r, lane in ((4, 0), (5, 63), (6, 127), (7, 10)):
        cols[r, lane] = 3 * r
        lo[r, lane] = 11 if r < 7 else 0
        hi[r, lane] = 2
    hi[7, 10] = 0
    got = _port(cols, [lo, hi], "u64")
    _assert_same(got, _jax(cols, [lo, hi], "u64"), "u64")
    assert (got[0][:4] == INT32_SENTINEL).all() and (got[0][7] == INT32_SENTINEL).all()
    assert [int(c) for c in got[0][4:7, 0]] == [12, 15, 18]


def test_wrapper_on_cpu_is_the_plain_version_at_any_length():
    # the plain version takes any L; the kernel's range is a power of two
    # up to MAX_L
    cols, limbs = _case(5, 48, 9, "u32", seed=3)
    got = _port(cols, limbs, "u32")
    want = _port(cols, limbs, "u32", fn=psm.sortmerge_rows_reference)
    _assert_same(got, want, "u32")
    assert psm.available(1, 1) and psm.available(16384, 2) and psm.available(64, 1)
    assert not psm.available(32768, 2) and not psm.available(96, 1)
    assert not psm.available(128, 3)


def test_wrapper_rejects_bad_inputs():
    cols = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        psm.sortmerge_rows(cols, (torch.zeros(4, 8, dtype=torch.int64),), "u64")
    with pytest.raises(ValueError):
        psm.sortmerge_rows(cols, (torch.zeros(4, 8, dtype=torch.int32),), "u32")
    with pytest.raises(ValueError):
        psm.sortmerge_rows(cols.long(), (torch.zeros(4, 8),), "f32")
    with pytest.raises(ValueError):
        psm.sortmerge_rows(cols, (torch.zeros(4, 9),), "f32")


@pytest.mark.cuda
def test_cuda_sortmerge_kernel_matches_plain_version():
    """The kernel against its plain version on the card, every semiring, at
    every L it takes (one or several rows a block), with ragged row counts;
    saturation; a refused L."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for sr_name in ("u64", "u32", "f32"):
        for k in range(15):
            L = 1 << k
            for R in (1, 7, 33):
                cols, limbs = _case(R, L, max(L // 3, 2), sr_name, seed=k * 7 + R)
                before = psm.LAUNCHES
                got = _port(cols, limbs, sr_name, device="cuda")
                assert psm.LAUNCHES == before + 1
                for fn in (psm.sortmerge_rows_reference, psm.sortmerge_rows_keys_reference):
                    _assert_same(got, _port(cols, limbs, sr_name, fn=fn, device="cuda"),
                                 sr_name)
    cols = np.full((3, 4096), 7, np.int32)
    limbs = [np.full((3, 4096), 0xFFFFFFFF, np.uint32)] * 2
    got = _port(cols, limbs, "u64", device="cuda")
    assert (got[0][:, 0] == 7).all() and (got[1][1][:, 0] == 0xFFFFFFFF).all()
    with pytest.raises(ValueError):
        psm.sortmerge_rows(torch.zeros(2, 32768, dtype=torch.int32, device="cuda"),
                           (torch.zeros(2, 32768, device="cuda"),), "f32")


@pytest.mark.cuda
def test_cuda_sortmerge_kernel_special_rows_at_every_length():
    """All-sentinel, saturating and single-product rows, one random row
    with negative columns and one with columns past 2^28 (both take the
    64-bit keys; small columns the 32-bit ones), at every L the kernel
    takes, each semiring: the kernel equals both plain versions bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for sr_name in ("u64", "u32", "f32"):
        for k in range(2, 15):
            L = 1 << k
            cols, limbs = _case(3, L, max(L // 3, 2), sr_name, seed=k)
            cols[0, : L // 2] = -1 - np.arange(L // 2)
            cols[1] = np.where(cols[1] == INT32_SENTINEL, cols[1], cols[1] + (1 << 28))
            s_cols, s_limbs = _special_rows(L, sr_name)
            cols = np.concatenate([s_cols, cols])
            limbs = [np.concatenate([x, y]) for x, y in zip(s_limbs, limbs)]
            got = _port(cols, limbs, sr_name, device="cuda")
            for fn in (psm.sortmerge_rows_reference, psm.sortmerge_rows_keys_reference):
                _assert_same(got, _port(cols, limbs, sr_name, fn=fn, device="cuda"), sr_name)
