"""The port's row-partitioned ESC chain (sparsetpu_torch.dist.shard) against
the JAX package's (sparsetpu.dist.shard), on the CPU: the counterparts of
tests/test_dist.py's cases, at 2 and 4 shards.

The JAX side runs on conftest's 8 virtual devices (``default_mesh(nd)``);
the port side runs as gloo worlds of nd ranks (``dist.multihost.run_local``),
one world a world size for the whole module, every case in one spawn of
``dist/programs.py``.  Both take the same seeded numpy graphs.  Tolerance:
exact.  Every shard's valid prefix (row_ptr, col_idx[:nnz], limbs[:nnz],
nnz) and its capacity equal JAX's shard bit for bit (the port's int64
limbs hold JAX's uint32 values), and every whole CSR equals JAX's
``unshard``.
"""

import jax
import numpy as np
import pytest
import torch

from sparsetpu import U64 as JU64
from sparsetpu import SparseCSR as JCSR
from sparsetpu.dist import shard as jdist
from sparsetpu.graphs import generate as jgen

from sparsetpu_torch.dist import multihost, programs, run_local

SIZES = (2, 4)


def _graph(name):
    if name == "roundtrip":
        return jgen.lattice([5, 5], torus=True)
    if name in ("product", "poisoned", "from_jax"):
        return jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.3, seed=1)
    if name == "chain":
        return jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.25, seed=3)
    return jgen.random_graph(21, 60, seed=5)  # rectangular: 21 rows over 2 or 4 shards


STEPS = {"roundtrip": 0, "product": 1, "chain": 3, "rectangular": 1, "poisoned": 1,
         "from_jax": 2}
POISON_CAP = 8  # far below the largest shard's flop count


def _jax_csr(coo):
    rows, cols, vals, n = coo
    return JCSR.from_coo(rows, cols, vals, n, sr=JU64)


def _jax_shard_arrays(s):
    return dict(row_ptr=np.asarray(s.row_ptr), col_idx=np.asarray(s.col_idx),
                limbs=[np.asarray(l) for l in s.values], nnz=np.asarray(s.nnz),
                n_rows=s.n_rows, n_cols=s.n_cols, sr_name=s.sr_name)


def _case(name, nd):
    case = {"a": programs.coo_arrays(_graph(name)), "steps": STEPS[name]}
    if name == "poisoned":
        case["expand_cap"] = POISON_CAP
    if name == "from_jax":  # start from JAX's sharded A
        a = _jax_csr(_graph(name))
        case["jax"] = _jax_shard_arrays(jdist.shard(a, nd, mesh=jdist.default_mesh(nd)))
    return case


@pytest.fixture(scope="module")
def port():
    """{nd: {case: the case's record of every rank}}: one world a size."""
    out = {}
    for nd in SIZES:
        names = list(STEPS)
        ranks = run_local(programs.chain_cases, nd, [_case(n, nd) for n in names],
                          device="cpu", verbose=False)
        out[nd] = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return out


def _jax_chain(name, nd):
    """JAX's shard of the start and of every product, its flops, its wholes."""
    a = _jax_csr(_graph(name))
    mesh = jdist.default_mesh(nd)
    s = jdist.shard(a, nd, mesh=mesh)
    shards, flops, wholes = [s], [], []
    for _ in range(STEPS[name]):
        f = np.asarray(jax.device_get(jdist.symbolic_flops_sharded(s, a, mesh=mesh)))
        cap = POISON_CAP if name == "poisoned" else 1 << (max(int(f.max()), 1) - 1).bit_length()
        s = jdist.spgemm_sharded(s, a, expand_cap=cap, mesh=mesh)
        shards.append(s)
        flops.append(f)
    for k, s in enumerate(shards):
        if (np.asarray(s.nnz) < 0).any():
            with pytest.raises(ValueError, match="poisoned") as e:
                jdist.unshard(s)
            wholes.append(f"ValueError: {e.value}")
        else:  # JAX's unshard is A^(k+1) whole: numpy's dense power
            wholes.append(dense_power(name, k + 1))
    return shards, flops, wholes


def assert_shard(got, want, d):
    """Shard d of JAX's ShardedCSR ``want`` against the port's arrays."""
    rp, ci, *limbs, nnz = got
    k = int(np.asarray(want.nnz)[d])
    assert int(nnz) == k
    assert ci.shape[0] == want.capacity and len(limbs) == len(want.values)
    if k < 0:
        return  # poisoned: JAX's arrays past the overflow are not a contract
    np.testing.assert_array_equal(rp, np.asarray(want.row_ptr)[d])
    np.testing.assert_array_equal(ci[:k], np.asarray(want.col_idx)[d, :k])
    for pl, jl in zip(limbs, want.values):
        np.testing.assert_array_equal(pl[:k], np.asarray(jl)[d, :k].astype(np.int64))


def assert_whole(got, want):
    """The port's whole CSR (or unshard's error) against a dense matrix (or
    JAX's error)."""
    if isinstance(want, str):
        assert isinstance(got, str) and got.startswith("ValueError"), got
        return
    assert not isinstance(got, str), got
    np.testing.assert_array_equal(whole_dense(got, want.shape[0]), want)


def dense_power(name, k):
    """A^k of the case's graph in numpy int64 (exact: the values stay far
    below 2^63), the single-device product the JAX tests take from
    spgemm_auto."""
    rows, cols, vals, n = _graph(name)
    a = np.zeros((n, n), np.int64)
    np.add.at(a, (rows, cols), vals.astype(np.int64))
    return np.linalg.matrix_power(a, k)


def whole_dense(got, n):
    row_ptr, col_idx, vals = got
    assert len(row_ptr) == n + 1 and row_ptr[-1] == len(col_idx)
    out = np.zeros((n, n), np.int64)
    out[np.repeat(np.arange(n), np.diff(row_ptr)), col_idx] = vals.astype(np.int64)
    return out


def _check_case(port, name, nd):
    ranks = port[nd][name]
    shards, flops, wholes = _jax_chain(name, nd)
    for d, rec in enumerate(ranks):
        for got, want in zip(rec["shards"], shards):
            assert_shard(got, want, d)
        for got, want in zip(rec["flops"], flops):
            np.testing.assert_array_equal(got, want.astype(np.int64))
        for got, want in zip(rec["whole"], wholes):
            assert_whole(got, want)
    return ranks, shards


@pytest.mark.parametrize("nd", SIZES)
def test_shard_unshard_roundtrip(port, nd):
    ranks, shards = _check_case(port, "roundtrip", nd)
    a = _jax_csr(_graph("roundtrip"))
    for rec in ranks:
        assert rec["total_nnz"] == [int(a.nnz)] == [int(shards[0].total_nnz())]
        for got, want in zip(rec["whole"][0], a.to_numpy()):  # the whole CSR, bit for bit
            np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                          np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("nd", SIZES)
def test_sharded_spgemm_matches_single(port, nd):
    ranks, shards = _check_case(port, "product", nd)
    want = dense_power("product", 2)
    for rec in ranks:
        np.testing.assert_array_equal(whole_dense(rec["whole"][1], 64), want)
        assert rec["total_nnz"][1] == np.count_nonzero(want) == int(shards[1].total_nnz())


@pytest.mark.parametrize("nd", SIZES)
def test_sharded_chain_stays_sharded(port, nd):
    """A^2..A^4: every step's product stays sharded and equals JAX's shard
    by shard, and its whole equals the single-device chain's."""
    ranks, _ = _check_case(port, "chain", nd)
    for step in range(1, 4):
        np.testing.assert_array_equal(whole_dense(ranks[0]["whole"][step], 64),
                                      dense_power("chain", step + 1))
    # one rank's shard holds only its rows: n_local + 1 offsets, not n + 1
    assert ranks[0]["shards"][3][0].shape[0] == -(-64 // nd) + 1


@pytest.mark.parametrize("nd", SIZES)
def test_rectangular_blocks_padding(port, nd):
    """21 rows over 2 or 4 shards: the tail shard's padded rows are empty,
    its row_ptr padded by its last offset."""
    ranks, shards = _check_case(port, "rectangular", nd)
    np.testing.assert_array_equal(whole_dense(ranks[-1]["whole"][1], 21),
                                  dense_power("rectangular", 2))
    rp = ranks[-1]["shards"][0][0]
    n_local = -(-21 // nd)
    tail = 21 - (nd - 1) * n_local
    assert (rp[tail:] == rp[tail]).all()


@pytest.mark.parametrize("nd", SIZES)
def test_unshard_raises_on_a_poisoned_shard(port, nd):
    """An expansion past expand_cap poisons the shard's nnz to -1 (as JAX's
    does) and unshard raises ValueError on every rank rather than build a
    CSR from it."""
    ranks, shards = _check_case(port, "poisoned", nd)
    nnz = np.asarray(shards[1].nnz)
    assert (nnz < 0).any()
    for d, rec in enumerate(ranks):
        assert int(rec["shards"][1][-1]) == int(nnz[d])
        assert rec["whole"][1].startswith("ValueError") and "poisoned" in rec["whole"][1]


@pytest.mark.parametrize("nd", SIZES)
def test_product_from_jax_state(port, nd):
    """Starting from JAX's sharded A (interop.sharded_from_jax), the port's
    A^2 and A^3 equal JAX's shard by shard."""
    ranks, _ = _check_case(port, "from_jax", nd)
    assert [r["total_nnz"] for r in ranks] == [ranks[0]["total_nnz"]] * nd


@pytest.mark.parametrize("nd", SIZES)
def test_memory_bytes_counts_every_shard(port, nd):
    ranks, shards = _check_case(port, "roundtrip", nd)
    s = shards[0]
    # JAX stores uint32 limbs (4 B), the port int64 (8 B)
    port_bytes = s.row_ptr.size * 4 + s.col_idx.size * (4 + 8 * len(s.values))
    assert all(r["memory_bytes"] == port_bytes for r in ranks)



@pytest.mark.cuda
@pytest.mark.parametrize("nd", [1, 2])
def test_cuda_chain_over_nccl_and_over_a_shared_card(nd):
    """On the card: one rank runs over NCCL (device tensors as they are);
    two ranks on one card run over gloo, staging through pinned host
    memory.  Either way every shard equals JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want_backend = "nccl" if torch.cuda.device_count() >= nd else "gloo"
    assert multihost.world_backend(nd, "cuda") == want_backend
    ranks = run_local(programs.chain_cases, nd, [_case("chain", nd)], device="cuda",
                      verbose=False)
    shards, flops, wholes = _jax_chain("chain", nd)
    for d, (rec,) in enumerate(ranks):
        for got, want in zip(rec["shards"], shards):
            assert_shard(got, want, d)
        for got, want in zip(rec["whole"], wholes):
            assert_whole(got, want)
