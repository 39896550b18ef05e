"""The port's attention path (sparsetpu_torch.attention.scores,
sparsetpu_torch.kernels.blocksparse, sparsetpu_torch.bench.tipover) against
the JAX package's (sparsetpu.attention.scores, sparsetpu.kernels.blocksparse
in interpret mode).

Inputs come from ``random_sparse_tensor`` (numpy, fixed seeds), which both
packages draw bit for bit alike.  Tolerances: scores against the dense
scores 1e-4 relative (atol 1e-5), the reference's agreement bar; SDD blocks
against JAX's kernel rtol 1e-5, atol 1e-4, as the JAX package's own tests
hold its kernel (the summation orders differ).

On the CPU ``sdd_block_scores`` runs its plain version; the CUDA kernel is
compared with it only where a card is present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax

from sparsetpu.attention import scores as jscores
from sparsetpu.kernels import blocksparse as jbs
from sparsetpu.ops.spgemm import symbolic_flops as jflops

from sparsetpu_torch.attention import scores
from sparsetpu_torch.bench import tipover
from sparsetpu_torch.interop import block_sparse_from_jax
from sparsetpu_torch.kernels import blocksparse as bs
from sparsetpu_torch.ops.spgemm import symbolic_flops

SHAPE = (2, 5, 4, 8)  # (batch, seq, heads, head_dim)
JAX_HEADER = "esc,density,q_nz,k_nz,v_nz,mem_k,mem_q,mem_v,attn_time,gen_time,attn_dry"


def test_random_sparse_tensor_is_bit_identical():
    for shape, density, seed in ((SHAPE, 0.3, 1), ((3, 7, 12, 64), 1e-2, 9), (SHAPE, 1.0, 0)):
        a = scores.random_sparse_tensor(shape, density, seed)
        b = jscores.random_sparse_tensor(shape, density, seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_dense_scores_match_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal(SHAPE).astype(np.float32)
    k = rng.standard_normal(SHAPE).astype(np.float32)
    want = np.asarray(jscores.attention_scores_dense_jit(q, k))
    got = scores.attention_scores_dense(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert scores.attention_flops(SHAPE) == jscores.attention_flops(SHAPE)


@pytest.mark.parametrize("density", [1.0, 0.3, 0.05])
def test_sparse_scores_match_jax_and_dense(density):
    q = scores.random_sparse_tensor(SHAPE, density, seed=1)
    k = scores.random_sparse_tensor(SHAPE, density, seed=2)
    dense = np.einsum("bshd,bsgd->bshg", q.astype(np.float64),
                      k.astype(np.float64)).astype(np.float32)

    jq = jscores.tensor_to_grouped_csr(q)
    jkt = jscores.tensor_to_grouped_csr(k, transpose_last=True)
    q_csr = scores.tensor_to_grouped_csr(q, device="cpu")
    kt_csr = scores.tensor_to_grouped_csr(k, transpose_last=True, device="cpu")
    for port, jx in ((q_csr, jq), (kt_csr, jkt)):
        assert int(port.nnz) == int(jx.nnz) and port.shape == jx.shape
        np.testing.assert_array_equal(port.row_ptr.numpy(), np.asarray(jx.row_ptr))
    flops = int(symbolic_flops(q_csr, kt_csr))
    assert flops == int(jflops(jq, jkt))
    cap = max(1 << (max(flops, 1) - 1).bit_length(), 4)
    want = jscores.sparse_scores_to_dense(jscores.attention_scores_sparse(jq, jkt, cap), SHAPE)
    c = scores.attention_scores_sparse(q_csr, kt_csr, expand_cap=cap)
    got = scores.sparse_scores_to_dense(c, SHAPE)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-5)


# (shape, zero the first Q block): groups of 12 rows straddle the 128-row
# blocks; groups of 16 do not; a zero block drops its pairs
BLOCK_CASES = {
    "straddling": ((2, 16, 12, 8), 0.5, False),
    "aligned": ((2, 3, 16, 32), 1.0, False),
    "zero-q-block": ((4, 4, 16, 32), 0.5, True),
    "d-not-multiple-of-8": ((1, 20, 12, 5), 1.0, False),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_sparse_scores_match_jax(case):
    shape, density, zero_first = BLOCK_CASES[case]
    q = scores.random_sparse_tensor(shape, density, seed=3)
    k = scores.random_sparse_tensor(shape, density, seed=4)
    if zero_first:
        q.reshape(-1, shape[-1])[:128] = 0.0
    jblocks, jqi, jki, jmeta = jbs.block_sparse_attention_scores(q, k, block=128)
    blocks, qi, ki, meta = bs.block_sparse_attention_scores(q, k, block=128, device="cpu")
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    np.testing.assert_array_equal(ki.numpy(), np.asarray(jki))
    assert qi.dtype == ki.dtype == torch.int32
    np.testing.assert_allclose(blocks.numpy(), np.asarray(jax.device_get(jblocks)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(meta["qf"].numpy(), np.asarray(jmeta["qf"]))
    got = bs.scores_blocks_to_dense(blocks, qi, ki, meta)
    np.testing.assert_allclose(got, jbs.scores_blocks_to_dense(jblocks, jqi, jki, jmeta),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.einsum("bshd,bsgd->bshg", q, k), rtol=1e-5, atol=1e-4)
    if zero_first:
        assert 0 not in qi.tolist()


def test_group_block_pairs_against_the_loop():
    """The vectorised pair list equals the JAX package's loop over groups at
    the GPT-2 117M shape (T = 1,792) and at a shape whose groups span three
    blocks."""
    def loop(g, h, block, occ_q, occ_k):
        pairs = set()
        for a0, a1 in zip((np.arange(g) * h) // block, (np.arange(g) * h + h - 1) // block):
            for bi in range(a0, a1 + 1):
                for bj in range(a0, a1 + 1):
                    pairs.add((bi, bj))
        return [p for p in sorted(pairs) if occ_q[p[0]] and occ_k[p[1]]]

    rng = np.random.default_rng(0)
    for g, h, block in ((8 * 1024, 12, 128), (50, 300, 128)):
        nb = -(-g * h // block)
        occ_q, occ_k = rng.random(nb) < 0.9, rng.random(nb) < 0.9
        qi, ki = bs.group_block_pairs(g, h, block, occ_q, occ_k)
        assert list(zip(qi.tolist(), ki.tolist())) == loop(g, h, block, occ_q, occ_k)
    qi, _ = bs.group_block_pairs(8 * 1024, 12, 128, np.ones(768, bool), np.ones(768, bool))
    assert len(qi) == 1792


def test_sdd_plain_version_matches_jax_kernel():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((256, 64)).astype(np.float32)
    k = rng.standard_normal((384, 64)).astype(np.float32)
    qi = np.array([0, 1, 1, 0], np.int32)   # a repeated pair
    ki = np.array([2, 0, 1, 2], np.int32)
    want = np.asarray(jbs.sdd_block_scores(q, k, qi, ki))
    before = bs.LAUNCHES
    got = bs.sdd_block_scores(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(qi), torch.from_numpy(ki))
    assert bs.LAUNCHES == before  # the CPU path never counts a launch
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_sdd_checks():
    q = torch.zeros(256, 16)
    k = torch.zeros(128, 16)
    qi = torch.zeros(2, dtype=torch.int32)
    bad = [
        dict(q=q.double()),
        dict(q=torch.zeros(200, 16)),                       # rows not a block multiple
        dict(k=torch.zeros(128, 8)),                        # widths differ
        dict(qi=qi.long()),
        dict(ki=torch.zeros(3, dtype=torch.int32)),         # lengths differ
        dict(q=torch.zeros(16, 256).t()),                   # not contiguous
    ]
    for kw in bad:
        args = dict(q=q, k=k, qi=qi, ki=qi) | kw
        with pytest.raises(ValueError):
            bs.sdd_block_scores(**args)


def test_block_sparse_matrix_round_trip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 384)).astype(np.float32)
    x[:128, 128:256] = 0.0
    m = bs.BlockSparseMatrix.from_dense(x, (128, 128), device="cpu")
    jm = jbs.BlockSparseMatrix.from_dense(x, (128, 128))
    assert m.nblocks == jm.nblocks == 5
    assert m.density() == jm.density() and m.memory_bytes() == jm.memory_bytes()
    np.testing.assert_array_equal(m.to_dense().numpy(), x)
    carried = block_sparse_from_jax(jm.blocks, jm.block_rows, jm.block_cols, jm.shape,
                                    jm.block_shape, device="cpu")
    np.testing.assert_array_equal(carried.to_dense().numpy(), np.asarray(jm.to_dense()))
    np.testing.assert_array_equal(carried.block_rows.numpy(), m.block_rows.numpy())
    empty = bs.BlockSparseMatrix.from_dense(np.zeros((128, 128), np.float32), device="cpu")
    assert empty.nblocks == 1 and not empty.to_dense().any()


def test_sweep_config_toy_on_cpu(tmp_path):
    cfg = (2, 8, 4, 32)  # shape (2, 8, 4, 8)
    path = tmp_path / "toy.csv"
    csv = tipover.sweep_config(cfg, iters=1, device="cpu", per_decade=1,
                               n_density_steps=5, out_path=str(path), verbose=False)
    lines = csv.strip().split("\n")
    assert lines[0].startswith("ref_time=") and "n_weights=512 total_mem=6144" in lines[0]
    assert lines[1] == JAX_HEADER
    assert path.read_text() == csv
    rows = [l.split(",") for l in lines[2:]]
    assert [r[0] for r in rows] == ["esc", "sdd"] * 5
    assert all(len(r) == 11 for r in rows)
    # q_nz, k_nz agree with the JAX package's CSRs of the same draws
    shape = tipover.config_shape(cfg)
    for r in rows[::2][:3]:
        ii = [f"{1e-4 * 10 ** i:.4f}" for i in range(5)].index(r[1])
        q = jscores.random_sparse_tensor(shape, 1e-4 * 10 ** ii, seed=2 * ii)
        assert int(r[2]) == int(jscores.tensor_to_grouped_csr(q).nnz)
    x = tipover.crossover_density(csv)
    assert x is None or 1e-4 <= x <= 1.0
    # sdd rows: T real pairs, mem_v = T * 128 * 128 * 4
    assert all(int(r[7]) == int(r[4]) * 128 * 128 * 4 for r in rows[1::2])


def test_crossover_density_rule():
    text = ("ref_time=100 µs blas_time=100 µs n_weights=1 total_mem=12\n" + JAX_HEADER + "\n"
            "esc,0.0001,1,1,1,1,1,1,40,1,1\nsdd,0.0001,1,1,1,1,1,1,900,1,0\n"
            "esc,0.0010,1,1,1,1,1,1,90,1,1\nesc,0.0100,1,1,1,1,1,1,150,1,1\n"
            "esc,0.1000,1,1,1,1,1,1,50,1,1\n")
    assert tipover.crossover_density(text) == 0.001
    slow = text.replace(",40,1,1\n", ",400,1,1\n")
    assert tipover.crossover_density(slow) is None


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tipover.main(["--configs", "0"])


@pytest.mark.cuda
def test_cuda_sdd_kernel_matches_plain_version():
    """The hand-written SDD kernel against the plain version on the card:
    D of 8, 32, 64 and 72 (a partial staging chunk), a pair list with
    repeats, a single pair, and an out-of-range pair (NaN block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (8, 32, 64, 72):
        q = torch.randn(384, d, generator=gen, device=dev)
        k = torch.randn(512, d, generator=gen, device=dev)
        for pairs in (([0, 1, 1, 2, 0], [3, 0, 0, 1, 3]), ([2], [1])):
            qi = torch.tensor(pairs[0], dtype=torch.int32, device=dev)
            ki = torch.tensor(pairs[1], dtype=torch.int32, device=dev)
            before = bs.LAUNCHES
            got = bs.sdd_block_scores(q, k, qi, ki)
            assert bs.LAUNCHES == before + 1
            torch.testing.assert_close(got, bs.sdd_block_scores_reference(q, k, qi, ki),
                                       rtol=1e-5, atol=1e-4)
    bad = bs.sdd_block_scores(q, k, torch.tensor([0, 3], dtype=torch.int32, device=dev),
                              torch.tensor([0, 0], dtype=torch.int32, device=dev))
    assert not bad[0].isnan().any() and bad[1].isnan().all()
    with pytest.raises(ValueError):
        bs.sdd_block_scores(q, k, qi, ki, block_m=64, block_n=64)
    with pytest.raises(ValueError):
        bs.sdd_block_scores(q[:, :12].contiguous(), k[:, :12].contiguous(), qi, ki)
