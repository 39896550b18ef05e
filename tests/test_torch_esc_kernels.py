"""ESC SpGEMM's expansion and merge kernels (``kernels/esc.py`` over
``csrc/esc_products.cu``).

The CPU tests hold the dispatch (CPU tensors and f32 take the tensor ops,
and no launch is counted), the wrapper's checks (it takes CUDA tensors
alone) and the byte rules.  The
``cuda`` tests hold the kernel path bit for bit against the tensor ops
(``ops.spgemm.spgemm_reference``) on the same card, in every field of the
result (row offsets, columns, both limbs, padding, nnz): the 30^3 torus's
chain A^2..A^7, a power-law graph with hub rows, u32 and u64 values at the
saturation edges with stored zeros, empty rows, an empty operand, a
rectangular shape, and capacities too small for the expansion or the
result.  Tolerance: exact.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsetpu_torch import obs
from sparsetpu_torch.bench.chain import build_torus_host
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.graphs import datasets
from sparsetpu_torch.kernels import esc as kesc
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.ops.segments import INT32_SENTINEL
from sparsetpu_torch.semiring import F32SR, U32, U64

U64_MAX = (1 << 64) - 1
U32_MAX = (1 << 32) - 1


def _torus(dims=(4, 4, 4), device="cpu", sr=U64) -> SparseCSR:
    h = build_torus_host(dims)
    return SparseCSR.from_coo_host(h.rows(), h.col_idx, h.vals, h.n_rows, sr=sr, device=device)


def _by_hand(n_rows, n_cols, entries, sr, capacity, device="cpu") -> SparseCSR:
    """A CSR with exactly ``entries`` [(row, col, value)] stored, zeros
    included (``from_coo_host`` would drop them), padded to ``capacity``."""
    entries = sorted(entries)
    rows = np.array([e[0] for e in entries], np.int64)
    vals = np.array([e[2] for e in entries], np.uint64)
    col_idx = np.full(capacity, INT32_SENTINEL, np.int32)
    col_idx[:len(entries)] = [e[1] for e in entries]
    limbs = [np.concatenate([l, np.zeros(capacity - len(entries), np.int64)])
             for l in sr.to_host_limbs(vals)]
    row_ptr = np.searchsorted(rows, np.arange(n_rows + 1))
    return SparseCSR.from_host_arrays(row_ptr, col_idx, limbs, len(entries), n_rows, n_cols,
                                      sr, device=device)


# ---- CPU: dispatch, checks, byte rules -------------------------------------

def test_cpu_and_f32_products_take_the_tensor_ops_and_count_no_launch(monkeypatch):
    calls = []
    plain = ops_spgemm.spgemm_reference

    def spy(*args, **kwargs):
        calls.append(args[0].sr_name)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops_spgemm, "spgemm_reference", spy)
    before = kesc.LAUNCHES
    for sr in (U64, U32, F32SR):
        a = _torus(sr=sr)
        cap = ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(a, a))
        ops_spgemm.spgemm(a, a, cap).check()
    assert calls == ["u64", "u32", "f32"]
    assert kesc.LAUNCHES == before
    # the rule itself: a CUDA tensor of u32 or u64 values, and nothing else
    for dev, sr, want in (("cuda", "u64", True), ("cuda", "u32", True), ("cuda", "f32", False),
                          ("cpu", "u64", False), ("cpu", "f32", False)):
        fake = types.SimpleNamespace(device=torch.device(dev), sr_name=sr)
        assert kesc.takes(fake) is want, (dev, sr)


@pytest.mark.parametrize("sr", [U64, U32])
def test_the_wrapper_takes_cuda_tensors_alone(sr):
    # the CPU's product is ops.spgemm's to route, to the tensor ops
    a = _torus((5, 4, 3), sr=sr)
    before = kesc.LAUNCHES
    with pytest.raises(ValueError, match="CUDA card, not cpu"):
        kesc.spgemm_esc(a, a, 4096, 4096)
    assert kesc.LAUNCHES == before


def test_the_wrapper_raises_on_a_wrong_dtype_device_contiguity_or_semiring():
    a = _torus()

    def raises(match, x=a, y=a, expand_cap=1024, out_cap=1024):
        with pytest.raises(ValueError, match=match):
            kesc.spgemm_esc(x, y, expand_cap, out_cap)

    raises("int32", x=dataclasses.replace(a, col_idx=a.col_idx.long()))
    raises("int32", y=dataclasses.replace(a, row_ptr=a.row_ptr.long()))
    raises("int64", x=dataclasses.replace(a, values=(a.values[0].int(), a.values[1])))
    raises("int64", x=dataclasses.replace(a, nnz=a.nnz.int()))
    strided = torch.stack([a.col_idx, a.col_idx], dim=1)[:, 0]
    assert not strided.is_contiguous()
    raises("contiguous", x=dataclasses.replace(a, col_idx=strided))
    raises("on cpu", y=dataclasses.replace(a, values=(a.values[0].to("meta"), a.values[1])))
    raises("limbs", x=dataclasses.replace(a, values=a.values[:1]))
    raises("take", x=_torus(sr=F32SR), y=_torus(sr=F32SR))
    raises("one semiring", y=_torus(sr=U32))
    raises("do not chain", y=_by_hand(3, 3, [(0, 0, 1)], U64, 4))
    raises(">= 1", expand_cap=0)
    raises(">= 1", out_cap=0)
    raises("capacity 0", x=SparseCSR.empty(a.n_rows, a.n_cols, 0, U64, "cpu"))
    # spgemm still checks narrow on every path
    with pytest.raises(ValueError, match="narrow"):
        ops_spgemm.spgemm(_torus(sr=U32), _torus(sr=U32), 1024, narrow=True)


def test_the_byte_rules_by_hand():
    # a toy product: A 3 x 4 with capacity 8, B 4 x 5 with 6 entries,
    # expand_cap 16, out_cap 8, u64 (two limbs)
    assert kesc.counts_bytes(8) == 8 * 8
    assert kesc.expand_bytes(16) == 16 * 8 + 16 * 8
    # one tile: keys 16 x 8 read; its summary 4 x 8 written
    assert kesc.merge_tiles_bytes(16) == 128 + 32
    # the summary read, the carry 2 x 8 written, the count and nnz 8 each
    assert kesc.merge_carry_bytes(16) == 32 + 16 + 16
    # keys and carry read; columns 8 x 4 and two limbs 8 x 8 each (one for u32) written
    assert kesc.merge_emit_bytes(16, 8, 2) == 128 + 16 + 32 + 128
    assert kesc.merge_emit_bytes(16, 8, 1) == 128 + 16 + 32 + 64
    # the row offsets 4 x 4 written
    assert kesc.merge_rows_bytes(3) == 16
    # 2,049 slots take two tiles
    assert kesc.merge_tiles_bytes(2049) == 8 * 2049 + 2 * 32
    # A (5 entries) and B (6) read once, C (3 rows, capacity 8) written once:
    # offsets 16 + 20 + 16 B, 20 B an entry (a column and two limbs), nnz
    assert kesc.product_bytes(3, 5, 4, 6, 3, 8, 2) == 16 + 100 + 20 + 120 + 16 + 160 + 8


# ---- CUDA: the kernels against the tensor ops ------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ESC kernels have no CPU form")
    return torch.device("cuda")


def _same(a, b, expand_cap, out_cap=None):
    """The kernel path's product equals the tensor ops' in every field;
    returns it.  Six launches a product."""
    before = kesc.LAUNCHES
    got = ops_spgemm.spgemm(a, b, expand_cap, out_cap)
    assert kesc.LAUNCHES == before + 6
    want = ops_spgemm.spgemm_reference(a, b, expand_cap, out_cap)
    torch.cuda.synchronize()
    names = ("row_ptr", "col_idx", *("lo", "hi")[:len(got.values)], "nnz")
    for name, g, w in zip(names, (got.row_ptr, got.col_idx, *got.values, got.nnz),
                          (want.row_ptr, want.col_idx, *want.values, want.nnz)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    return got


def _exact(a, b):
    return _same(a, b, ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(a, b)))


@pytest.mark.cuda
def test_cuda_torus_chain_a2_to_a7_bit_for_bit():
    dev = _card()
    a = _torus((30, 30, 30), dev)
    c = a
    nnz = []
    for _ in range(6):
        c = _exact(c, a).check()
        nnz.append(int(c.nnz))
    assert nnz == [248_957, 645_695, 1_544_375, 3_310_002, 6_448_685, 11_493_935]


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [U64, U32])
def test_cuda_power_law_hubs_bit_for_bit(sr):
    dev = _card()
    r, c, v, n = datasets.power_law(10_000, 4, seed=3)
    a = SparseCSR.from_coo_host(r, c, v, n, sr=sr, device=dev)
    assert int(a.row_nnz().max()) > 200  # hub rows
    a2 = _exact(a, a).check()
    _exact(a2, a)


def _edge_values(sr, rng, size):
    if sr is U64:
        pool = np.array([0, 1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 33) + 5,
                         1 << 62, (1 << 63) + 7, U64_MAX - 1, U64_MAX], np.uint64)
    else:
        pool = np.array([0, 1, 2, 3, 1 << 15, (1 << 16) + 1, 1 << 31, U32_MAX - 1, U32_MAX],
                        np.uint64)
    return pool[rng.integers(0, len(pool), size)]


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [U64, U32])
def test_cuda_saturation_edges_and_stored_zeros_bit_for_bit(sr):
    dev = _card()
    rng = np.random.default_rng(11)
    for n, k, m, density in ((40, 30, 50, 0.3), (300, 200, 250, 0.05)):
        def operand(rows, cols):
            cells = np.flatnonzero(rng.random(rows * cols) < density)
            vals = _edge_values(sr, rng, len(cells))
            return _by_hand(rows, cols, [(int(x // cols), int(x % cols), int(v))
                                         for x, v in zip(cells, vals)], sr,
                            len(cells) + 7, dev)
        a, b = operand(n, k), operand(k, m)
        c = _exact(a, b)
        assert int(c.nnz) > 0
    # a product of 2^64 or more, a sum that crosses the top, and a segment
    # of stored zeros that totals 0 (dropped)
    top = U64_MAX if sr is U64 else U32_MAX
    half = (1 << 63) if sr is U64 else (1 << 31)
    a = _by_hand(2, 3, [(0, 0, top), (0, 1, half), (0, 2, 0), (1, 2, 0)], sr, 6, dev)
    b = _by_hand(3, 2, [(0, 0, 2), (1, 0, 2), (1, 1, 1), (2, 0, 5), (2, 1, 0)], sr, 6, dev)
    c = _exact(a, b)
    assert int(c.nnz) == 2 and sr.to_numpy(c.values)[:2].tolist() == [top, half]


@pytest.mark.cuda
def test_cuda_empty_rows_an_empty_operand_and_a_rectangular_shape():
    dev = _card()
    rng = np.random.default_rng(5)
    # rectangular, with empty rows in A and empty rows of B that A references
    entries = [(int(i), int(j), int(rng.integers(1, 9)))
               for i in range(0, 70, 3) for j in rng.choice(45, 4, replace=False)]
    a = _by_hand(70, 45, entries, U64, len(entries) + 1, dev)
    b_entries = [(int(i), int(j), 2) for i in range(0, 45, 2)
                 for j in rng.choice(90, 3, replace=False)]
    b = _by_hand(45, 90, b_entries, U64, len(b_entries), dev)
    c = _exact(a, b)
    assert c.shape == (70, 90) and int(c.nnz) > 0
    # an empty operand on either side: no products, an all-padding result
    empty_a = SparseCSR.empty(70, 45, 16, U64, dev)
    empty_b = SparseCSR.empty(45, 90, 16, U64, dev)
    assert int(_same(empty_a, b, 8).nnz) == 0
    assert int(_same(a, empty_b, 8).nnz) == 0


@pytest.mark.cuda
def test_cuda_capacities_below_the_expansion_or_the_result_poison_nnz():
    dev = _card()
    a = _torus((12, 12, 12), dev)
    flops = ops_spgemm.symbolic_flops_exact(a, a)
    nnz = int(_exact(a, a).nnz)
    assert nnz < flops
    for expand_cap, out_cap in ((flops - 1, flops), (flops // 2, flops), (flops, nnz - 1),
                                (flops, nnz // 3), (flops // 2, nnz // 2)):
        assert int(_same(a, a, expand_cap, out_cap).nnz) == -1
    assert int(_same(a, a, flops, nnz).nnz) == nnz  # exactly enough of both


@pytest.mark.cuda
def test_cuda_kernel_path_never_synchronises_and_its_launches_carry_bytes():
    dev = _card()
    a = _torus((30, 30, 30), dev)
    a2 = _exact(a, a).check()
    cap = ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(a2, a))
    ops_spgemm.spgemm(a2, a, cap)  # warm: the allocator's first use of these sizes
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ops_spgemm.spgemm(a2, a, cap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        ops_spgemm.spgemm(a2, a, cap)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    events = list(prof.events())
    host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    p = obs.PREFIX
    spans = {"esc_counts": kesc.counts_bytes(a2.capacity), "esc_expand": kesc.expand_bytes(cap),
             "esc_merge_tiles": kesc.merge_tiles_bytes(cap),
             "esc_merge_carry": kesc.merge_carry_bytes(cap),
             "esc_merge_emit": kesc.merge_emit_bytes(cap, cap, 2),
             "esc_merge_rows": kesc.merge_rows_bytes(a2.n_rows)}
    for name, nbytes in spans.items():  # one span a launch, named after its kernel
        assert host.count(f"{p}kernel/{name} bytes={nbytes}") == 1, name
        assert sum(f"{name}_kernel" in n for n in device) == 1, name
    for stage in ("product/esc", "esc/expand", "esc/sort", "esc/merge"):
        assert host.count(p + stage) == 1, stage
    # the sort share reads sort kernels by name: none of these is one
    assert not [n for n in device if "esc_" in n and "sort" in n.lower()]


@pytest.mark.cuda
def test_cuda_merge_entry_points_refuse_scratch_of_another_length():
    """The merge's scratch is sized on the Python side from the source's
    tile; a length the source would not give is refused before a launch."""
    dev = _card()
    lib = kesc._build.load()
    n = 3 * kesc.TILE + 1
    tiles = kesc.tiles_of(n)
    assert tiles == 4
    z = lambda k: torch.zeros(k, dtype=torch.int64, device=dev)
    key, perm, word, count, flops, nnz = z(n), z(n), z(n), z(1), z(1), z(1)
    col, row = (torch.zeros(8, dtype=torch.int32, device=dev) for _ in range(2))
    lo, hi = z(8), z(8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    invalid = 1  # cudaErrorInvalidValue
    good_s, good_c = kesc.SUMMARY_WORDS * tiles, kesc.CARRY_WORDS * tiles
    summary, carry = z(good_s + 4), z(good_c + 2)
    for s_len, c_len in ((good_s - 1, good_c), (good_s + 4, good_c), (good_s, good_c - 1),
                         (good_s, good_c + 2)):
        if s_len != good_s:
            assert lib.esc_merge_tiles(key.data_ptr(), perm.data_ptr(), word.data_ptr(), n,
                                       summary.data_ptr(), s_len, 1, stream) == invalid
        assert lib.esc_merge_carry(summary.data_ptr(), s_len, n, carry.data_ptr(), c_len,
                                   count.data_ptr(), flops.data_ptr(), n, 8, nnz.data_ptr(),
                                   1, stream) == invalid
        if c_len != good_c:
            assert lib.esc_merge_emit(key.data_ptr(), perm.data_ptr(), word.data_ptr(), n,
                                      carry.data_ptr(), c_len, count.data_ptr(), 8, 8,
                                      col.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                                      row.data_ptr(), 1, stream) == invalid
