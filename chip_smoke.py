#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sparsetpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, nvcc and g++, builds every kernel and the C++ oracle from the sources
in the checkout, and runs in phases; any failure raises and exits non-zero:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. build of the CUDA kernel library (one nvcc per source, in parallel) and
   the oracle, with nvcc's report;
3. each kernel against its plain PyTorch version, with kernel and plain
   times: the three SpMM kernels for exact equality (integer values below
   2^24 carried in f32: every summation order is exact, so the tolerance is
   0), at small shapes and on a row slice of the 30^3 operand, group-dot
   against both its plain versions (f32, and the u8 limbs of its own
   arithmetic) on a P below 5 (one limb) and on a P that spans all three
   limbs, and its P domain: a value of 2^24, -1, 0.5, NaN or inf turns its
   warp's output tile into NaN and leaves the rest exact; the SDD
   kernel against both its plain versions (the batched fp32 product and
   the 3xTF32 split of its own arithmetic) at rtol 1e-5, atol 1e-4 (sums
   in another order), at small shapes (D = 8..136) and on the full GPT-2
   117M pair list (config 1, T = 1,792 blocks); the sort-merge kernel
   against both its plain versions (the stable sort and its own packed
   keys) for exact equality (integer semirings, and f32 on integer values)
   at every row length it takes, each semiring, with saturating,
   all-sentinel and single-product rows, then on the real padded slab of
   the largest kernel-covered category of the ER 27,000 x 32 product; the
   coalesce kernel for exact equality (int32, int64 and f32 streams, K =
   1..4, empty and full blocks, one block, L = 1..2^20, out_cap above and
   below the total; blocks of 0-3 survivors, out_cap not a multiple of 4,
   streams as views at odd element offsets), then on the real survivor
   streams of the mixed chain's A^4 slab and of the ER 27,000 x 32 slab;
   the dense-accumulator kernel also at the general-SpGEMM sweep's shapes
   (the ER 27,000 x 32, power-law 27,000 and ER 27,000 x 2 operands, each
   times its densified self: a 256-row slice, the power-law one around its
   longest row, against the plain version and the full product's rows
   against it), with its column panel's width, each full product's gather
   traffic (nnz x m x 4 B) and the rate it implies, and once the card's L2
   re-read rate (an index_select from an L2-resident panel; a reference
   for the gather floor, not a bound).
   Beside each kernel: its bound (the larger of its compulsory bytes at
   3.35 TB/s and its operations at the H100 SXM data sheet's rate: fp32 at
   67 TFLOP/s, SDD's 3xTF32 products at 495 TFLOP/s with its fp32 bound
   beside) and, where PyTorch computes
   the same function, that call's time (for coalesce, one masked_select a
   stream); last the ESC kernels (``kernels/esc.py``) at the chain's A^6 x
   A, every field of the product (row offsets, columns, both limbs, nnz)
   equal to the tensor ops' (``ops.spgemm.spgemm_reference``), six launches
   from a count set to 0 just before, with the kernels' and the key sort's
   device ms and the bound (A^6 and A read once, C written once); then the
   tiled route's count and pack kernels (``kernels/panelpack.py``) on the
   first 2,048-column panel of A^2 of Graph 500's Kronecker graph at SCALE
   17 (draw seed 1; 131,072 x 2,048 f32), each equal to its plain version
   (the count table and the fault to count_nonzero and the exactness max,
   every slot of the pack to the tensor ops' pack), two launches, with
   each one's device ms, its plain version's and its bound, and the whole
   A^2 through spgemm_auto (denseacc_tiled, 64 panels, 128 panel launches,
   nnz 1,029,215,160, every field equal to the tensor-op sweeps' on the
   card);
4. the port's paths at full scale, each with every kernel count set to 0
   just before it and read just after: the router's dense-acc chain, the
   fold-band chain and the group-dot chain, A^2..A^7 on the 30^3 thinned
   torus (every step's (nnz, max) against the oracle and the published
   table, the final values on 128 leading rows, un-permuted for fold-band,
   and at least one launch per step of the path's kernel); then the router's
   "esc" route, the 30^3 torus at --steps 4, through the rowcat chain
   (A^2..A^4 each equal to the oracle's whole CSR, at least one sort-merge
   launch); then the
   attention-scores path at GPT-2 117M (config 1), one density at a time:
   the dense baseline, ESC at densities 1e-3, 1e-2, 1e-1 and SDD at those
   and 1.0, every product against the dense scores (rtol 1e-4, atol 1e-5)
   and at least one SDD launch per density; then the general-SpGEMM sweep
   (``spgemm_bench.run``, BASELINE configs 3-4) on ER {1,000, 3,375, 8,000,
   27,000} x {2, 8, 32} and power-law 27,000 (m = 8), one graph at a time,
   with esc, escb, rowcat and rowcat_pallas: every product equal to the
   oracle's whole CSR (no DNF row), nnz(C) as the published sweep, and at
   least one sort-merge launch per graph (only rowcat_pallas launches it);
   then the mixed chain on the 30^3 torus (slab ESC A^2..A^4, each equal to
   the oracle's whole CSR, the densify, dense-acc A^5..A^7; the published
   (nnz, max) table, the final values on 128 rows, at least one coalesce
   launch per slab step and one dense-acc launch per late step); then
   spgemm_slab on ER 27,000 x 32 and power-law 27,000 and spgemm_colchunk
   (slot budget 2^24, K = 3 chunks) on ER 27,000 x 32, each equal to the
   oracle's whole CSR, with at least one coalesce launch each; then the
   chain's other forms on the 30^3 torus at --steps 7 (bench.py --algo esc,
   escb, dense and band): every step's (nnz, max) against the published
   table, the esc and escb chains' whole CSR at every step against the
   oracle's products (computed once and shared), the dense and band chains'
   final values on 128 rows; the esc chain exactly six ESC-kernel launches
   a product (one checked call and three timed calls a step), the other
   three none.  The sweep runs JAX's eight algorithms (esc,
   escb, rowcat, rowcat_pallas, denseacc, densedense, densedense_tiled,
   bcoo), every product equal to the oracle's whole CSR, the only DNF rows
   JAX's own rule's (densedense at n = 27,000), at least one dense-acc
   launch per graph (the denseacc row); spgemm_auto runs on every sweep
   graph (its route printed, its product against the oracle), and once
   forced to denseacc_tiled on ER 27,000 x 32 (4 panels of 8,192, two
   dense-acc launches and two panel launches a panel).
   Then the real-graph study (``bench/real_graphs.py``) on the power-law
   substitutes of cora, nell and ogbn-arxiv at their published sizes: the
   pattern engine's int8 product against a float64 reference (panels with
   an edge inside the padding) and one panel of nell's 65,792^2 frame timed
   with the second operand column-major and row-major; per graph the
   structure report (RCM but on ogbn), its components equal to scipy's
   partition, the chain (A^2..A^4; ogbn A^2 only) at --iters 1 with every
   step's nnz equal to reports/real_graphs_r5.csv's, A^2's whole CSR (and
   cora's A^3 and A^4) to the oracle's, each step's route, time, idle share
   and peak memory, at least one coalesce launch per graph and one dense-acc
   launch on nell (A^4); each kernel a step launched held exactly against
   its plain version on the inputs of its first call in the step's timed
   product (nell A^4: A and a 5,120-column panel of A^3; every slab and
   colchunk step's coalesce streams; an "esc" route's operands on the ESC
   kernels against the tensor ops); cora's band hybrid equal to spgemm_auto's CSR value for value;
   on cora and nell reachability and the diameter on the int8 engine,
   reachability's nnz equal to sum |C|^2 over the components of two or more
   nodes (cora: 7,333,264 at k = 11) and k equal to the diameter + 1, the
   diameter equal to the host's exact BFS (cora: 10), with seconds, peak
   memory and the int8 rate.
   Then the einsum engine (``einsum/engine.py``), its kernel counts set to
   0 before it and read after it: ``bench/engine_bench.run`` at ER 27,000 x
   8 (the dense, sparse, SpMM and chain tiers, each engine result equal to
   its direct call: dense bit for bit, sparse and chain the whole CSR, SpMM
   at rtol 1e-5, atol 1e-4); the chain tier on the 30^3 torus (A^3 equal to
   the oracle's whole CSR, its products' counts 314,066 and 938,569) and on
   nell_pl (A^4 as (A.A).(A.A), nnz 321,409,501 as r5's); the exact
   entry-driven tier (sum of A^4 * A on the torus, equal to numpy on the
   oracle's CSRs); the grouped tier at GPT-2 117M (config 1's Q and K at
   density 1e-2 as GroupedCSR, equal to the dense scores at rtol 1e-4, atol
   1e-5); the device btree (2^24 keys, 2^16 queries, half misses: (pos,
   hit) equal to torch.searchsorted plus equality, both timed).  Each
   einsum runs once under torch.profiler (each product's route printed)
   and once timed, that call's kernels' first-call inputs held exactly
   against their plain versions (every kernel it launched; those launches
   not counted); at least one coalesce launch.
   Then row-partitioned execution (``sparsetpu_torch/dist``: of the
   kernels only ESC's on its path, each rank's count exactly six a product
   of its sharded chain, the others 0; each step's first product in a rank
   held exactly against the tensor ops on its own inputs) on the same 30^3
   torus: the sharded ESC chain A^2..A^7 with the product kept sharded,
   first on one rank over NCCL (every step's (nnz, max) against the
   published table, unshard(A^4) and unshard(A^7) equal to the oracle's
   whole CSR, each step's ms beside the esc chain's total from this run),
   then on four ranks sharing the card over gloo (the same checks, each
   step's work imbalance, unshard(A^7) equal to the one-rank result bit for
   bit; the ring A^2 x A^2 -> A^4 and A^3 x A^4 -> A^7 with both operands
   sharded, each equal to the one-rank product bit for bit, with its
   step_cap and out_cap; the sharded band product of the torus's cyclic
   band, block 125, half-width 1,799, 54 of 216 block rows a rank, equal to
   the unsharded band_matmul bit for bit, nnz 248,957); the one- and
   four-rank worlds then also run the scaling chain (--steps 2) and the
   four-rank world dryrun_multichip's program (ESC, ring and band A^2
   agree); a two-rank world adds the scaling chain's last row, and
   reports/scaling_h100.csv is written as the scaling CLI writes it, with
   its sharing caveat; then memcross on a tipover CSV of the attention
   path's rows and the report over the phase's CSVs, both into a temporary
   directory.
   Each path runs under torch.profiler, and every kernel's device time is
   summed over it, warm-ups and repetitions included; one pass of each
   path (one untimed call of each step: a chain's steps once, one product a
   density or a graph) is profiled apart, for each kernel's pass launches
   and pass device time;
5. JSON lines (the kernels line: each kernel's launches and device time
   summed over its path and over one pass, its times, bound and library
   call, for dense-acc, sort-merge and coalesce the real-graph path's
   launches, first-call device time and max |error| on its inputs, and for
   every kernel the einsum engine phase's launches, the device ms of its
   profiled calls and the max |error| on its inputs; the ESC kernels' row
   with the same for the esc chain, the real-graph, engine and dist
   phases; the panel kernels' row), the dist phase's
   line (step times, transports, ring capacities, imbalance, the band, the
   scaling rows, the dry run), the card line, and the contract line
   ``{"ok": true, "device": {...}}`` last.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import torch

EXPECTED = [  # (step, nnz, max) of the 30^3 chain, exact on any device
    (2, 248_957, 10), (3, 645_695, 20), (4, 1_544_375, 149),
    (5, 3_310_002, 383), (6, 6_448_685, 2_572), (7, 11_493_935, 7_383),
]
STEPS = 7
SLICE_ROWS = 256
SDD_RTOL, SDD_ATOL = 1e-5, 1e-4
ATT_DENSITIES = (1e-3, 1e-2, 1e-1, 1.0)  # ESC runs at the first three (JAX's budget)
DIMS30 = (30, 30, 30)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # fp32 outside the tensor cores, data sheet
TF32_FLOPS_PER_S = 495e12  # TF32 on the tensor cores, dense, data sheet
INT8_TOPS = 1979.0         # int8 on the tensor cores, dense, TOP/s, data sheet
# nnz of A^2..A^4 of the power-law substitutes (reports/real_graphs_r5.csv);
# ogbn_arxiv_pl runs A^2 only
REAL_NNZ = {"cora_pl": [131_360, 899_722, 3_407_150],
            "nell_pl": [4_030_143, 42_457_579, 321_409_501],
            "ogbn_arxiv_pl": [32_071_529]}
SPGEMM_ALGOS = ("esc", "escb", "rowcat", "rowcat_pallas", "denseacc", "densedense",
                "densedense_tiled", "bcoo")
# the only DNF rows JAX's own rule gives: densedense_fits(n, n, n) fails at 27k
DNF_ALLOWED = {(case, 27000, epn, "densedense")
               for case, epn in (("er", 2), ("er", 8), ("er", 32), ("powerlaw", 8))}
# (case, n, edges per node) -> nnz(C) of the published sweep
# (reports/spgemm_sweep_full.csv): BASELINE configs 3-4, the whole grid
SPGEMM_CASES = {
    ("er", 1000, 2): 3_919, ("er", 1000, 8): 61_273, ("er", 1000, 32): 628_978,
    ("er", 3375, 2): 13_396, ("er", 3375, 8): 214_002, ("er", 3375, 32): 2_957_810,
    ("er", 8000, 2): 31_799, ("er", 8000, 8): 510_081, ("er", 8000, 32): 7_658_185,
    ("er", 27000, 2): 108_807, ("er", 27000, 8): 1_725_082, ("er", 27000, 32): 27_099_771,
    ("powerlaw", 27000, 8): 17_238_434,
}


def same_partition(a, b) -> bool:
    """Two labellings describe the same partition of the nodes."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls, by CUDA events, after one
    warm-up.  The calls queue behind a device sleep that outlasts their
    launches, so the host's launch time counts only where fn synchronises
    (a call of ~0.1 ms is otherwise timed at the host's pace)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second at the H100's top clock; a slower clock sleeps longer
    torch.cuda._sleep(int(2e9 * (2 * reps * launch_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_close(name, got, want, rtol, atol) -> float:
    """Agreement of a kernel's result with its plain version's within
    (rtol, atol); returns the max |error|."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.allclose(got, want, rtol=rtol, atol=atol),
          f"{name}: kernel != plain (max |err| {err}, rtol {rtol}, atol {atol})")
    return err


def compare(name, got, want) -> float:
    """Exact equality of a kernel's result with its plain version's; returns
    the max |error| (0.0)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(torch.equal(got, want), f"{name}: kernel != plain (max |err| {err})")
    return err


def compare_slabs(name, got, want) -> float:
    """Exact equality of two (cols, limbs) slabs; returns the max |error|."""
    return max(compare(f"{name} {part}", g, w)
               for part, g, w in zip(("cols", "lo", "hi"), (got[0], *got[1]),
                                     (want[0], *want[1])))


def bound(nbytes: float, flops: float = 0.0, flops_per_s: float = FP32_FLOPS_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes at the memory rate and the operations at
    ``flops_per_s`` (by default fp32 on the CUDA cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / flops_per_s * 1e3
    return (t_flops, "operations") if t_flops > t_bytes else (t_bytes, "bytes")


def csr_spmm_bytes(row_ptr, cols, n_rows: int, width_in: int, width_out: int,
                   value_bytes: float) -> float:
    """Compulsory bytes of C = A x P: A's arrays, each distinct P row that A
    references (width_in f32) once, and C (width_out f32 a row) once, by the
    program's rule (``kernels.spmm.csr_spmm_bytes``, which its launch spans
    carry), the distinct columns counted here on the card."""
    from sparsetpu_torch.kernels import spmm

    check(row_ptr.numel() == n_rows + 1, f"{row_ptr.numel()} row offsets for {n_rows} rows")
    return spmm.csr_spmm_bytes(n_rows, cols.numel(), torch.unique(cols).numel(), width_in,
                               width_out, value_bytes)


def profiled(fn, kernels):
    """Run fn() under torch.profiler and return (its result, {kernel: device
    ms}): each of ``kernels``' summed self device time, from
    ``key_averages()`` (its CUDA function is ``<name>_kernel``, or for a
    wrapper of several kernels each of ``DEVICE_KERNELS[name]``'s).  CUDA
    activity only: recording the host's ops too would slow the host-bound
    paths (the slab steps, ESC, the small sweep rows) further."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    from sparsetpu_torch.bench.spgemm_profile import device_us

    ms = dict.fromkeys(kernels, 0.0)
    for e in prof.key_averages():
        for name in kernels:
            if any(f"{k}_kernel" in e.key for k in DEVICE_KERNELS.get(name, (name,))):
                ms[name] += device_us(e) / 1e3
    return out, ms


ESC_KERNELS = ("esc_counts", "esc_expand", "esc_merge_tiles", "esc_merge_carry",
               "esc_merge_emit", "esc_merge_rows")  # csrc/esc_products.cu's kernels
ESC_PER_PRODUCT = len(ESC_KERNELS)  # launches of one spgemm_esc
PANEL_KERNELS = ("panel_count", "panel_pack")  # csrc/panel_pack.cu's kernels, a wrapper each
# the counters of several kernels: spgemm_esc (kernels/esc.py) launches
# six; kernels/panelpack.LAUNCHES counts its two wrappers' launches, one
# each a panel of the tiled routes
DEVICE_KERNELS = {"spgemm_esc": ESC_KERNELS, "panelpack": PANEL_KERNELS}
# a counter's wrappers, where they are not named as the counter
WRAPPERS = {"panelpack": PANEL_KERNELS}


def wrappers_of(modules):
    """{wrapper name: (counter, kernel module)} of ``modules`` ({counter:
    kernel module}): a counter's one wrapper of its own name, or the
    wrappers ``WRAPPERS`` lists."""
    return {w: (name, mod) for name, mod in modules.items()
            for w in WRAPPERS.get(name, (name,))}


def esc_kernel_row(dev, h30) -> dict:
    """The ESC kernels (``kernels/esc.py``) at the chain's A^6 x A on the
    30^3 torus: the product on the kernels equal to the tensor-op version
    (``ops.spgemm.spgemm_reference``) in every field, six launches; the
    kernel path's and the plain version's device ms, the bound (A^6 and A
    read once, C written once at its capacity), the kernels' and the key
    sort's device ms in one profiled call."""
    from sparsetpu_torch.csr import SparseCSR
    from sparsetpu_torch.kernels import esc
    from sparsetpu_torch.ops import spgemm as ops_spgemm
    from sparsetpu_torch.semiring import U64

    a = SparseCSR.from_coo_host(h30.rows(), h30.col_idx, h30.vals, h30.n_rows, sr=U64,
                                device=dev)
    c = a
    for _ in range(5):  # A^2 .. A^6 on the kernels
        c = ops_spgemm.spgemm(c, a, ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(c, a)))
        c = c.check()
    flops = ops_spgemm.symbolic_flops_exact(c, a)
    cap = ops_spgemm.pow2(flops)
    esc.LAUNCHES = 0
    got = ops_spgemm.spgemm(c, a, cap)
    check(esc.LAUNCHES == ESC_PER_PRODUCT, f"ESC made {esc.LAUNCHES} launches, not 6")
    want = ops_spgemm.spgemm_reference(c, a, cap)
    for name, g, w in zip(("row_ptr", "col_idx", "lo", "hi", "nnz"),
                          (got.row_ptr, got.col_idx, *got.values, got.nnz),
                          (want.row_ptr, want.col_idx, *want.values, want.nnz)):
        compare(f"ESC kernels A^6 x A {name}", g, w)
    nnz6, nnz7 = int(c.nnz), int(got.nnz)
    check(nnz7 == EXPECTED[-1][1], f"ESC A^7 nnz {nnz7} != {EXPECTED[-1][1]}")
    del want
    b_ms, b_by = bound(esc.product_bytes(c.n_rows, nnz6, a.n_rows, int(a.nnz), c.n_rows, cap, 2))
    _, dev_ms = profiled(lambda: ops_spgemm.spgemm(c, a, cap), ESC_KERNELS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ops_spgemm.spgemm(c, a, cap)
        torch.cuda.synchronize()
    from sparsetpu_torch.bench.spgemm_profile import device_us
    sort_ms = sum(device_us(e) for e in prof.key_averages()
                  if "radixsort" in e.key.lower()) / 1e3
    row = dict(ms=time_ms(lambda: ops_spgemm.spgemm(c, a, cap), 10),
               plain_ms=time_ms(lambda: ops_spgemm.spgemm_reference(c, a, cap), 3),
               bound_ms=b_ms, bound_by=b_by, kernels_device_ms=dev_ms,
               sort_device_ms=sort_ms, flops=flops, expand_cap=cap, nnz=nnz7,
               timed_on=f"A^6 x A of the 30^3 torus: nnz {nnz6} x {int(a.nnz)}, "
                        f"{flops} products, expand_cap = out_cap = {cap}")
    print(f"[3] ESC kernels on {row['timed_on']}: == plain in every field (exact), 6 "
          f"launches; kernel path {row['ms']:.4f} ms (its kernels "
          f"{sum(dev_ms.values()):.4f} ms: {', '.join(f'{k} {v:.4f}' for k, v in dev_ms.items())};"
          f" the key sort {sort_ms:.4f} ms), plain {row['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    return row


PANEL_SCALE, PANEL_COLS = 17, 2048  # graph500_s17.a2_auto's graph and panel width
A2_NNZ_S17 = 1_029_215_160          # nnz of its A^2 (spbench/configs/graph500_s17.json)


def panel_pack_row(dev) -> dict:
    """The tiled route's count and pack kernels (``kernels/panelpack.py``)
    at the ``graph500_s17.a2_auto`` cell's panel shape: Graph 500's
    Kronecker A at SCALE 17 (draw seed 1) and its A^2's first panel of
    2,048 columns, 131,072 x 2,048 f32 from the dense-acc kernel.  Each
    kernel against its plain version on that panel (the count table
    against count_nonzero, the fault word against the exactness max, the
    pack against the tensor ops' pack at the same offsets, every slot), and
    each one's device ms, its plain version's and its bound (the panel read
    once, the counts or the entries written once).  Then the whole A^2
    through ``spgemm_auto``: route denseacc_tiled, 64 panels, two panel
    launches a panel, nnz(A^2) the configuration's, every field equal to
    the tensor-op sweeps' on the card."""
    from sparsetpu_torch.csr import SparseCSR
    from sparsetpu_torch.graphs.generate import graph500_kronecker
    from sparsetpu_torch.kernels import panelpack, spmm
    from sparsetpu_torch.ops import denseacc
    from sparsetpu_torch.ops import spgemm as ops_spgemm
    from sparsetpu_torch.ops.segments import INT32_SENTINEL
    from sparsetpu_torch.semiring import U64

    rows, cols, vals, n = graph500_kronecker(PANEL_SCALE, 16, draw_seed=1)
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64, device=dev)
    w = PANEL_COLS
    op = denseacc.plan_dense_acc(a)
    dense = spmm.spmm_dense_acc(op, denseacc._densify(a, 0, w))
    i32 = dict(dtype=torch.int32, device=dev)
    table, fault = torch.zeros((1, n), **i32), torch.zeros((), **i32)
    panelpack.LAUNCHES = 0
    panelpack.panel_count(dense, table, 0, fault, True)
    want_counts = torch.count_nonzero(dense, dim=1)
    compare("panel_count counts", table[0].long(), want_counts)
    check(int(fault) == 0 and bool(denseacc._exact_f32(dense, "u64")),
          "panel_count's fault disagrees with the exactness max")
    nnz = int(want_counts.sum())
    row_ptr = torch.zeros(n + 1, **i32)
    row_ptr[1:] = torch.cumsum(want_counts, 0)
    prior = torch.zeros((1, n), **i32)
    cap = ops_spgemm.pow2(nnz)
    col = torch.full((cap,), INT32_SENTINEL, **i32)
    limbs = U64.zeros((cap,), device=dev)
    panelpack.panel_pack(dense, 0, row_ptr, prior, 0, col, limbs, "u64", nnz)
    check(panelpack.LAUNCHES == 2, f"{panelpack.LAUNCHES} panel launches, not 2")
    plain_col = torch.full((cap + 1,), INT32_SENTINEL, **i32)
    plain_limbs = U64.zeros((cap + 1,), device=dev)
    zero_prior = torch.zeros(n, dtype=torch.int64, device=dev)

    def pack_plain():
        return denseacc._panel_pack_merge(lambda lo, width: (dense, None), 0, w, row_ptr,
                                          zero_prior, plain_col, plain_limbs, "u64", cap)

    pack_plain()
    for name, g, p in zip(("col_idx", "lo", "hi"), (col, *limbs),
                          (plain_col, *plain_limbs)):
        compare(f"panel_pack {name}", g, p[:cap])
    del plain_col, plain_limbs
    count_b, pack_b = panelpack.count_bytes(n, w), panelpack.pack_bytes(n, w, nnz, 16)
    row = dict(
        count_ms=time_ms(lambda: panelpack.panel_count(dense, table, 0, fault, True), 20),
        count_plain_ms=time_ms(lambda: (torch.count_nonzero(dense, dim=1),
                                        denseacc._exact_f32(dense, "u64")), 5),
        count_bound_ms=bound(count_b)[0],
        pack_ms=time_ms(lambda: panelpack.panel_pack(dense, 0, row_ptr, prior, 0, col, limbs,
                                                     "u64", nnz), 20),
        pack_bound_ms=bound(pack_b)[0], panel_nnz=nnz,
        timed_on=f"the first {w}-column panel of A^2 of Graph 500's SCALE-{PANEL_SCALE} "
                 f"Kronecker graph (draw seed 1): {n} x {w} f32, {nnz} nonzeros")
    # the plain pack's scratch (the panel's slots) is allocated in each call
    plain_col = torch.full((cap + 1,), INT32_SENTINEL, **i32)
    plain_limbs = U64.zeros((cap + 1,), device=dev)
    row["pack_plain_ms"] = time_ms(pack_plain, 3)
    del dense, table, col, limbs, plain_col, plain_limbs, want_counts
    torch.cuda.empty_cache()
    print(f"[3] panel_count and panel_pack on {row['timed_on']}: == plain (exact); count "
          f"{row['count_ms']:.4f} ms (plain {row['count_plain_ms']:.4f}, bound "
          f"{row['count_bound_ms']:.4f}), pack {row['pack_ms']:.4f} ms (plain "
          f"{row['pack_plain_ms']:.4f}, bound {row['pack_bound_ms']:.4f})", flush=True)

    flops = ops_spgemm.symbolic_flops_exact(a, a)
    tiers, route = ops_spgemm.auto_route(a, a, flops)
    panels = -(-n // ops_spgemm.dense_acc_panel_cols(n))
    check(not tiers and route == "denseacc_tiled" and panels == n // w,
          f"spgemm_auto's route {tiers} {route}, {panels} panels: not denseacc_tiled, {n // w}")
    panelpack.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ops_spgemm.spgemm_auto(a, a)
    torch.cuda.synchronize()
    row["a2_ms"] = (time.perf_counter() - t0) * 1e3
    check(panelpack.LAUNCHES == 2 * panels,
          f"the tiled A^2 made {panelpack.LAUNCHES} panel launches, not {2 * panels}")
    check(int(got.nnz) == A2_NNZ_S17, f"nnz(A^2) {int(got.nnz)} != {A2_NNZ_S17}")
    op = denseacc.plan_dense_acc(a)
    want = denseacc._sweeps_in_tensor_ops(
        n, n, "u64", [(lo, min(w, n - lo)) for lo in range(0, n, w)],
        lambda lo, width: denseacc._panel_dense(op, a, lo, width), None, dev)
    for name, g, p in zip(("row_ptr", "col_idx", "lo", "hi", "nnz"),
                          (got.row_ptr, got.col_idx, *got.values, got.nnz),
                          (want.row_ptr, want.col_idx, *want.values, want.nnz)):
        compare(f"tiled A^2 {name}", g, p)
    row.update(a2_panels=panels, a2_panel_launches=panelpack.LAUNCHES, a2_nnz=int(got.nnz))
    del got, want, op
    torch.cuda.empty_cache()
    print(f"[3] spgemm_auto A^2 of the SCALE-{PANEL_SCALE} graph: denseacc_tiled, {panels} "
          f"panels, {row['a2_panel_launches']} panel launches, nnz {row['a2_nnz']}, == the "
          f"tensor-op sweeps in every field; {row['a2_ms']:.1f} ms", flush=True)
    return row


def sdd_library_mask(qi, ki, m: int, n: int):
    """The (m, n) CSR of every element of the listed 128 x 128 blocks (zero
    values): the sampling mask of torch.sparse.sampled_addmm."""
    dev = qi.device
    ar = torch.arange(128, device=dev)
    rows = (qi.long()[:, None, None] * 128 + ar[None, :, None]).expand(-1, 128, 128)
    cols = (ki.long()[:, None, None] * 128 + ar[None, None, :]).expand(-1, 128, 128)
    key = torch.sort((rows * n + cols).reshape(-1)).values
    crow = torch.searchsorted(key // n, torch.arange(m + 1, device=dev))
    return torch.sparse_csr_tensor(crow, key % n, torch.zeros(key.numel(), device=dev),
                                   size=(m, n))


# the kernels the real-graph path can launch (sort-merge only where rowcat's
# fallback fires, ESC's on the router's "esc" route, the panel kernels with
# dense-acc's on the "denseacc_tiled" route: nell_pl's A^4)
REAL_GRAPH_KERNELS = ("spmm_dense_acc", "coalesce_blocks", "sortmerge_rows", "spgemm_esc",
                      "panelpack")


def flat_tensors(out):
    """The tensors of a kernel wrapper's result (a tensor, a SparseCSR or
    nested tuples)."""
    from sparsetpu_torch.csr import SparseCSR

    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, SparseCSR):
        return [out.row_ptr, out.col_idx, *out.values, out.nnz]
    return [t for part in out for t in flat_tensors(part)]


@contextlib.contextmanager
def kernel_inputs(real_graphs, modules, captured):
    """Within the block, each kernel wrapper of ``modules`` ({counter:
    kernel module}; ``wrappers_of``) keeps the arguments of its first call
    in each repeated ``spgemm_auto`` call of the real-graph driver (a chain
    step's timed call: the same operands as the step's first call) in
    ``captured[(wrapper, route)]``.  The step's first call, the one
    profiled, keeps nothing alive.  The wrappers run as before; nothing is
    copied."""
    state = {}
    auto = real_graphs.spgemm_auto
    named = wrappers_of(modules)
    wrappers = {name: getattr(mod, name) for name, (_, mod) in named.items()}

    def routed(a, b, **kwargs):
        last = state.get("b")
        repeat = last is not None and last() is b
        state.clear()
        state.update(b=weakref.ref(b), route=kwargs.get("kernel", "auto"), armed=repeat)
        return auto(a, b, **kwargs)

    def keeping(name):
        def call(*args, **kwargs):
            if state.get("armed") and name not in state:
                state[name] = True
                captured[(name, state["route"])] = (args, kwargs)
            return wrappers[name](*args, **kwargs)
        return call

    real_graphs.spgemm_auto = routed
    for name, (_, mod) in named.items():
        setattr(mod, name, keeping(name))
    try:
        yield
    finally:
        real_graphs.spgemm_auto = auto
        for name, (_, mod) in named.items():
            setattr(mod, name, wrappers[name])


def fresh_outputs(name, args):
    """The panel kernels write into their arguments (positional, as
    ``ops/denseacc``'s sweeps pass them): the arguments with fresh outputs
    in their place, and those outputs.  The count's table and fault word
    start at 0, the pack's columns at INT32_SENTINEL and its limbs at 0, as
    the product's slots that no panel fills."""
    from sparsetpu_torch.ops.segments import INT32_SENTINEL

    args = list(args)
    if name == "panel_count":  # (dense, table, p, fault, check)
        args[1], args[3] = torch.zeros_like(args[1]), torch.zeros_like(args[3])
        return args, [args[1][args[2]], args[3]]
    # panel_pack: (dense, lo, row_ptr, prior, p, col_idx, limbs, sr_name, nnz)
    args[5] = torch.full_like(args[5], INT32_SENTINEL)
    args[6] = tuple(torch.zeros_like(l) for l in args[6])
    return args, [args[5], *args[6]]


def plain_version(name, mod, args, kwargs):
    """A kernel wrapper's plain version on the same inputs.  Dense-acc's
    materialises an (nnz, m) gather (82 GB for nell's A^2 against a 5,120
    column panel), so it runs in column blocks of at most 4 GB: each column
    of C reads the same column of P alone, so the blocks join into the
    same C.  ESC's is the tensor ops of ``ops.spgemm``.  The panel count's
    is ``count_nonzero`` a row and the exactness max (a fault where a cell
    is not below 2^24); the panel pack's is the tensor ops' sweep 2
    (``ops/denseacc._panel_pack_merge``) at the same offsets, into fresh
    slots (``fresh_outputs``' fill), every slot of the product compared."""
    if name == "spgemm_esc":
        from sparsetpu_torch.ops.spgemm import spgemm_reference
        return spgemm_reference(*args, **kwargs)
    if name in PANEL_KERNELS:
        from sparsetpu_torch.ops import denseacc
        from sparsetpu_torch.ops.segments import INT32_SENTINEL

        dense = args[0]
        if name == "panel_count":
            _, _, _, fault, check_exact = args
            fault = ((~denseacc._exact_f32(dense, "u64")).int() if check_exact
                     else torch.zeros_like(fault))
            return [torch.count_nonzero(dense, dim=1).int(), fault]
        _, lo, row_ptr, prior, p, col_idx, limbs, sr_name, nnz = args
        cap = col_idx.numel()
        # slot cap takes the tensor ops' slots past the panel's entries
        col = torch.full((cap + 1,), INT32_SENTINEL, dtype=col_idx.dtype, device=dense.device)
        plain_limbs = [torch.zeros(cap + 1, dtype=l.dtype, device=dense.device) for l in limbs]
        denseacc._panel_pack_merge(lambda *_: (dense, None), lo, dense.shape[1], row_ptr,
                                   prior[p].long(), col, plain_limbs, sr_name,
                                   denseacc.pow2(max(nnz, 1)))
        return [col[:cap], *(l[:cap] for l in plain_limbs)]
    ref = getattr(mod, f"{name}_reference")
    if name == "spmm_dense_acc":
        op, p = args[0], args[1]
        w = max(1, (4 << 30) // (4 * max(op.col_idx.numel(), 1)))
        if w < p.shape[1]:
            return torch.cat([ref(op, p[:, c0:c0 + w].contiguous())
                              for c0 in range(0, p.shape[1], w)], dim=1)
    return ref(*args, **kwargs)


def hold_kernels(where, captured, counters, errs):
    """Run each kernel call kept in ``captured`` ({(wrapper, route): (args,
    kwargs)}) again beside its plain version on the same inputs (exact; the
    max |error| into ``errs[wrapper]``; that launch is not counted) and
    release them; returns the counters compared: those whose every wrapper
    was held."""
    named = wrappers_of(counters)
    held = set()
    for (name, route), (args, kwargs) in sorted(captured.items()):
        mod = named[name][1]
        n_path = mod.LAUNCHES
        if name in PANEL_KERNELS:  # in place: the kernel writes fresh outputs
            args, got = fresh_outputs(name, args)
            getattr(mod, name)(*args, **kwargs)
        else:
            got = flat_tensors(getattr(mod, name)(*args, **kwargs))
        mod.LAUNCHES = n_path  # a comparison's launch is not the path's
        want = flat_tensors(plain_version(name, mod, args, kwargs))
        check(len(got) == len(want), f"{where} {name}: {len(got)} outputs "
              f"!= the plain version's {len(want)}")
        err = max(compare(f"{where} {name} ({route})", g, w) for g, w in zip(got, want))
        errs[name] = max(errs.get(name, 0.0), err)
        held.add(name)
        # dense-acc's P (a panel of the right operand), coalesce's first
        # stream, sort-merge's columns, ESC's right operand's row offsets,
        # the panel kernels' dense C panel
        shown = args[0] if name in PANEL_KERNELS else flat_tensors(args[1])[0]
        print(f"[4] {where} {name} on its first call's inputs in the {route} product "
              f"({tuple(shown.shape)}) == the plain version (exact)", flush=True)
        del got, want, args
    captured.clear()
    return {key for key in counters if all(w in held for w in WRAPPERS.get(key, (key,)))}


def chain_checks(label, a, counters, captured, errs):
    """A ``bench_chain`` ``on_product`` hook, the steps it saw and the
    kernels it compared: the kernel calls kept in ``captured`` during the
    step's timed call are held against their plain versions
    (``hold_kernels``); on cora_pl each step's product A x A^(k-1) is also
    held against the C++ oracle's whole CSR (row offsets, columns,
    values)."""
    from sparsetpu_torch import native
    from sparsetpu_torch.bench import spgemm_bench

    host_a = native.as_host_csr(*a.to_numpy()) if label == "cora_pl" else None
    prev, steps, compared = [host_a], [], set()

    def on_product(step, c):
        steps.append(step)
        compared.update(hold_kernels(f"{label} A^{step}", captured, counters, errs))
        if host_a is not None:
            want = native.spgemm(host_a, prev[0], a.n_rows)
            spgemm_bench.check_against_oracle(c, want, f"{label} A^{step}")
            prev[0] = want
    return on_product, steps, compared


def real_graph_phase(dev, counters, reset_counts):
    """Phase 4's real-graph study (bench/real_graphs.py) on the card; returns
    (per-graph results, the int8 panel rates, the path's kernel launches,
    each kernel's device ms summed over the steps' first calls, each
    kernel's max |error| against its plain version on the path's own
    inputs).  Raises on any failed check."""
    import scipy.sparse as ssp
    from scipy.sparse import csgraph

    from sparsetpu_torch import U64, SparseCSR
    from sparsetpu_torch.bench import real_graphs
    from sparsetpu_torch.graphs import algos as graph_algos, patterns

    # the pattern engine's int8 product first, then per graph: cora_pl and
    # nell_pl (the structure report with RCM, A^2..A^4 at --iters 1,
    # reachability and the diameter), cora_pl's band hybrid, ogbn_arxiv_pl
    # (the structure report without RCM, A^2)
    x = (torch.rand(300, 300, device=dev) < 0.02).to(torch.int8)
    frame = torch.zeros(384, 384, dtype=torch.int8, device=dev)
    frame[:300, :300] = x
    want = ((frame.double() @ frame.double()) > 0).to(torch.int8)
    for rows in (160, 384):  # a panel edge inside the padding, and one panel
        check(torch.equal(patterns.matmul(frame, frame, panel_rows=rows), want),
              f"int8 pattern product (panels of {rows} rows) != the float64 reference")
    side = patterns.frame_side(65755)
    big = torch.zeros(side, side, dtype=torch.int8, device=dev)
    big.view(-1)[torch.randint(0, side * side, (1 << 22,), device=dev)] = 1
    rows = patterns._panel_rows(side)
    int8_rate = {}
    for layout, y in (("column-major", patterns.col_major(big)), ("row-major", big)):
        ms = time_ms(lambda: torch._int_mm(big[:rows], y), 2)
        int8_rate[layout] = 2 * rows * side * side / ms / 1e9
        print(f"[4] int8 pattern product, one {rows}-row panel of the {side}^2 frame, second "
              f"operand {layout}: {ms:.3f} ms, {int8_rate[layout]:.1f} TOP/s "
              f"({int8_rate[layout] / INT8_TOPS * 100:.1f} % of the data sheet's "
              f"{INT8_TOPS:.0f})", flush=True)
    del big, y, x, frame, want
    torch.cuda.empty_cache()

    real = {}
    rg_ms = dict.fromkeys(counters, 0.0)
    rg_launches = dict.fromkeys(counters, 0)
    rg_err = {}
    for gname, n_g, m_g in real_graphs.GRAPHS:
        label, coo = real_graphs.load_or_synthesize(gname, n_g, m_g)
        rows_g, cols_g, vals_g, _ = coo
        a_g = SparseCSR.from_coo_host(rows_g, cols_g, vals_g, n_g, sr=U64, device=dev)
        ogbn = gname == "ogbn_arxiv"
        max_power = 2 if ogbn else 4
        t0 = time.perf_counter()
        report = real_graphs.structure_report(label, coo, a_g, with_rcm=not ogbn)
        t_struct = time.perf_counter() - t0
        for line in report:
            print(f"[4] {line}", flush=True)
        adj = ssp.csr_matrix((np.ones(len(rows_g)), (rows_g, cols_g)), shape=(n_g, n_g))
        n_comp, labels = csgraph.connected_components(adj, directed=True, connection="weak")
        check(same_partition(graph_algos.connected_components(a_g), labels),
              f"{label}: connected_components != scipy's partition")
        entry = real[label] = dict(structure_s=t_struct, components=int(n_comp))
        captured = {}
        on_product, steps, compared = chain_checks(label, a_g, counters, captured, rg_err)
        reset_counts()
        details = []
        with kernel_inputs(real_graphs, {k: counters[k] for k in REAL_GRAPH_KERNELS}, captured):
            chain = real_graphs.bench_chain(label, a_g, max_power, iters=1,
                                            verbose=False, details=details,
                                            on_product=on_product)
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        check(steps == list(range(2, max_power + 1)), f"{label}: steps checked {steps}")
        check({k for k in REAL_GRAPH_KERNELS if counts[k]} <= compared,
              f"{label}: launched {counts}, compared with the plain version {compared}")
        got = [int(r.split(",")[4]) for r in chain if r.split(",")[4].isdigit()]
        check(got == REAL_NNZ[label], f"{label} chain nnz {got} != {REAL_NNZ[label]} ({chain})")
        check(counts["coalesce_blocks"] >= 1, f"{label} chain made no coalesce_blocks launch")
        if label == "nell_pl":
            check(counts["spmm_dense_acc"] >= 1, "nell_pl A^4 made no spmm_dense_acc launch")
        for name in counters:
            rg_launches[name] += counts[name]
        for d in details:
            for name, ms in d.get("kernel_ms", {}).items():
                rg_ms[name] += ms
            print(f"[4] {label} A^{d['step']} [{d['algo']}]: nnz {d['nnz']} (r5's); "
                  f"{d['seconds']:.6f} s (the first call {d['first_call_s']:.6f} s, device "
                  f"{d['first_call_device_s']:.6f} s, idle {d['idle_share']:.1%}); peak "
                  f"allocated {d['peak_bytes'] / 1e9:.2f} GB; kernels (first call) "
                  f"{d['kernel_ms']}", flush=True)
        entry["chain"] = details
        held = "A^2..A^4" if label == "cora_pl" else "A^2"
        print(f"[4] {label}: {held} == the oracle's whole CSR; components == scipy's "
              f"partition ({n_comp}); launches {counts}", flush=True)
        if label == "cora_pl":
            hyb = real_graphs.bench_band_hybrid(label, a_g, iters=1, verbose=False)
            check(len(hyb) == 2 and not any("DNF" in r for r in hyb)
                  and int(hyb[0].split(",")[4]) == REAL_NNZ[label][0],
                  f"cora_pl band hybrid: {hyb}")
            entry["hybrid"] = {r.split(",")[3]: float(r.split(",")[6]) for r in hyb}
            print(f"[4] cora_pl band hybrid == spgemm_auto's CSR value for value: {hyb}",
                  flush=True)
        if not ogbn:
            adet = []
            alg = real_graphs.bench_algos(label, a_g, verbose=False, details=adet)
            (_, _, _, _, reach_nnz, reach_k, _, _), (_, _, _, _, diam, _, _, _) = (
                r.split(",") for r in alg)
            sizes = np.bincount(labels).astype(np.int64)
            want_reach = int((sizes[sizes >= 2] ** 2).sum())
            t0 = time.perf_counter()
            want_diam = real_graphs.host_diameter(coo)
            t_host = time.perf_counter() - t0
            check(reach_nnz.isdigit() and int(reach_nnz) == want_reach,
                  f"{label} reachability {alg[0]}: nnz != sum |C|^2 = {want_reach}")
            check(diam.isdigit() and int(diam) == want_diam,
                  f"{label} diameter {alg[1]} != the host's exact {want_diam}")
            # one component: the powers' pattern settles one step past the
            # diameter, so k also pins the products' reach
            check(n_comp > 1 or int(reach_k) == want_diam + 1,
                  f"{label} reachability k = {reach_k} != the diameter {want_diam} + 1")
            if label == "cora_pl":
                check((int(reach_nnz), int(reach_k), int(diam)) == (7_333_264, 11, 10),
                      f"cora_pl reachability / diameter {alg} != r5's")
            for d in adet:
                d["int8_tops"] = d["int8_ops"] / d["seconds"] / 1e12
                print(f"[4] {label} {d['algo']}: {d['seconds']:.6f} s; peak allocated "
                      f"{d['peak_bytes'] / 1e9:.2f} GB; {d['int8_ops']:.4e} int8 operations, "
                      f"{d['int8_tops']:.1f} TOP/s ({d['int8_tops'] / INT8_TOPS * 100:.1f} % "
                      f"of the data sheet's {INT8_TOPS:.0f})", flush=True)
            entry["algos"] = adet
            entry["reachability"], entry["diameter"] = int(reach_nnz), int(diam)
            print(f"[4] {label}: reachability nnz {reach_nnz} at k = {reach_k} == sum |C|^2 "
                  f"over components of >= 2 nodes; diameter {diam} == the host's exact BFS "
                  f"({t_host:.1f} s)", flush=True)
        del a_g
        torch.cuda.empty_cache()

    return real, int8_rate, rg_launches, rg_ms, rg_err


# the kernels the einsum engine's path can launch: coalesce (colchunk and
# slab products), dense-acc (the panel sweep), sort-merge (the rowcat
# fallback), ESC's (the "esc" route)
ENGINE_KERNELS = REAL_GRAPH_KERNELS
ENGINE_N, ENGINE_NNZ_PER_ROW = 27000, 8  # engine_bench's cells (BASELINE configs 3-4)
NELL_A4_NNZ = 321_409_501  # reports/real_graphs_r5.csv line 11
BTREE_KEYS, BTREE_QUERIES = 1 << 24, 1 << 16  # reports/probe_btree.csv's largest row


@contextlib.contextmanager
def engine_kernel_inputs(modules, captured, products):
    """Within the block, every ``spgemm_auto`` call (the einsum engine's
    chain tier calls it through ``ops.spgemm``) appends (product count,
    dense-dense tiers, route) to ``products``, and each kernel wrapper of
    ``modules`` ({counter: kernel module}; ``wrappers_of``) keeps the
    arguments of its first call under each route in ``captured[(wrapper,
    route)]``, unless one is kept already.  The wrappers run as before;
    nothing is copied."""
    from sparsetpu_torch.ops import spgemm as spgemm_ops

    state = {}
    auto = spgemm_ops.spgemm_auto
    named = wrappers_of(modules)
    wrappers = {name: getattr(mod, name) for name, (_, mod) in named.items()}

    def routed(a, b, **kwargs):
        flops = spgemm_ops.symbolic_flops_exact(a, b)
        kernel = kwargs.get("kernel", "auto")
        tiers, route = (spgemm_ops.auto_route(a, b, flops) if kernel == "auto"
                        else ([], kernel))
        products.append(dict(flops=flops, densedense_tiers=len(tiers), route=route))
        state["route"] = route
        return auto(a, b, **kwargs)

    def keeping(name):
        def call(*args, **kwargs):
            key = (name, state.get("route"))
            if key not in captured:
                captured[key] = (args, kwargs)
            return wrappers[name](*args, **kwargs)
        return call

    spgemm_ops.spgemm_auto = routed
    for name, (_, mod) in named.items():
        setattr(mod, name, keeping(name))
    try:
        yield
    finally:
        spgemm_ops.spgemm_auto = auto
        for name, (_, mod) in named.items():
            setattr(mod, name, wrappers[name])


def engine_phase(dev, counters, reset_counts, h30, oracle30):
    """Phase 4's einsum-engine path on the card; returns (its results, each
    kernel's launches over the phase, each kernel's device ms summed over
    one call of each held einsum, each kernel's max |error| against its
    plain version on the phase's own inputs).  Raises on any failed check.
    ``h30``: the 30^3 torus (HostCSR); ``oracle30``: the oracle's
    A^2..A^7."""
    from sparsetpu_torch import U64, SparseCSR
    from sparsetpu_torch.attention.scores import attention_scores_dense, random_sparse_tensor
    from sparsetpu_torch.bench import engine_bench, real_graphs, spgemm_bench
    from sparsetpu_torch.einsum import engine
    from sparsetpu_torch.grouped import GroupedCSR
    from sparsetpu_torch.ops.spgemm import spgemm_auto
    from sparsetpu_torch.semiring import F32SR
    from sparsetpu_torch.utils import dense_btree

    modules = {k: counters[k] for k in ENGINE_KERNELS}
    a30 = SparseCSR.from_host_arrays(h30.row_ptr, h30.col_idx, U64.to_host_limbs(h30.vals),
                                     h30.nnz, h30.n_rows, h30.n_cols, U64, dev)
    out = {}
    eng_ms = dict.fromkeys(counters, 0.0)
    eng_err = {}

    def held_einsum(label, spec, ops, **kwargs):
        """One einsum twice: the first call under torch.profiler (each
        kernel's device ms; its spgemm_auto products' routes), the second
        by the host clock after a synchronisation, keeping each kernel's
        first-call inputs, which are then held against the plain versions."""
        products, captured = [], {}
        with engine_kernel_inputs(modules, {}, products):
            ms = profiled(lambda: engine.einsum(spec, ops, **kwargs), counters)[1]
        for name, v in ms.items():
            eng_ms[name] += v
        for p in products:
            print(f"[4] {label}: a product of {p['flops']:,} partial products -> route "
                  f"{p['route']} ({p['densedense_tiers']} dense-dense tiers tried first)",
                  flush=True)
        before = {name: mod.LAUNCHES for name, mod in modules.items()}
        with engine_kernel_inputs(modules, captured, []):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.einsum(spec, ops, **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launched = {name for name, mod in modules.items() if mod.LAUNCHES > before[name]}
        compared = hold_kernels(label, captured, counters, eng_err)
        check(launched <= compared, f"{label}: launched {sorted(launched)}, held against "
              f"the plain version {sorted(compared)}")
        return res, dict(seconds=secs, products=products, kernel_ms=ms,
                         held=sorted(compared))

    reset_counts()

    # 1. engine_bench's four tiers at ER 27,000 x 8 (each engine result held
    # against its direct call inside run; a disagreement raises)
    details = {}
    t0 = time.perf_counter()
    csv = engine_bench.run(n=ENGINE_N, nnz_per_row=ENGINE_NNZ_PER_ROW, reps=2, iters=2,
                           verbose=False, device=dev, details=details)
    lines = csv.strip().split("\n")
    check(lines[0] == engine_bench.HEADER and len(lines) == 12, f"engine_bench rows {lines}")
    out["engine_bench"] = dict(rows={f"{r.split(',')[0]} {r.split(',')[1]}": float(r.split(',')[2])
                                     for r in lines[1:]},
                               details=details, seconds=time.perf_counter() - t0)
    print(f"[4] engine_bench n={ENGINE_N} x {ENGINE_NNZ_PER_ROW}: every engine result == its "
          f"direct call (dense bit for bit; sparse and chain the whole CSR; SpMM max |err| "
          f"{details['spmm_max_abs_err']:.3e} within rtol {engine_bench.SPMM_RTOL}, atol "
          f"{engine_bench.SPMM_ATOL}); routes A.B {details['spgemm']['route']} "
          f"({details['spgemm']['flops']:,} products), (AB).C {details['chain']['route'][1]} "
          f"({details['chain']['flops'][1]:,}); {out['engine_bench']['seconds']:.1f} s",
          flush=True)
    for line in lines[1:]:
        print(f"[4] engine_bench {line}", flush=True)
    torch.cuda.empty_cache()

    # 2. the chain tier on the 30^3 torus: A^3 against the oracle's whole CSR
    (a3,), det = held_einsum("torus A^3 (engine)", "ab,bc,cd->ad", [a30, a30, a30], sr=U64,
                             out_format="sparse")
    spgemm_bench.check_against_oracle(a3, oracle30[1], "engine torus A^3")
    check([p["flops"] for p in det["products"]] == [314_066, 938_569],
          f"torus chain products {det['products']}")
    out["torus_a3"] = dict(nnz=int(a3.nnz), **det)
    print(f"[4] einsum ab,bc,cd->ad on the 30^3 torus: A^3 == the oracle's whole CSR (nnz "
          f"{int(a3.nnz):,}); {det['seconds']:.4f} s", flush=True)

    # 4. the exact entry-driven tier: sum of A^4 * A, A^4 = spgemm_auto(A^3, A)
    a4 = spgemm_auto(a3, a30)
    spgemm_bench.check_against_oracle(a4, oracle30[2], "torus A^4")
    rp4, ci4, v4 = oracle30[2]
    rp1, ci1, v1 = a30.to_numpy()
    n30 = a30.n_rows
    k4 = np.repeat(np.arange(n30, dtype=np.int64), np.diff(rp4)) * n30 + ci4
    k1 = np.repeat(np.arange(n30, dtype=np.int64), np.diff(rp1.astype(np.int64))) * n30 + ci1
    _, i4, i1 = np.intersect1d(k4, k1, assume_unique=True, return_indices=True)
    want_sum = sum(int(x) * int(y) for x, y in zip(v4[i4], v1[i1]))
    (tot,), det = held_einsum("torus A^4 . A (engine)", "ab,ab->", [a4, a30], sr=U64)
    got_sum = int(tot[0]) | (int(tot[1]) << 32)
    check(got_sum == want_sum, f"sum(A^4 * A) {got_sum} != numpy's {want_sum}")
    out["exact_tier"] = dict(sum=got_sum, a4_entries=int(a4.nnz), a4_capacity=a4.capacity,
                             **det)
    print(f"[4] einsum ab,ab-> (exact entry-driven, u64) on A^4 ({int(a4.nnz):,} entries, "
          f"capacity {a4.capacity:,}) and A: {got_sum:,} == numpy on the oracle's CSRs; "
          f"{det['seconds']:.4f} s", flush=True)
    del a3, a4
    torch.cuda.empty_cache()

    # 3. the chain tier on nell_pl: A^4 as (A.A).(A.A)
    label, (r, c, v, n) = real_graphs.load_or_synthesize("nell", 65755, 251550)
    a_nell = SparseCSR.from_coo_host(r, c, v, n, sr=U64, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (a4n,), det = held_einsum(f"{label} A^4 (engine)", "ab,bc,cd,de->ae", [a_nell] * 4,
                              sr=U64, out_format="sparse")
    check(int(a4n.nnz) == NELL_A4_NNZ, f"{label} A^4 nnz {int(a4n.nnz)} != {NELL_A4_NNZ}")
    out["nell_a4"] = dict(nnz=int(a4n.nnz), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          **det)
    print(f"[4] einsum ab,bc,cd,de->ae on {label}: A^4 nnz {int(a4n.nnz):,} == r5's; "
          f"{det['seconds']:.4f} s; peak allocated {out['nell_a4']['peak_gb']:.2f} GB",
          flush=True)
    del a4n, a_nell
    torch.cuda.empty_cache()

    # 5. the grouped tier at GPT-2 117M: config 1's Q and K at density 1e-2
    shape1 = (8, 1024, 12, 64)
    q = random_sparse_tensor(shape1, 1e-2, seed=0)
    k = random_sparse_tensor(shape1, 1e-2, seed=1)
    g = shape1[0] * shape1[1]
    gq = GroupedCSR.from_dense(q.reshape(g, 12, 64), sr=F32SR, device=dev)
    gk = GroupedCSR.from_dense(np.swapaxes(k.reshape(g, 12, 64), 1, 2), sr=F32SR, device=dev)
    (scores,), det = held_einsum("GPT-2 117M scores (engine)", "bij,bjk->bik", [gq, gk])
    want = attention_scores_dense(torch.from_numpy(q).to(dev),
                                  torch.from_numpy(k).to(dev)).reshape(g, 12, 12)
    err = compare_close("grouped tier scores", scores, want, 1e-4, 1e-5)
    out["grouped"] = dict(shape=list(scores.shape), max_abs_err=err, **det)
    print(f"[4] einsum bij,bjk->bik on GroupedCSR (8,192, 12, 64) x (8,192, 64, 12), "
          f"density 1e-2: == attention_scores_dense (max |err| {err:.3e}, rtol 1e-4, atol "
          f"1e-5); {det['seconds']:.4f} s", flush=True)
    del gq, gk, scores, want

    # 6. the device btree: 2^24 sorted keys, 2^16 queries, half of them misses
    gen = torch.Generator(dev).manual_seed(7)
    keys = torch.cumsum(torch.randint(2, 256, (BTREE_KEYS,), generator=gen, device=dev), 0)
    half = BTREE_QUERIES // 2
    hits = keys[torch.randint(0, BTREE_KEYS, (half,), generator=gen, device=dev)]
    # a key + 1 is never a key (gaps of 2 or more) nor above the last key
    misses = keys[torch.randint(0, BTREE_KEYS - 1, (half,), generator=gen, device=dev)] + 1
    qs = torch.cat([hits, misses])
    levels, padded = dense_btree.build_device_btree(keys)
    pos, hit = dense_btree.btree_lookup_device(levels, padded, qs)
    want_pos = torch.searchsorted(keys, qs)
    want_hit = keys[want_pos.clamp(max=BTREE_KEYS - 1)] == qs
    check(torch.equal(pos, want_pos) and torch.equal(hit, want_hit)
          and int(hit.sum()) == half, "btree (pos, hit) != searchsorted's")
    bt_ms = time_ms(lambda: dense_btree.btree_lookup_device(levels, padded, qs), 10)
    ss_ms = time_ms(lambda: torch.searchsorted(keys, qs), 10)
    out["btree"] = dict(keys=BTREE_KEYS, queries=BTREE_QUERIES, levels=len(levels),
                        btree_ms=bt_ms, searchsorted_ms=ss_ms)
    print(f"[4] device btree, {BTREE_KEYS:,} keys ({len(levels)} levels), {BTREE_QUERIES:,} "
          f"queries (half misses): (pos, hit) == torch.searchsorted + equality; btree "
          f"{bt_ms:.4f} ms, searchsorted {ss_ms:.4f} ms", flush=True)
    del keys, qs, padded, levels, pos, hit
    torch.cuda.empty_cache()

    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    check(counts["coalesce_blocks"] >= 1, f"einsum engine phase made no coalesce launch: {counts}")
    held = {name for item in ("torus_a3", "exact_tier", "nell_a4", "grouped")
            for name in out[item]["held"]}
    out["launches"] = counts
    print(f"[4] einsum engine phase: launches {counts}; held exactly against their plain "
          f"versions: {sorted(held)}", flush=True)
    return out, counts, eng_ms, eng_err


DIST_RANKS = 4                # ranks sharing the one card over gloo
RING_PAIRS = ((2, 2), (3, 4))  # A^2 x A^2 -> A^4, A^3 x A^4 -> A^7, both operands sharded
SCALING_STEPS, SCALING_ITERS = 2, 2  # the scaling rows: --steps 2 --iters 2
BAND_A2_NNZ = EXPECTED[0][1]


def same_csr(got, want) -> bool:
    """Two host CSRs (row_ptr, col_idx, vals) hold the same entries, bit for
    bit."""
    rp, ci, v = got
    wrp, wci, wv = want
    nnz = int(wrp[-1])
    return (np.array_equal(np.asarray(rp, np.int64), np.asarray(wrp, np.int64))
            and np.array_equal(np.asarray(ci), np.asarray(wci)[:nnz])
            and np.array_equal(np.asarray(v, np.uint64), np.asarray(wv, np.uint64)[:nnz]))


def dist_phase(dev, counters, reset_counts, h30, oracle30, esc_chain_ms, att_rows):
    """Row-partitioned execution (``sparsetpu_torch/dist``) on the full 30^3
    torus; raises on any failed check.  ``oracle30``: the oracle's A^2..A^7;
    ``esc_chain_ms``: the esc chain's total in this run; ``att_rows``: the
    attention path's tipover rows by density.  Returns the phase's record."""
    import tempfile

    from sparsetpu_torch import entry
    from sparsetpu_torch.bench import chain as tchain, configs, memcross, report, scaling
    from sparsetpu_torch.bench.chain import BAND_BLOCKS
    from sparsetpu_torch.bench.tipover import HEADER
    from sparsetpu_torch.dist import multihost, programs
    from sparsetpu_torch.kernels import bandmm

    t_phase = time.perf_counter()
    cfg = configs.CHAIN_CONFIGS["torus30"]
    n = h30.n_rows
    check((cfg.dims, cfg.density, cfg.seed, cfg.n, h30.nnz) == (DIMS30, 3.0 / 26.0, 42, n, 80_882),
          f"configs torus30 {cfg} is not the smoke's 30^3 torus")
    arrays = (h30.row_ptr, h30.col_idx, h30.vals, n, n, h30.sr_name)
    # the band of the band chain: configs' nominal half-width (931) leaves
    # 606 entries of the thinned torus outside; its cyclic bandwidth none
    half_width = bandmm.cyclic_bandwidth(h30)
    torch.cuda.empty_cache()
    reset_counts()
    out = {}

    # one rank on NCCL: the sharded chain, the product kept sharded; then
    # the scaling chain's one-rank row
    scaling_args = (arrays, SCALING_STEPS, SCALING_ITERS)
    check(multihost.world_backend(1, dev) == "nccl", "one rank on the card is not over NCCL")
    t0 = time.perf_counter()
    one_iters, four_iters = 3, 2
    (one, one_sp), = multihost.run_local(programs.run_all, 1, [
        ("smoke", (arrays, STEPS, one_iters, (4, STEPS), (), None)),
        ("scaling_point", scaling_args)])
    t_one = time.perf_counter() - t0
    check(one["transport"] == "nccl", f"one rank ran over {one['transport']}")
    got = [(r["step"], r["nnz"], r["max"]) for r in one["steps"]]
    check(got == EXPECTED, f"sharded chain, 1 rank: (step, nnz, max) {got} != {EXPECTED}")
    check(same_csr(one["wholes"][4], oracle30[2]), "1 rank: unshard(A^4) != the oracle's")
    check(same_csr(one["wholes"][STEPS], oracle30[-1]), "1 rank: unshard(A^7) != the oracle's")
    chain_ms = sum(r["ms"] for r in one["steps"])
    print(f"[4] dist, 1 rank over nccl: per-step (nnz, max) == published table; unshard(A^4), "
          f"unshard(A^{STEPS}) == the oracle's whole CSR", flush=True)
    for r in one["steps"]:
        print(f"[4] dist 1 rank A^{r['step']} step: {r['ms']:.4f} ms (flop read included; "
              f"expand_cap {r['expand_cap']})", flush=True)
    print(f"[4] dist 1 rank chain total A^2..A^{STEPS}: {chain_ms:.4f} ms; the esc chain in this "
          f"run: {esc_chain_ms:.4f} ms; world {t_one:.1f} s", flush=True)
    out["one_rank"] = {"transport": one["transport"], "world_s": t_one, "chain_ms": chain_ms,
                       "steps": one["steps"], "esc_chain_ms": esc_chain_ms}

    # four ranks sharing the card over gloo: the chain, the ring, the band;
    # then the scaling chain's four-rank row and the dry run
    check(multihost.world_backend(DIST_RANKS, dev) == "gloo",
          f"{DIST_RANKS} ranks on {torch.cuda.device_count()} card(s) are not over gloo")
    t0 = time.perf_counter()
    four = multihost.run_local(programs.run_all, DIST_RANKS, [
        ("smoke", (arrays, STEPS, four_iters, (STEPS,), RING_PAIRS,
                   (half_width, BAND_BLOCKS[n]))),
        ("scaling_point", scaling_args), ("dryrun", ())])
    t_four = time.perf_counter() - t0
    r0 = four[0][0]
    check({r[0]["transport"] for r in four} == {"gloo"}, "the shared-card ranks are not over gloo")
    got = [(r["step"], r["nnz"], r["max"]) for r in r0["steps"]]
    check(got == EXPECTED, f"sharded chain, {DIST_RANKS} ranks: (step, nnz, max) {got}")
    check(same_csr(r0["wholes"][STEPS], one["wholes"][STEPS]),
          f"{DIST_RANKS} ranks: unshard(A^{STEPS}) != the 1-rank result")
    want_ring = {(2, 2): (4, EXPECTED[2][1]), (3, 4): (STEPS, EXPECTED[-1][1])}
    for ring in r0["ring"]:
        k, nnz = want_ring[(ring["p"], ring["q"])]
        check(ring["nnz"] == nnz, f"ring A^{ring['p']} x A^{ring['q']} nnz {ring['nnz']} != {nnz}")
        check(same_csr(ring["whole"], one["wholes"][k]),
              f"ring A^{ring['p']} x A^{ring['q']} != the 1-rank A^{k}, bit for bit")
    band = r0["band"]
    check(band["bit_equal"] and band["nnz"] == BAND_A2_NNZ and band["nb"] == 216
          and band["nb_local"] == 216 // DIST_RANKS,
          f"sharded band product {band} is not the unsharded one with nnz {BAND_A2_NNZ}")
    # each rank: the sharded chain's products on ESC's kernels (one a step
    # and pass), no other kernel; each step's first product held against
    # the tensor ops on its own inputs
    ranks = [one] + [r[0] for r in four]
    launches = [dict(r["launches"]) for r in ranks]
    want_esc = [ESC_PER_PRODUCT * (STEPS - 1) * it
                for it in [one_iters] + [four_iters] * DIST_RANKS]
    check([l.pop("spgemm_esc") for l in launches] == want_esc
          and all(not any(l.values()) for l in launches),
          f"dist path launches {[dict(r['launches']) for r in ranks]}: not {want_esc} of "
          f"ESC's kernels alone")
    check([r["esc_held"] for r in ranks] == [STEPS - 1] * len(ranks),
          f"ESC products held against the tensor ops a rank: {[r['esc_held'] for r in ranks]}")
    out["esc"] = {"launches": want_esc, "held": STEPS - 1}
    for r in r0["steps"]:
        print(f"[4] dist {DIST_RANKS} ranks A^{r['step']} step: {r['ms']:.4f} ms; "
              f"work_imbalance {r['imbalance']:.4f}", flush=True)
    for ring in r0["ring"]:
        print(f"[4] dist ring A^{ring['p']} x A^{ring['q']}: nnz {ring['nnz']}, == the 1-rank "
              f"product bit for bit; step_cap {ring['step_cap']}, out_cap {ring['out_cap']}; "
              f"{ring['ms']:.4f} ms", flush=True)
    print(f"[4] dist, {DIST_RANKS} ranks over gloo (one card): (nnz, max) == published table, "
          f"unshard(A^{STEPS}) == the 1-rank result bit for bit; band A^2 (block "
          f"{band['block']}, half-width {band['half_width']}, {band['nb']} block rows, "
          f"{band['nb_local']} a rank) == the unsharded band_matmul bit for bit, nnz "
          f"{band['nnz']}, {band['ms']:.4f} ms; world {t_four:.1f} s; ESC's kernels alone "
          f"launched, {want_esc} a rank, each step's first product in every rank == the "
          f"tensor ops (exact)", flush=True)
    out["four_ranks"] = {"transport": "gloo", "world_s": t_four, "steps": r0["steps"],
                         "chain_ms": sum(r["ms"] for r in r0["steps"]),
                         "ring": [{k: v for k, v in ring.items() if k != "whole"}
                                  for ring in r0["ring"]], "band": band}

    # the scaling rows at 1, 2 and 4 ranks (--steps 2): the 2-rank world
    # here, the others from the worlds above; the CSV as the CLI writes it
    t0 = time.perf_counter()
    two_sp = multihost.run_local(programs.scaling_point, 2, *scaling_args)[0]
    t_two = time.perf_counter() - t0
    points = scaling.scale_points([(1, one_sp), (2, two_sp), (DIST_RANKS, four[0][1])])
    text = scaling.write_csv(points, "cuda", f"{cfg.name} (n={n}, nnz={h30.nnz}), steps="
                             f"{SCALING_STEPS}, iters={SCALING_ITERS}", "reports/scaling_h100.csv")
    check([p.transport for p in points] == ["nccl", "gloo", "gloo"]
          and f"hardware_meaningful=NO for seconds/nnz_per_s/efficiency at devices=[2, "
              f"{DIST_RANKS}]" in text, f"scaling CSV:\n{text}")
    out["scaling"] = {"world_s": t_two, "points": [vars(p) for p in points]}

    # the dry run's verdict, then memcross and the report on the phase's CSVs
    dry = entry.dryrun_verdict(DIST_RANKS, four[0][2])
    out["dryrun"] = dry
    with tempfile.TemporaryDirectory() as tmp:
        first = att_rows[min(att_rows)][0]
        rows = [",".join(r[impl]) for _, r in (att_rows[d] for d in sorted(att_rows))
                for impl in ("esc", "sdd") if impl in r]
        with open(os.path.join(tmp, "tipover_results_1.csv"), "w") as f:
            f.write("\n".join([first, HEADER] + rows) + "\n")
        memcross.main(["--dir", tmp, "--configs", "1", "--out",
                       os.path.join(tmp, "memory_crossover.csv")])
        with open(os.path.join(tmp, "memory_crossover.csv")) as f:
            mem = [l for l in f.read().split("\n") if l.startswith("1,")]
        n_esc = sum("esc" in r for _, r in att_rows.values())
        check(len(mem) == n_esc, f"memcross gave {len(mem)} rows for {n_esc} ESC densities")
        steps = [tchain.ChainStep(step=r["step"], nnz=r["nnz"], flops=r["flops"],
                                  seconds=r["ms"] / 1e3, nnz_per_s=r["nnz"] / (r["ms"] / 1e3),
                                  gflops=2.0 * r["flops"] / (r["ms"] / 1e3) / 1e9)
                 for r in one["steps"]]
        with open(os.path.join(tmp, "chain_sharded_1rank.csv"), "w") as f:
            f.write(tchain.chain_csv(steps))
        with open(os.path.join(tmp, "scaling_h100.csv"), "w") as f:
            f.write(text)
        report.main(["--bench-dir", tmp, "--out", os.path.join(tmp, "report.md")])
        with open(os.path.join(tmp, "report.md")) as f:
            md = f.read()
        for title in ("chain_sharded_1rank.csv", "tipover_results_1.csv", "scaling_h100.csv"):
            check(f"### {title}" in md, f"the report lacks the {title} table")
    out["memcross_rows"] = mem
    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[4] dist: scaling CSV written (reports/scaling_h100.csv, the sharing caveat in its "
          f"header); dryrun_multichip({DIST_RANKS}) {dry}; memcross {len(mem)} rows; report "
          f"{len(md)} chars; parent's launches {counts}; phase {out['phase_s']:.1f} s",
          flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "smoke test needs a CUDA card")
    from sparsetpu_torch import native
    from sparsetpu_torch.attention.scores import random_sparse_tensor
    from sparsetpu_torch.bench import tipover
    from sparsetpu_torch.bench.chain import (
        BAND_BLOCKS, build_torus_host, fold, native_chain_stats_host, run_chain,
        run_chain_band, run_chain_dense, run_chain_dense_acc, run_chain_escb,
        run_chain_foldband, run_chain_mixed, run_chain_rowcat, sparse_operand,
        tuple_to_f32_dense, unfold_band, verify_final_values)
    from sparsetpu_torch.bench import (coalesce_sources, sortmerge_phases, spgemm_bench,
                                       spmm_sources)
    from sparsetpu_torch.csr import HostCSR
    from sparsetpu_torch.graphs.generate import random_graph
    from sparsetpu_torch.kernels import (_build, bandmm, bandplanes, blocksparse, coalesce,
                                         esc, groupdot, panelpack, sortmerge, spmm)
    from sparsetpu_torch.ops import colchunk, denseacc, slab as slab_ops
    from sparsetpu_torch.ops.spgemm import (auto_route, dense_acc_panel_cols, spgemm_auto,
                                            symbolic_flops_exact)
    from sparsetpu_torch.ops.hybrid import choose_strategy
    from sparsetpu_torch.ops.segments import INT32_SENTINEL

    # the plain group-dot and SDD versions and the dense scores contract with
    # torch.bmm/einsum: full f32 only, so TF32 stays off (the default, stated
    # here; they raise otherwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    counters = {"spmm_dense_acc": spmm, "spmm_band": bandplanes,
                "spmm_group_dot": groupdot, "sdd_block_scores": blocksparse,
                "sortmerge_rows": sortmerge, "coalesce_blocks": coalesce, "spgemm_esc": esc,
                "panelpack": panelpack}

    def reset_counts():
        for mod in counters.values():
            mod.LAUNCHES = 0

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    t_start = time.perf_counter()

    def since_start(what):
        print(f"[t] {what} starts at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 1: card identity
    print(f"[1] card: {card} | torch: {kind} | count={torch.cuda.device_count()} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build
    t0 = time.perf_counter()
    report = _build.build()
    lib = _build.load()
    check(lib.sortmerge_rows_max_l() == sortmerge.MAX_L,
          f"the kernel's longest row {lib.sortmerge_rows_max_l()} != {sortmerge.MAX_L}")
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    t_oracle = time.perf_counter() - t0
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"    nvcc: {line.strip()}")
    print(f"[2] built kernels in {t_kernels:.2f}s, oracle in {t_oracle:.2f}s", flush=True)

    since_start("phase 3 (kernels against their plain versions)")
    # ---- phase 3: each kernel against its plain version
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_p(n_rows, n_cols):
        return torch.randint(0, 5, (n_rows, n_cols), generator=gen, device=dev,
                             dtype=torch.float32)

    def rand_band(n, base, w, h):
        """Random band matrix in a layout: zero outside |row - col| <= h."""
        col = torch.from_numpy(base.astype(np.int64)).to(dev)[:, None] + \
            torch.arange(w, device=dev)[None, :]
        row = torch.arange(n, device=dev)[:, None]
        return rand_p(n, w) * (((col - row).abs() <= h) & (col < n))

    rg_rows, rg_cols, rg_vals, rg_n = random_graph(300, 900, seed=1)
    small = [
        ("torus 12^3", build_torus_host((12, 12, 12)), (12, 12, 12)),
        ("torus 5x5x3 (n=75)", build_torus_host((5, 5, 3)), (5, 5, 3)),
        ("random_graph(300, 900), non-symmetric",
         HostCSR.from_coo(rg_rows, rg_cols, rg_vals, rg_n), None),
    ]
    def three_limb_p(h, n_cols):
        """P spanning all three u8 limbs: values up to (2^24 - 1) / A's
        largest row sum, so every C = A x P stays below 2^24."""
        row_sum = np.bincount(h.rows(), weights=h.vals.astype(np.float64)).max()
        top = (2**24 - 1) // int(row_sum)
        p = torch.randint(0, top + 1, (h.n_cols, n_cols), generator=gen, device=dev,
                          dtype=torch.float32)
        check(float(p.max()) >= 2**16, "the three-limb P does not reach the top limb")
        return p

    def group_dot_case(label, gop, p):
        """The kernel against both plain versions (f32 and u8 limbs): exact."""
        got = groupdot.spmm_group_dot(gop, p)
        return max(compare(f"spmm_group_dot {label}", got,
                           groupdot.spmm_group_dot_reference(gop, p)),
                   compare(f"spmm_group_dot {label} (limb plain version)", got,
                           groupdot.spmm_group_dot_limbs_reference(gop, p)))

    err = {name: 0.0 for name in counters}
    for name, h, _ in small:
        op = spmm.prepare_sparse_operand(h, dev)
        p = rand_p(h.n_cols, h.n_cols)
        p3 = three_limb_p(h, h.n_cols)
        err["spmm_dense_acc"] = max(err["spmm_dense_acc"], compare(
            f"spmm_dense_acc, {name}", spmm.spmm_dense_acc(op, p),
            spmm.spmm_dense_acc_reference(op, p)))
        for r, g in ((40, 32), (8, 4)):
            gop = groupdot.prepare_group_operand(h, dev, rows_per_tile=r, g=g)
            for label, pp in (("P < 5", p), ("three-limb P", p3)):
                err["spmm_group_dot"] = max(err["spmm_group_dot"], group_dot_case(
                    f"R={r} G={g} {label}, {name}", gop, pp))
        print(f"[3] {name}: n={h.n_rows} nnz={h.nnz}: spmm_dense_acc == plain (exact); "
              f"spmm_group_dot (R, G) = (40, 32), (8, 4) == both plain versions (f32, u8 "
              f"limbs; exact) on P < 5 and on a three-limb P", flush=True)

    # group-dot's P domain: a value outside [0, 2^24) or not an integer
    # turns the output tile of the warp that staged it (R rows x 16
    # columns) into NaN; every entry outside those columns is unchanged
    h = small[0][1]
    gop = groupdot.prepare_group_operand(h, dev, rows_per_tile=40, g=32)
    w = groupdot.POISON_COLS
    for bad in (2.0**24, -1.0, 0.5, float("nan"), float("inf")):
        p = rand_p(h.n_cols, 300)
        want = groupdot.spmm_group_dot_reference(gop, p)
        p[int(h.col_idx[0]), 37] = bad  # a P row that row 0's first entry reads
        got = groupdot.spmm_group_dot(gop, p)
        torch.cuda.synchronize()
        j0 = 37 // w * w
        check(bool(got[:40, j0:j0 + w].isnan().all()),
              f"spmm_group_dot: P value {bad} did not poison its tile")
        outside = torch.ones(300, dtype=torch.bool, device=dev)
        outside[j0:j0 + w] = False
        compare(f"spmm_group_dot outside the tile poisoned by {bad}", got[:, outside],
                want[:, outside])
    print(f"[3] spmm_group_dot: a P value of 2^24, -1, 0.5, NaN or inf poisons its (40 x {w}) "
          f"output tile with NaN; the rest == plain (exact)", flush=True)

    for name, h, dims in small[:2]:
        a_f, h_a = fold(h, bandplanes.fold_perm(dims))
        op = spmm.prepare_sparse_operand(a_f, dev)
        n = h.n_rows
        # the GPU quantum, an unaligned one (the scalar path), JAX's 1024
        for q in (bandplanes.QUANTUM, 1, 1024):
            total = -(-n // q) * q
            for k in (1, 3):
                b_in, w_in = bandplanes.band_layout(n, k * h_a, total, q)
                b_out, w_out = bandplanes.band_layout(n, (k + 1) * h_a, total, q)
                bop = bandplanes.prepare_band_operand(op, b_in, w_in, b_out, w_out,
                                                      k * h_a)
                p = rand_band(n, b_in, w_in, k * h_a)
                err["spmm_band"] = max(err["spmm_band"], compare(
                    f"spmm_band q={q} k={k}, {name}", bandplanes.spmm_band(bop, p),
                    bandplanes.spmm_band_reference(bop, p)))
        print(f"[3] {name} folded (h={h_a}): spmm_band == plain (exact) at "
              f"quanta {bandplanes.QUANTUM}, 1, 1024, steps A^2 and A^4", flush=True)

    h30 = build_torus_host(DIMS30)
    n30 = h30.n_rows
    timing = {}

    # dense-acc on the 30^3 operand x a random P, rows 0..SLICE_ROWS
    op = spmm.prepare_sparse_operand(h30, dev)
    op_slice = spmm.row_slice(op, 0, SLICE_ROWS)
    p = rand_p(n30, n30)
    full = spmm.spmm_dense_acc(op, p)
    sliced = spmm.spmm_dense_acc(op_slice, p)
    want = spmm.spmm_dense_acc_reference(op_slice, p)
    err["spmm_dense_acc"] = max(err["spmm_dense_acc"],
                                compare("spmm_dense_acc 30^3 rows", full[:SLICE_ROWS], want),
                                compare("spmm_dense_acc 30^3 slice", sliced, want))
    # the library yardstick: cuSPARSE SpMM through torch.sparse.mm on CSR
    lib_slice = torch.sparse_csr_tensor(op_slice.row_ptr, op_slice.col_idx, op_slice.vals,
                                        size=(SLICE_ROWS, n30))
    lib_full = torch.sparse_csr_tensor(op.row_ptr, op.col_idx, op.vals, size=(n30, n30))

    def spmm_bound(o, n_rows):
        """C = A x P's bound: A's arrays, each distinct P row once, C once,
        and one FMA per nonzero of A and column of P."""
        return bound(csr_spmm_bytes(o.row_ptr, o.col_idx, n_rows, n30, n30,
                                    o.vals.numel() * 4),
                     2.0 * o.col_idx.numel() * n30)

    # the launch span's bytes (distinct columns counted on the host) are the bound's
    check(spmm.launch_bytes(op, n30) == csr_spmm_bytes(op.row_ptr, op.col_idx, n30, n30, n30,
                                                       op.vals.numel() * 4),
          "spmm_dense_acc: the launch span's bytes differ from the bound's")
    # dense-acc and group-dot compute the same function: one bound for both
    (b_ms, b_by), full_b_ms = spmm_bound(op_slice, SLICE_ROWS), spmm_bound(op, n30)[0]
    timing["spmm_dense_acc"] = dict(
        ms=time_ms(lambda: spmm.spmm_dense_acc(op_slice, p, out=sliced), 50),
        plain_ms=time_ms(lambda: spmm.spmm_dense_acc_reference(op_slice, p), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.mm(lib_slice, p), 20),
        full_step_ms=time_ms(lambda: spmm.spmm_dense_acc(op, p, out=full), 5),
        full_bound_ms=full_b_ms,
        full_library_ms=time_ms(lambda: torch.sparse.mm(lib_full, p), 5),
        panel_cols=int(lib.spmm_dense_acc_panel_cols(n30, n30)),
        full_gather_gb=spmm_sources.gather_bytes(op, n30) / 1e9,
        timed_on=f"30^3 operand rows 0..{SLICE_ROWS} x P ({n30}, {n30})")
    t = timing["spmm_dense_acc"]
    t["full_gather_tb_per_s"] = t["full_gather_gb"] / t["full_step_ms"]
    print(f"[3] spmm_dense_acc on the full 30^3 step: kernel {t['full_step_ms']:.4f} ms "
          f"(panels of {t['panel_cols']} columns), bound {full_b_ms:.4f} ms, torch.sparse.mm "
          f"{t['full_library_ms']:.4f} ms; gathers {t['full_gather_gb']:.2f} GB of P rows, "
          f"{t['full_gather_tb_per_s']:.2f} TB/s", flush=True)
    del full, sliced, want

    # group-dot at R = 40, G = 32 on the same P
    slice_csr = HostCSR(h30.row_ptr[:SLICE_ROWS + 1],
                        h30.col_idx[:h30.row_ptr[SLICE_ROWS]],
                        h30.vals[:h30.row_ptr[SLICE_ROWS]], SLICE_ROWS, n30, h30.sr_name)
    gop = groupdot.prepare_group_operand(h30, dev)
    gop_slice = groupdot.prepare_group_operand(slice_csr, dev)
    p3 = three_limb_p(h30, n30)
    for label, pp in (("P < 5", p), ("three-limb P", p3)):
        full = groupdot.spmm_group_dot(gop, pp)
        sliced = groupdot.spmm_group_dot(gop_slice, pp)
        err["spmm_group_dot"] = max(
            err["spmm_group_dot"], group_dot_case(f"30^3 slice, {label}", gop_slice, pp),
            compare(f"spmm_group_dot 30^3 rows, {label}", full[:SLICE_ROWS], sliced),
            compare(f"spmm_group_dot 30^3 full, {label} (against dense-acc)", full,
                    spmm.spmm_dense_acc(op, pp)))
    timing["spmm_group_dot"] = dict(
        ms=time_ms(lambda: groupdot.spmm_group_dot(gop_slice, p, out=sliced), 50),
        plain_ms=time_ms(lambda: groupdot.spmm_group_dot_reference(gop_slice, p), 5),
        limbs_plain_ms=time_ms(lambda: groupdot.spmm_group_dot_limbs_reference(gop_slice, p),
                               3),
        bound_ms=b_ms, bound_by=b_by,  # A's nonzeros, not the padded (R, G) blocks
        library_ms=time_ms(lambda: torch.sparse.mm(lib_slice, p), 20),
        full_step_ms=time_ms(lambda: groupdot.spmm_group_dot(gop, p, out=full), 5),
        full_bound_ms=full_b_ms,
        full_library_ms=time_ms(lambda: torch.sparse.mm(lib_full, p), 5),
        # P spanning all three limbs: every MMA of the step runs
        three_limb_ms=time_ms(lambda: groupdot.spmm_group_dot(gop_slice, p3, out=sliced), 50),
        three_limb_full_step_ms=time_ms(lambda: groupdot.spmm_group_dot(gop, p3, out=full), 5),
        timed_on=f"30^3 operand rows 0..{SLICE_ROWS} x P ({n30}, {n30}) < 5 (one u8 limb), "
                 f"R=40 G=32, {gop.n_groups} groups in the full operand; three_limb_*: P "
                 f"up to {int(p3.max())}")
    del full, sliced, p, p3, op, op_slice, gop, gop_slice, lib_slice, lib_full

    # band: the widest step of the 30^3 fold-band chain, A^6 -> A^7 layouts
    a_f, h_a = fold(h30, bandplanes.fold_perm(DIMS30))
    q = bandplanes.QUANTUM
    total = -(-n30 // q) * q
    b_in, w_in = bandplanes.band_layout(n30, 6 * h_a, total, q)
    b_out, w_out = bandplanes.band_layout(n30, 7 * h_a, total, q)
    op = spmm.prepare_sparse_operand(a_f, dev)
    bop = bandplanes.prepare_band_operand(op, b_in, w_in, b_out, w_out, 6 * h_a)
    bop_slice = bandplanes.prepare_band_operand(
        spmm.row_slice(op, 0, SLICE_ROWS), b_in, w_in, b_out[:SLICE_ROWS], w_out, 6 * h_a)
    p = rand_band(n30, b_in, w_in, 6 * h_a)
    full = bandplanes.spmm_band(bop, p)
    sliced = bandplanes.spmm_band(bop_slice, p)
    want = bandplanes.spmm_band_reference(bop_slice, p)
    err["spmm_band"] = max(err["spmm_band"],
                           compare("spmm_band 30^3 rows", full[:SLICE_ROWS], want),
                           compare("spmm_band 30^3 slice", sliced, want))
    def band_bytes(o):
        """A's arrays and bases, each distinct source window once, C's windows."""
        return csr_spmm_bytes(o.a.row_ptr, o.a.col_idx, o.a.n_rows, o.w_in, o.w_out,
                              o.a.vals.numel() * 4 + (o.base_in.numel()
                                                      + o.base_out.numel()) * 4)

    b_ms, b_by = bound(band_bytes(bop_slice))
    # the library yardstick computes the same C = A x P with P densified:
    # torch.sparse.mm of the folded CSR (rows 0..SLICE_ROWS, and all of it)
    p_dense = bandplanes.band_to_dense(p, b_in, n30).contiguous()
    op_slice = spmm.row_slice(op, 0, SLICE_ROWS)
    lib_slice = torch.sparse_csr_tensor(op_slice.row_ptr, op_slice.col_idx, op_slice.vals,
                                        size=(SLICE_ROWS, n30))
    lib_full = torch.sparse_csr_tensor(op.row_ptr, op.col_idx, op.vals, size=(n30, n30))
    check(torch.equal(bandplanes.band_to_dense(sliced, b_out[:SLICE_ROWS], n30),
                      torch.sparse.mm(lib_slice, p_dense)),
          "spmm_band slice != torch.sparse.mm of the folded CSR and the dense P")
    timing["spmm_band"] = dict(
        ms=time_ms(lambda: bandplanes.spmm_band(bop_slice, p, out=sliced), 50),
        plain_ms=time_ms(lambda: bandplanes.spmm_band_reference(bop_slice, p), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.mm(lib_slice, p_dense), 20),
        full_step_ms=time_ms(lambda: bandplanes.spmm_band(bop, p, out=full), 5),
        full_bound_ms=bound(band_bytes(bop))[0],
        full_library_ms=time_ms(lambda: torch.sparse.mm(lib_full, p_dense), 5),
        timed_on=f"folded 30^3 operand rows 0..{SLICE_ROWS}, A^6 -> A^7 layouts "
                 f"(w_in={w_in}, w_out={w_out}, h_a={h_a})")
    del full, sliced, want, p, op, bop, bop_slice, p_dense, op_slice, lib_slice, lib_full
    torch.cuda.empty_cache()
    for name, t in timing.items():
        lib_t = t.get("library_ms")
        print(f"[3] {name} on {t['timed_on']}: kernel == plain (exact); {SLICE_ROWS}-row "
              f"slice: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), library "
              f"{'none' if lib_t is None else f'{lib_t:.4f} ms'}; full operand kernel "
              f"{t['full_step_ms']:.4f} ms, bound {t['full_bound_ms']:.4f} ms, library "
              f"{t['full_library_ms']:.4f} ms", flush=True)
        if "three_limb_ms" in t:
            print(f"[3] {name} on a three-limb P: slice {t['three_limb_ms']:.4f} ms, full "
                  f"{t['three_limb_full_step_ms']:.4f} ms; limb plain version "
                  f"{t['limbs_plain_ms']:.4f} ms on the slice", flush=True)

    def sdd_case(name, q, k, qi, ki):
        """The kernel against both plain versions (the batched fp32 product,
        and the 3xTF32 split of its own arithmetic)."""
        got = blocksparse.sdd_block_scores(q, k, qi, ki)
        err["sdd_block_scores"] = max(err["sdd_block_scores"], *(
            compare_close(f"sdd_block_scores {name} ({label})", got, plain(q, k, qi, ki),
                          SDD_RTOL, SDD_ATOL)
            for label, plain in (("plain", blocksparse.sdd_block_scores_reference),
                                 ("3xTF32 plain", blocksparse.sdd_block_scores_3xtf32_reference))))

    # SDD block scores: small shapes (D of 8, 32, 64 with Q kept whole, 72
    # and 136 with Q staged by chunks; a pair list with repeats; a single
    # pair), then the full GPT-2 117M pair list
    for d in (8, 32, 64, 72, 136):
        q = torch.randn(384, d, generator=gen, device=dev)
        k = torch.randn(512, d, generator=gen, device=dev)
        for qi_l, ki_l in (([0, 1, 1, 2, 0, 1], [3, 0, 0, 1, 3, 2]), ([2], [1])):
            sdd_case(f"D={d} T={len(qi_l)}", q, k,
                     torch.tensor(qi_l, dtype=torch.int32, device=dev),
                     torch.tensor(ki_l, dtype=torch.int32, device=dev))
    print(f"[3] sdd_block_scores == both plain versions (rtol {SDD_RTOL}, atol {SDD_ATOL}) at "
          f"D = 8, 32, 64, 72, 136, pairs with repeats and a single pair", flush=True)
    shape1 = tipover.config_shape(tipover.GPT_CONFIGS[1])
    qf, kf, qi, ki, _ = blocksparse.attention_block_operands(
        random_sparse_tensor(shape1, 1.0, seed=0), random_sparse_tensor(shape1, 1.0, seed=1),
        device=dev)
    t_pairs = qi.numel()
    check(t_pairs == 1792, f"config 1 pair list has {t_pairs} pairs, not 1,792")
    sdd_case("config 1", qf, kf, qi, ki)
    k_ms = time_ms(lambda: blocksparse.sdd_block_scores(qf, kf, qi, ki), 50)
    p_ms = time_ms(lambda: blocksparse.sdd_block_scores_reference(qf, kf, qi, ki), 20)
    d = qf.shape[1]
    gflop = t_pairs * 128 * 128 * d * 2 / 1e9
    sdd_bytes = ((torch.unique(qi).numel() + torch.unique(ki).numel()) * 128 * d * 4
                 + t_pairs * 128 * 128 * 4 + 8 * t_pairs)
    # the kernel's products: 3 TF32 products an fp32 one, on the tensor
    # cores; the fp32 bound (the CUDA cores' rate) beside it
    b_ms, b_by = bound(sdd_bytes, 3 * gflop * 1e9, TF32_FLOPS_PER_S)
    mask = sdd_library_mask(qi, ki, qf.shape[0], kf.shape[0])
    kt = kf.t().contiguous()
    timing["sdd_block_scores"] = dict(
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.sampled_addmm(mask, qf, kt, beta=0.0), 10),
        fp32_bound_ms=bound(sdd_bytes, gflop * 1e9)[0],
        split_plain_ms=time_ms(
            lambda: blocksparse.sdd_block_scores_3xtf32_reference(qf, kf, qi, ki), 5),
        timed_on=f"GPT-2 117M (config 1) pair list, T={t_pairs}, D={d}, density 1.0")
    t = timing["sdd_block_scores"]
    print(f"[3] sdd_block_scores on the config-1 pair list (T={t_pairs}, "
          f"{gflop:.3f} GFLOP): kernel == both plain versions (rtol {SDD_RTOL}, atol "
          f"{SDD_ATOL}); kernel {k_ms:.4f} ms ({gflop / k_ms:.2f} TFLOP/s of the function), "
          f"plain {p_ms:.4f} ms, 3xTF32 plain {t['split_plain_ms']:.4f} ms, bound {b_ms:.4f} "
          f"ms ({b_by}, {sdd_bytes / 1e9:.4f} GB; 3 x {gflop:.3f} GFLOP of TF32 at "
          f"{TF32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; the fp32 bound {t['fp32_bound_ms']:.4f} "
          f"ms), sampled_addmm {t['library_ms']:.4f} ms", flush=True)
    del qf, kf, qi, ki, mask, kt
    torch.cuda.empty_cache()

    # sort-merge: every row length the kernel takes, each semiring
    def rand_slab(rows, L, sr_name):
        cols = torch.randint(0, max(L // 3, 2), (rows, L), generator=gen, device=dev,
                             dtype=torch.int32)
        sent = torch.rand((rows, L), generator=gen, device=dev) < 0.3
        cols[sent] = INT32_SENTINEL
        if sr_name == "f32":  # integer values: every order of the sums is exact
            return cols, (torch.randint(0, 50, (rows, L), generator=gen, device=dev,
                                        dtype=torch.float32) * ~sent,)
        return cols, tuple(torch.randint(0, 1 << 32, (rows, L), generator=gen, device=dev,
                                         dtype=torch.int64) * ~sent
                           for _ in range(2 if sr_name == "u64" else 1))

    def sm_case(name, cols, limbs, sr_name):
        """The kernel against both plain versions (the stable sort, and the
        packed keys of its own formulation): exact."""
        got = sortmerge.sortmerge_rows(cols, limbs, sr_name)
        err["sortmerge_rows"] = max(err["sortmerge_rows"], *(
            compare_slabs(f"sortmerge_rows {name} ({label})", got, plain(cols, limbs, sr_name))
            for label, plain in (("plain", sortmerge.sortmerge_rows_reference),
                                 ("packed-key plain", sortmerge.sortmerge_rows_keys_reference))))

    lengths = [1 << k for k in range(sortmerge.MAX_L.bit_length())]
    for sr_name in ("u64", "u32", "f32"):
        for L in lengths:
            for rows in (1, 37):
                sm_case(f"{sr_name} L={L} R={rows}", *rand_slab(rows, L, sr_name), sr_name)
        # columns past 2^28 and negative ones: the kernel's 64-bit keys (the
        # random slabs above fit its 32-bit ones)
        for L in (64, 4096, sortmerge.MAX_L):
            cols, limbs = rand_slab(5, L, sr_name)
            cols[:3] = torch.where(cols[:3] == INT32_SENTINEL, cols[:3], cols[:3] + (1 << 28))
            cols[3:] = torch.where(cols[3:] == INT32_SENTINEL, cols[3:], -1 - cols[3:])
            sm_case(f"{sr_name} L={L} wide and negative columns", cols, limbs, sr_name)
    for L in (128, sortmerge.MAX_L):
        full_col = torch.full((4, L), 7, dtype=torch.int32, device=dev)
        top = torch.full((4, L), 0xFFFFFFFF, dtype=torch.int64, device=dev)
        for sr_name, limbs in (("u64", (top, top)), ("u32", (top,))):
            got = sortmerge.sortmerge_rows(full_col, limbs, sr_name)
            check(bool((got[0][:, 0] == 7).all() and (got[1][0][:, 0] == 0xFFFFFFFF).all()),
                  f"sortmerge_rows {sr_name} L={L}: duplicates did not saturate")
            sm_case(f"{sr_name} L={L} saturation", full_col, limbs, sr_name)
        sent = torch.full((4, L), INT32_SENTINEL, dtype=torch.int32, device=dev)
        zero = torch.zeros((4, L), dtype=torch.int64, device=dev)
        sm_case(f"L={L} all sentinels", sent, (zero, zero), "u64")
        one = sent.clone()
        one[torch.arange(4, device=dev), torch.tensor([0, 5, L // 2, L - 1], device=dev)] = 9
        sm_case(f"L={L} one product a row", one, (zero + 3, zero), "u64")
    print(f"[3] sortmerge_rows == both plain versions (exact) at L = 1..{sortmerge.MAX_L}, "
          f"u64/u32/f32 (32-bit keys; 64-bit keys on wide and negative columns), and "
          f"saturating, all-sentinel and single-product rows", flush=True)

    # ... and on the real slab of the largest kernel-covered category of the
    # ER 27,000 x 32 product, built as numeric_cat builds it
    (_, er_n, _, er_coo), = spgemm_bench.make_cases(sides=(27000,), e_per_n=(32,),
                                                    power_law_sides=())
    a_er = spgemm_bench.case_operand(er_coo, dev)
    *slab, L, rp, nr = sortmerge_phases.largest_kernel_slab(a_er)
    sm_case(f"ER 27000x32 L={L} slab", *slab, "u64")
    # read once, written once: the data (an int32 column and uint32 limbs a
    # slot) sets the bound; the port's format carries each limb in an int64
    slab_bytes = 2 * slab[0].numel() * (4 + 4 * len(slab[1]))
    format_bytes = 2 * slab[0].numel() * (4 + 8 * len(slab[1]))
    b_ms, b_by = bound(slab_bytes)
    timing["sortmerge_rows"] = dict(
        ms=time_ms(lambda: sortmerge.sortmerge_rows(*slab, "u64"), 10),
        plain_ms=time_ms(lambda: sortmerge.sortmerge_rows_reference(*slab, "u64"), 3),
        keys_plain_ms=time_ms(lambda: sortmerge.sortmerge_rows_keys_reference(*slab, "u64"), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,  # torch.sort alone does not merge
        format_bound_ms=bound(format_bytes)[0],
        timed_on=f"ER 27,000 x 32 category L={L}: ({rp}, {L}) u64 slab, {nr} real rows")
    t = timing["sortmerge_rows"]
    print(f"[3] sortmerge_rows on {t['timed_on']}: kernel == both plain versions (exact); "
          f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, packed-key plain "
          f"{t['keys_plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{slab_bytes / 1e9:.3f} GB of data; the int64-limb format's "
          f"{format_bytes / 1e9:.3f} GB take {t['format_bound_ms']:.4f} ms), library none",
          flush=True)
    del slab

    # dense-acc at the general-SpGEMM sweep's shapes: an operand
    # (plan_dense_acc) times its densified self, as dense_acc_numeric runs
    # it; rows [lo, hi) against the plain version
    def sweep_dense_acc(label, op, p, lo, hi):
        n = op.n_rows
        part = spmm.row_slice(op, lo, hi)
        full = spmm.spmm_dense_acc(op, p)
        sliced = spmm.spmm_dense_acc(part, p)
        want = spmm.spmm_dense_acc_reference(part, p)
        err["spmm_dense_acc"] = max(
            err["spmm_dense_acc"], compare(f"spmm_dense_acc {label} rows", full[lo:hi], want),
            compare(f"spmm_dense_acc {label} slice", sliced, want))
        lib_slice = torch.sparse_csr_tensor(part.row_ptr, part.col_idx, part.vals,
                                            size=(hi - lo, n))
        lib_full = torch.sparse_csr_tensor(op.row_ptr, op.col_idx, op.vals, size=(n, n))

        def own_bound(o, n_rows):
            return bound(csr_spmm_bytes(o.row_ptr, o.col_idx, n_rows, n, n,
                                        o.vals.numel() * 4), 2.0 * o.col_idx.numel() * n)

        b_ms, b_by = own_bound(part, hi - lo)
        t = dict(ms=time_ms(lambda: spmm.spmm_dense_acc(part, p, out=sliced), 20),
                 plain_ms=time_ms(lambda: spmm.spmm_dense_acc_reference(part, p), 3),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=time_ms(lambda: torch.sparse.mm(lib_slice, p), 10),
                 full_step_ms=time_ms(lambda: spmm.spmm_dense_acc(op, p, out=full), 3),
                 full_bound_ms=own_bound(op, n)[0],
                 full_library_ms=time_ms(lambda: torch.sparse.mm(lib_full, p), 3),
                 panel_cols=int(lib.spmm_dense_acc_panel_cols(n, n)),
                 full_gather_gb=spmm_sources.gather_bytes(op, n) / 1e9,
                 timed_on=f"{label} operand ({op.col_idx.numel()} entries) rows {lo}..{hi} "
                          f"x its dense self ({n}, {n})")
        t["full_gather_tb_per_s"] = t["full_gather_gb"] / t["full_step_ms"]
        t["full_library_gather_tb_per_s"] = t["full_gather_gb"] / t["full_library_ms"]
        print(f"[3] spmm_dense_acc on {t['timed_on']}: kernel == plain (exact); slice: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"library {t['library_ms']:.4f} ms; full operand kernel {t['full_step_ms']:.4f} "
              f"ms (panels of {t['panel_cols']} columns), bound {t['full_bound_ms']:.4f} ms, "
              f"library {t['full_library_ms']:.4f} ms; gathers {t['full_gather_gb']:.2f} GB "
              f"of P rows: kernel {t['full_gather_tb_per_s']:.2f} TB/s, library "
              f"{t['full_library_gather_tb_per_s']:.2f} TB/s", flush=True)
        return t

    op, p = denseacc.plan_dense_acc(a_er), tuple_to_f32_dense(a_er)
    er_t = sweep_dense_acc("ER 27,000 x 32", op, p, 0, SLICE_ROWS)
    l2 = spmm_sources.l2_gather_rate(p)
    print(f"[3] L2 re-read rate (a reference for the gather floor, not a bound), random rows "
          f"of a {l2['panel_bytes'] / 1e6:.1f} MB panel of P: " + "; ".join(
              f"{name} {r['gathered_bytes'] / 1e6:.1f} MB in {r['ms']:.4f} ms, "
              f"{r['tb_per_s']:.2f} TB/s" for name, r in l2.items() if name != "panel_bytes"),
          flush=True)
    del op, p
    torch.cuda.empty_cache()
    sweep_t = {}
    for key, label, case, epn in (("pl", "power-law 27,000", "powerlaw", 8),
                                  ("er2", "ER 27,000 x 2", "er", 2)):
        op, p = spmm_sources.sweep_operand(case, er_n, epn, dev)
        # the slice holds the longest row (a hub of the power-law graph)
        top = int(torch.diff(op.row_ptr).argmax())
        lo = max(0, min(top - SLICE_ROWS // 2, op.n_rows - SLICE_ROWS))
        sweep_t[key] = sweep_dense_acc(label, op, p, lo, lo + SLICE_ROWS)
        del op, p
        torch.cuda.empty_cache()
    timing["spmm_dense_acc"].update({f"er_{k}": v for k, v in er_t.items()})
    for key, t in sweep_t.items():
        timing["spmm_dense_acc"].update({f"{key}_{k}": v for k, v in t.items()})
    timing["spmm_dense_acc"]["l2_gather"] = l2

    # coalesce: every stream type, K = 1..4, empty and full blocks, one
    # block, L = 1..2^20, out_cap above and below the total
    co_types = (torch.int32, torch.int64, torch.float32)

    def rand_stream(nb, L, dtype):
        if dtype == torch.float32:
            return torch.randn((nb, L), generator=gen, device=dev)
        top = 1 << 31 if dtype == torch.int32 else 1 << 32
        return torch.randint(0, top, (nb, L), generator=gen, device=dev, dtype=dtype)

    def co_case(name, offs, streams, out_cap, fills):
        got = coalesce.coalesce_blocks(offs, streams, out_cap, fills)
        want = coalesce.coalesce_blocks_reference(offs, streams, out_cap, fills)
        err["coalesce_blocks"] = max(err["coalesce_blocks"], *(
            compare(f"coalesce_blocks {name}, output {i}", g, w)
            for i, (g, w) in enumerate(zip(got, want))))

    n_co = 0
    for L in (1, 2, 3, 37, 1024, 1025, 4096, slab_ops.MAX_L):
        for nb in ((1, 3) if L == slab_ops.MAX_L else (1, 7)):
            sb = torch.randint(0, L + 1, (nb,), generator=gen, device=dev)
            sb[-1] = L  # a full block (the only one when nb = 1)
            if nb > 1:
                sb[0] = 0  # and an empty one
            offs = torch.cat([sb.new_zeros(1), torch.cumsum(sb, dim=0)]).int()
            total = int(offs[-1])
            for k in range(1, coalesce.MAX_STREAMS + 1):
                streams = [rand_stream(nb, L, co_types[(k + q) % 3]) for q in range(k)]
                for out_cap in (total + 5, max(total - 3, 1)):
                    co_case(f"L={L} nb={nb} K={k} out_cap={out_cap}", offs, streams, out_cap,
                            [q - 1 for q in range(k)])
                    n_co += 1
    print(f"[3] coalesce_blocks == plain (exact) in {n_co} cases: L = 1..{slab_ops.MAX_L}, "
          f"nb = 1, 3, 7, K = 1..{coalesce.MAX_STREAMS} of int32/int64/f32, empty and "
          f"full blocks, out_cap above and below the total", flush=True)

    # the kernel's mapping (4 positions a thread, a block search a warp's
    # 128): blocks of 0-3 survivors, so that several block boundaries fall
    # inside one 4-position vector, out_cap not a multiple of 4 above and
    # below the total, and the streams as contiguous views 1 and 3 elements
    # into a buffer (loads at any alignment)
    def odd_view(st, off):
        buf = st.new_empty(st.numel() + off)
        buf[off:] = st.reshape(-1)
        return buf[off:].view(st.shape)

    n_co = 0
    for L in (3, 4, 5, 37):
        sb = torch.randint(0, 4, (300,), generator=gen, device=dev)
        offs = torch.cat([sb.new_zeros(1), torch.cumsum(sb, dim=0)]).int()
        total = int(offs[-1])
        for k in (1, coalesce.MAX_STREAMS):
            streams = [rand_stream(300, L, co_types[(k + q) % 3]) for q in range(k)]
            for off in (0, 1, 3):
                views = [odd_view(st, off) for st in streams] if off else streams
                for out_cap in (total + 1, total + 2, total + 7, total - 1, total - 6):
                    co_case(f"blocks of 0-3, L={L} K={k} view offset {off} out_cap={out_cap}",
                            offs, views, out_cap, [q - 1 for q in range(k)])
                    n_co += 1
    print(f"[3] coalesce_blocks == plain (exact) in {n_co} more cases: 300 blocks of 0-3 "
          f"survivors (block boundaries inside a 4-position vector), L = 3, 4, 5, 37, K = 1 "
          f"and {coalesce.MAX_STREAMS}, streams at element offsets 0, 1 and 3 of a buffer, "
          f"out_cap = total + 1, + 2, + 7, - 1, - 6", flush=True)

    # ... and on the real survivor streams of the mixed chain's A^4 slab
    # (A^3 x A of the 30^3 torus) and of the ER 27,000 x 32 slab
    a30 = sparse_operand(h30, dev)
    co_real = {}
    for label, (offs, streams, out_cap, fills) in coalesce_sources.real_inputs(
            a30, a_er).items():
        co_case(label, offs, streams, out_cap, fills)
        nb, L = streams[0].shape
        total = int(offs[-1])
        # the data carries 4 B a stream (int32 row and column, uint32 limbs),
        # the port's format each limb in an int64
        nbytes, format_bytes = coalesce_sources.byte_counts(offs, streams, out_cap)
        b_ms, b_by = bound(nbytes)
        mask = torch.arange(L, device=dev)[None, :] < torch.diff(offs.long())[:, None]
        bids = torch.arange(nb, dtype=torch.int32, device=dev)[:, None].expand(nb, L)
        co_real[label] = dict(
            ms=time_ms(lambda: coalesce.coalesce_blocks(offs, streams, out_cap, fills), 20),
            plain_ms=time_ms(lambda: coalesce.coalesce_blocks_reference(
                offs, streams, out_cap, fills), 5),
            bound_ms=b_ms, bound_by=b_by, format_bound_ms=bound(format_bytes)[0],
            # one masked_select a stream, the block ids included
            library_ms=time_ms(lambda: [torch.masked_select(st, mask)
                                        for st in (*streams, bids)], 5),
            timed_on=f"{label}: nb={nb} L={L}, K={len(streams)} streams "
                     f"({', '.join(str(st.dtype)[6:] for st in streams)}), {total} survivors, "
                     f"out_cap {out_cap}")
        t = co_real[label]
        print(f"[3] coalesce_blocks on {t['timed_on']}: kernel == plain (exact); kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{nbytes / 1e9:.4f} GB of data; the int64-limb format's "
              f"{format_bytes / 1e9:.4f} GB take {t['format_bound_ms']:.4f} ms), "
              f"masked_select {t['library_ms']:.4f} ms", flush=True)
        del offs, streams, mask, bids
    er_t = co_real.pop("ER 27,000 x 32 slab")
    (_, main_t), = co_real.items()
    timing["coalesce_blocks"] = dict(main_t, **{f"er_{key}": v for key, v in er_t.items()})
    torch.cuda.empty_cache()
    esc_row = esc_kernel_row(dev, h30)
    torch.cuda.empty_cache()
    panel_row = panel_pack_row(dev)

    since_start("phase 4 (the chains)")
    # ---- phase 4: the port's paths at full scale
    t0 = time.perf_counter()
    oracle30 = []  # the oracle's A^2..A^7, shared by the CSR chains' checks
    stats, final = native_chain_stats_host(h30.row_ptr, h30.col_idx, h30.vals,
                                           n30, STEPS, keep=oracle30)
    print(f"[4] oracle chain A^2..A^{STEPS}: {time.perf_counter() - t0:.1f}s", flush=True)
    check([tuple(s[:3]) for s in stats] == EXPECTED,
          f"oracle stats {[s[:3] for s in stats]} != published {EXPECTED}")
    strategy = choose_strategy(h30, steps=STEPS - 1)
    print(f"[4] choose_strategy -> {strategy}", flush=True)
    check(strategy == "dense-acc", f"route is {strategy!r}, not 'dense-acc'")

    # one pass of a path: one untimed call of each of its steps (a chain's
    # steps once, one product a density or a graph), profiled apart from the
    # timed runs, whose warm-ups and repetitions path_ms sums
    pass_stats = {name: [0, 0.0] for name in counters}

    def one_pass(kernel, fn):
        reset_counts()
        _, ms = profiled(fn, counters)
        pass_stats[kernel][0] += counters[kernel].LAUNCHES
        pass_stats[kernel][1] += ms[kernel]

    paths = [
        ("dense-acc", "spmm_dense_acc",
         lambda it: run_chain_dense_acc(h30, dev, max_step=STEPS, iters=it, native_stats=stats)),
        ("foldband", "spmm_band",
         lambda it: run_chain_foldband(h30, dev, DIMS30, max_step=STEPS, iters=it,
                                       native_stats=stats)),
        ("group-dot", "spmm_group_dot",
         lambda it: run_chain_dense_acc(h30, dev, max_step=STEPS, iters=it, native_stats=stats,
                                        kernel="group-dot")),
    ]
    # each path runs under torch.profiler: path_ms[path][kernel] is the
    # kernel's device time summed over the path
    launches, chain_ms, path_ms = {}, {}, {}
    for path, kernel, run in paths:
        one_pass(kernel, lambda: run(1))
        reset_counts()
        out, path_ms[path] = profiled(lambda: run(3), counters)
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        results = out[0]
        got = [(r.step, r.nnz, int(r.max_value)) for r in results]
        check(got == EXPECTED, f"{path} chain (step, nnz, max) {got} != {EXPECTED}")
        p_final = unfold_band(*out[1:]) if path == "foldband" else out[1]
        verify_final_values(p_final, final, sample_rows=128)
        del out, p_final
        torch.cuda.empty_cache()
        check(counts[kernel] >= STEPS - 1,
              f"{path} chain made {counts[kernel]} {kernel} launches")
        launches[kernel] = counts[kernel]
        chain_ms[kernel] = sum(r.seconds for r in results) * 1e3
        print(f"[4] {path}: per-step (nnz, max) == oracle == published table; final "
              f"values == oracle on 128 leading rows"
              f"{' (un-permuted)' if path == 'foldband' else ''}; launches {counts}",
              flush=True)
        for r in results:
            print(f"[4] {path} A^{r.step} step: {r.seconds * 1e3:.4f} ms  "
                  f"({r.gb_per_s:.1f} GB/s of the byte model)", flush=True)
        print(f"[4] {path} chain total A^2..A^{STEPS}: {chain_ms[kernel]:.4f} ms; "
              f"A^{STEPS} nnz/s: {results[-1].nnz_per_s:.1f}", flush=True)

    since_start("the rowcat chain")
    # the router's "esc" route: the 30^3 torus at --steps 4 rides the rowcat
    # chain, as bench.py maps it; every step's whole CSR against the oracle
    steps_esc = 4
    strategy = choose_strategy(h30, steps=steps_esc - 1)
    check(strategy == "esc", f"route at --steps {steps_esc} is {strategy!r}, not 'esc'")
    reset_counts()
    (rc_results, _), path_ms["rowcat"] = profiled(
        lambda: run_chain_rowcat(h30, dev, max_step=steps_esc, iters=3,
                                 native_stats=stats[:steps_esc - 1], verbose=False,
                                 oracle=oracle30), counters)
    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    got = [(r.step, r.nnz, int(r.max_value)) for r in rc_results]
    check(got == EXPECTED[:steps_esc - 1], f"rowcat chain (step, nnz, max) {got}")
    check(counts["sortmerge_rows"] >= 1, "the rowcat chain made no sortmerge_rows launch")
    rowcat_ms = {str(r.step): r.seconds * 1e3 for r in rc_results}
    print(f"[4] choose_strategy(--steps {steps_esc}) -> esc: the rowcat chain A^2..A^"
          f"{steps_esc} == the oracle's whole CSR at every step; whole calls, host plan "
          f"included: {', '.join(f'A^{k} {v:.4f} ms' for k, v in rowcat_ms.items())}; "
          f"total {sum(rowcat_ms.values()):.4f} ms; launches {counts}", flush=True)

    since_start("the attention path")
    # the attention-scores path at GPT-2 117M, one density at a time
    att_rows, sdd_launches = {}, 0
    path_ms["attention"] = dict.fromkeys(counters, 0.0)
    for density in ATT_DENSITIES:
        qf, kf, qi, ki, _ = blocksparse.attention_block_operands(
            random_sparse_tensor(shape1, density, seed=0),
            random_sparse_tensor(shape1, density, seed=1), device=dev)
        one_pass("sdd_block_scores", lambda: blocksparse.sdd_block_scores(qf, kf, qi, ki))
        del qf, kf, qi, ki
        reset_counts()
        csv, ms = profiled(lambda: tipover.sweep_config(
            tipover.GPT_CONFIGS[1], iters=3, densities=[density], device=dev, verbose=False),
            counters)
        path_ms["attention"] = {k: v + ms[k] for k, v in path_ms["attention"].items()}
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        lines = csv.strip().split("\n")
        rows = {r.split(",")[0]: r.split(",") for r in lines[2:]}
        check("sdd" in rows, f"no SDD row at density {density}")
        check(("esc" in rows) == (density < 1.0),
              f"ESC row {'missing' if density < 1.0 else 'present'} at density {density}")
        check(counts["sdd_block_scores"] >= 1,
              f"attention path at density {density} made no sdd_block_scores launch")
        sdd_launches += counts["sdd_block_scores"]
        att_rows[density] = (lines[0], rows)
        esc = (f"ESC {rows['esc'][8]} us (nnz {rows['esc'][4]})" if "esc" in rows
               else "ESC skipped (JAX's budget)")
        print(f"[4] attention config 1, density {density}: {lines[0].split(' blas')[0]}; "
              f"{esc}; SDD {rows['sdd'][8]} us (T={rows['sdd'][4]}); every product == dense "
              f"scores (rtol 1e-4, atol 1e-5); launches {counts}", flush=True)
    launches["sdd_block_scores"] = sdd_launches

    since_start("the general-SpGEMM sweep")
    # the general-SpGEMM sweep, one graph at a time, JAX's eight algorithms;
    # then spgemm_auto on the same graph
    sweep, sm_launches, da_launches, auto = {}, 0, 0, {}
    path_ms["spgemm sweep"] = dict.fromkeys(counters, 0.0)
    for (case, n, epn), nnz_c in SPGEMM_CASES.items():
        (*_, coo), = spgemm_bench.make_cases(
            sides=(n,) if case == "er" else (), e_per_n=(epn,),
            power_law_sides=(n,) if case == "powerlaw" else ())
        a_x = spgemm_bench.case_operand(coo, dev)
        one_pass("sortmerge_rows", spgemm_bench.algo_call(a_x, "rowcat_pallas"))
        reset_counts()
        csv, ms = profiled(lambda: spgemm_bench.run(
            sides=(n,) if case == "er" else (), e_per_n=(epn,),
            power_law_sides=(n,) if case == "powerlaw" else (),
            algos=SPGEMM_ALGOS, device=dev), counters)
        path_ms["spgemm sweep"] = {k: v + ms[k] for k, v in path_ms["spgemm sweep"].items()}
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        rows = [line.split(",") for line in csv.strip().split("\n")[1:]]
        dnf = {(case, n, epn, r[6]) for r in rows if r[7].startswith("DNF")}
        check([r[6] for r in rows] == list(SPGEMM_ALGOS) and dnf <= DNF_ALLOWED,
              f"spgemm sweep {case} {n}x{epn}: rows {rows}")
        check({k for k in DNF_ALLOWED if k[:3] == (case, n, epn)} <= dnf,
              f"spgemm sweep {case} {n}x{epn}: densedense ran where JAX's rule gives DNF")
        check(int(rows[0][5]) == nnz_c,
              f"spgemm sweep {case} {n}x{epn}: nnz(C) {rows[0][5]} != {nnz_c}")
        check(counts["sortmerge_rows"] >= 1,
              f"spgemm sweep {case} {n}x{epn} made no sortmerge_rows launch")
        check(counts["spmm_dense_acc"] >= 1,
              f"spgemm sweep {case} {n}x{epn} made no spmm_dense_acc launch (denseacc row)")
        sm_launches += counts["sortmerge_rows"]
        da_launches += counts["spmm_dense_acc"]
        key = f"{case},{n},{epn}"
        sweep[key] = {r[6]: float(r[7]) if not r[7].startswith("DNF") else r[7] for r in rows}
        print(f"[4] spgemm sweep {case} {n}x{epn}: flops {rows[0][4]}, nnz(C) "
              f"{nnz_c} (published); every algorithm == oracle CSR"
              f"{', densedense DNF (JAX rule)' if dnf else ''}; launches {counts}", flush=True)

        # spgemm_auto on the same A^2: its route (dense-dense tiers tried
        # first, then the route) and its product against the oracle
        host = native.as_host_csr(*a_x.to_numpy())
        want = native.spgemm(host, host, n)
        flops = symbolic_flops_exact(a_x, a_x)
        tiers, route = auto_route(a_x, a_x, flops)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = spgemm_auto(a_x, a_x)
        torch.cuda.synchronize()
        t_auto = (time.perf_counter() - t0) * 1e3
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        spgemm_bench.check_against_oracle(c, want, f"spgemm_auto {key}")
        del c
        auto[key] = dict(densedense_tiers=["wide" if w else "f32" for w in tiers],
                         route=route, call_ms=t_auto,
                         spmm_dense_acc_launches=counts["spmm_dense_acc"])
        print(f"[4] spgemm_auto {case} {n}x{epn}: dense-dense tiers tried first "
              f"{auto[key]['densedense_tiers']} (the first that does not poison answers), "
              f"else route {route}; == oracle's whole CSR; one call {t_auto:.4f} ms (the "
              f"first, host plan included); launches {counts}", flush=True)
        if key == "er,27000,32":
            # the panel sweep at full width: dense_acc_panel_cols(27000)
            # panels, each run by the dense-accumulator kernel in both sweeps
            w = dense_acc_panel_cols(n)
            n_panels = -(-n // w)
            check((w, n_panels) == (8192, 4), f"denseacc_tiled panels {w} x {n_panels}")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = spgemm_auto(a_x, a_x, kernel="denseacc_tiled")
            torch.cuda.synchronize()
            t_tiled = (time.perf_counter() - t0) * 1e3
            n_launch = counters["spmm_dense_acc"].LAUNCHES
            spgemm_bench.check_against_oracle(c, want, f"spgemm_auto denseacc_tiled {key}")
            check(n_launch == 2 * n_panels,
                  f"denseacc_tiled made {n_launch} spmm_dense_acc launches, not {2 * n_panels}")
            check(panelpack.LAUNCHES == 2 * n_panels,
                  f"denseacc_tiled made {panelpack.LAUNCHES} panel launches, not "
                  f"{2 * n_panels}")
            auto["denseacc_tiled er,27000,32"] = dict(panels=n_panels, panel_cols=w,
                                                      call_ms=t_tiled,
                                                      spmm_dense_acc_launches=n_launch,
                                                      panel_launches=panelpack.LAUNCHES)
            print(f"[4] spgemm_auto(kernel='denseacc_tiled') ER 27000x32: {n_panels} panels of "
                  f"{w}; == oracle's whole CSR; one call {t_tiled:.4f} ms; spmm_dense_acc "
                  f"launches {n_launch}, panel_count and panel_pack launches "
                  f"{panelpack.LAUNCHES}", flush=True)
            del c
        del a_x, host, want
        torch.cuda.empty_cache()
    launches["sortmerge_rows"] = sm_launches

    since_start("the mixed chain, slab and colchunk")
    # the mixed chain: slab ESC A^2..A^4, densify, dense-acc A^5..A^7
    one_pass("coalesce_blocks", lambda: run_chain_mixed(
        h30, dev, max_step=STEPS, switch_step=5, iters=1, native_stats=stats))
    reset_counts()
    (results, p_final, t_dens), path_ms["mixed"] = profiled(
        lambda: run_chain_mixed(h30, dev, max_step=STEPS, switch_step=5, iters=3,
                                native_stats=stats), counters)
    counts = {name: mod.LAUNCHES for name, mod in counters.items()}
    got = [(r.step, r.nnz, int(r.max_value)) for r in results]
    check(got == EXPECTED, f"mixed chain (step, nnz, max) {got} != {EXPECTED}")
    verify_final_values(p_final, final, sample_rows=128)
    del p_final
    torch.cuda.empty_cache()
    check(counts["coalesce_blocks"] >= 3, f"mixed chain made {counts['coalesce_blocks']} "
          "coalesce_blocks launches over its 3 slab steps")
    check(counts["spmm_dense_acc"] >= 3, f"mixed chain made {counts['spmm_dense_acc']} "
          "spmm_dense_acc launches over its 3 late steps")
    launches["coalesce_blocks"] = counts["coalesce_blocks"]
    mixed_ms = sum(r.seconds for r in results) * 1e3 + t_dens * 1e3
    print(f"[4] mixed: per-step (nnz, max) == oracle == published table; A^2..A^4 == the "
          f"oracle's whole CSR; final values == oracle on 128 leading rows; launches {counts}",
          flush=True)
    for r in results:
        print(f"[4] mixed A^{r.step} step [{'slab' if r.step < 5 else 'dense-acc'}]: "
              f"{r.seconds * 1e3:.4f} ms", flush=True)
    print(f"[4] mixed densify A^4: {t_dens * 1e3:.4f} ms; chain total A^2..A^{STEPS} incl. "
          f"densify: {mixed_ms:.4f} ms [reference CSR-par total ~102 ms]", flush=True)

    # slab ESC on ER 27,000 x 32 and power-law 27,000, colchunk on ER (K = 3)
    (_, pl_n, _, pl_coo), = spgemm_bench.make_cases(sides=(), power_law_sides=(27000,))
    slab_paths = {}
    for label, coo, n_x in (("ER 27,000 x 32", er_coo, er_n),
                            ("power-law 27,000", pl_coo, pl_n)):
        a_x = spgemm_bench.case_operand(coo, dev)
        host = native.as_host_csr(*a_x.to_numpy())
        want = native.spgemm(host, host, n_x)
        plan = slab_ops.slab_config(a_x, a_x)
        reset_counts()
        t0 = time.perf_counter()
        c = slab_ops.spgemm_slab(a_x, a_x).check()
        torch.cuda.synchronize()
        t_call = (time.perf_counter() - t0) * 1e3
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        spgemm_bench.check_against_oracle(c, want, f"spgemm_slab {label}")
        check(counts["coalesce_blocks"] >= 1, f"spgemm_slab {label} made no coalesce launch")
        del c
        numeric_ms = time_ms(lambda: slab_ops.slab_numeric(a_x, a_x, plan), 3)
        wide = len(plan.packs) == 2
        slab_paths[f"slab {label}"] = dict(call_ms=t_call, numeric_ms=numeric_ms,
                                           wide_rows=wide)
        print(f"[4] spgemm_slab {label}: nnz(C) {len(want[1])} == oracle's whole CSR; call "
              f"(plan included) {t_call:.4f} ms, numeric {numeric_ms:.4f} ms; hub rows at a "
              f"second lane width with merge_disjoint_rows: "
              f"{'yes, L2 = ' + str(plan.packs[1][2]) if wide else 'no'}; launches {counts}",
              flush=True)
        if label.startswith("ER"):
            bnd, _ = colchunk.plan_chunks(a_x, a_x, 1 << 24)
            check(len(bnd) - 1 == 3, f"colchunk plan has {len(bnd) - 1} chunks, not 3")
            reset_counts()
            t0 = time.perf_counter()
            c = colchunk.spgemm_colchunk(a_x, a_x, slot_budget=1 << 24).check()
            torch.cuda.synchronize()
            t_call = (time.perf_counter() - t0) * 1e3
            counts = {name: mod.LAUNCHES for name, mod in counters.items()}
            spgemm_bench.check_against_oracle(c, want, f"spgemm_colchunk {label}")
            check(counts["coalesce_blocks"] >= 3,
                  f"spgemm_colchunk {label} made {counts['coalesce_blocks']} coalesce launches")
            del c
            slab_paths[f"colchunk {label}"] = dict(call_ms=t_call, chunks=3)
            print(f"[4] spgemm_colchunk {label}, slot budget 2^24 (K = 3 chunks): == oracle's "
                  f"whole CSR; call (plan included) {t_call:.4f} ms; launches {counts}",
                  flush=True)
        del a_x, host, want, plan
        torch.cuda.empty_cache()
    del a_er

    since_start("the chain's other forms")
    # the chain's other forms (bench.py --algo esc, escb, dense, band) on the
    # 30^3 torus: every step against the published table; esc and escb
    # against the oracle's whole CSR at every step (the products computed
    # once, above), dense and band on the final values of 128 rows
    other_chains = {}
    half_width = bandmm.cyclic_bandwidth(h30)
    check(half_width == 1799, f"30^3 cyclic bandwidth {half_width}, not 1,799")
    chain_iters = 3
    for algo, run in (
            ("esc", lambda: run_chain(h30, dev, max_step=STEPS, iters=chain_iters,
                                      native_stats=stats, verbose=False, oracle=oracle30)),
            ("escb", lambda: run_chain_escb(h30, dev, max_step=STEPS, iters=chain_iters,
                                            native_stats=stats, verbose=False,
                                            oracle=oracle30)),
            ("dense", lambda: run_chain_dense(h30, dev, max_step=STEPS, iters=chain_iters,
                                              native_stats=stats, verbose=False)),
            ("band", lambda: run_chain_band(h30, dev, half_width, block=BAND_BLOCKS[n30],
                                            max_step=STEPS, iters=chain_iters, native_stats=stats,
                                            verbose=False))):
        reset_counts()
        t0 = time.perf_counter()
        steps, out = run()
        t_path = time.perf_counter() - t0
        counts = {name: mod.LAUNCHES for name, mod in counters.items()}
        got = [(r.step, r.nnz, int(r.max_value)) for r in steps]
        check(got == EXPECTED, f"{algo} chain (step, nnz, max) {got} != {EXPECTED}")
        # a step is one checked call and chain_iters timed calls
        want_esc = ESC_PER_PRODUCT * (STEPS - 1) * (1 + chain_iters) if algo == "esc" else 0
        check(counts["spgemm_esc"] == want_esc and not any(
                  n for k, n in counts.items() if k != "spgemm_esc"),
              f"--algo {algo} launches {counts}, not {want_esc} of ESC's kernels alone")
        if algo == "esc":
            esc_row["esc_chain_launches"] = counts["spgemm_esc"]
        csr_chain = algo in ("esc", "escb")
        if not csr_chain:
            verify_final_values(out if algo == "dense" else bandmm.band_to_dense(out), final,
                                sample_rows=128)
        del out
        torch.cuda.empty_cache()
        other_chains[algo] = {str(r.step): r.seconds * 1e3 for r in steps}
        checked = ("the whole CSR == oracle at every step" if csr_chain
                   else "final values == oracle on 128 leading rows")
        timed = "whole calls, host plan included" if csr_chain else "CUDA events"
        print(f"[4] --algo {algo}: per-step (nnz, max) == oracle == published table; "
              f"{checked}; steps "
              f"{', '.join(f'A^{k} {v:.4f} ms' for k, v in other_chains[algo].items())}; "
              f"total {sum(other_chains[algo].values()):.4f} ms ({timed}); path "
              f"{t_path:.1f} s; launches {counts}", flush=True)

    since_start("the real-graph phase")
    # the real-graph study on the power-law substitutes at the published sizes
    real, int8_rate, rg_launches, path_ms["real graphs"], rg_err = real_graph_phase(
        dev, counters, reset_counts)

    since_start("the einsum engine phase")
    # the einsum engine: engine_bench's tiers, the chain tier on the torus and
    # nell, the exact entry-driven tier, the grouped tier, the device btree
    engine_out, eng_launches, path_ms["einsum engine"], eng_err = engine_phase(
        dev, counters, reset_counts, h30, oracle30)

    since_start("the dist phase")
    # row-partitioned execution: one rank on NCCL, four ranks sharing the
    # card over gloo, the scaling CLI, the dry run, memcross and the report
    dist_out = dist_phase(dev, counters, reset_counts, h30, oracle30,
                          sum(other_chains["esc"].values()), att_rows)

    since_start("phase 5 (results)")
    # ---- phase 5: results
    meta = {
        "spmm_dense_acc": ("sparsetpu_torch/csrc/spmm_dense_acc.cu",
                           "sparsetpu/kernels/spmm_pallas.py:109"),
        "spmm_band": ("sparsetpu_torch/csrc/spmm_band.cu",
                      "sparsetpu/kernels/bandplanes.py:141"),
        "spmm_group_dot": ("sparsetpu_torch/csrc/spmm_group_dot.cu",
                           "sparsetpu/kernels/spmm_pallas.py:270"),
        "sdd_block_scores": ("sparsetpu_torch/csrc/sdd_block_scores.cu",
                             "sparsetpu/kernels/blocksparse.py:100"),
        "sortmerge_rows": ("sparsetpu_torch/csrc/sortmerge_rows.cu",
                           "sparsetpu/kernels/sortmerge.py:120"),
        "coalesce_blocks": ("sparsetpu_torch/csrc/coalesce_blocks.cu",
                            "sparsetpu/kernels/coalesce.py:48"),
    }
    # the path whose run counts a kernel's launches, and sums its device time
    kernel_path = {"spmm_dense_acc": "dense-acc", "spmm_band": "foldband",
                   "spmm_group_dot": "group-dot", "sdd_block_scores": "attention",
                   "sortmerge_rows": "spgemm sweep", "coalesce_blocks": "mixed"}
    kernels = []
    for name, (source, replaces) in meta.items():
        path = kernel_path[name]
        on_path = path_ms[path][name]
        if on_path == 0.0:
            print(f"[5] torch.profiler shows no device time for {name} on the {path} path",
                  flush=True)
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name], **timing[name],
            "path": path, "path_device_ms": on_path or None,
            "pass_launches": pass_stats[name][0], "pass_device_ms": pass_stats[name][1],
        }
        if name in chain_ms:
            entry["chain_ms"] = chain_ms[name]
        if name in ("spmm_dense_acc", "sortmerge_rows", "coalesce_blocks"):
            # the real-graph path: its launches, the device ms of each step's
            # first (profiled) call, and the max |error| against the plain
            # version on that path's own inputs (None: not launched there)
            entry["real_graph_launches"] = rg_launches[name]
            entry["real_graph_pass_device_ms"] = path_ms["real graphs"][name]
            entry["real_graph_max_abs_err"] = rg_err.get(name)
        # the einsum engine's path: its launches, the device ms of one call of
        # each held einsum, the max |error| on its own inputs (None: not held)
        entry["engine_launches"] = eng_launches[name]
        entry["engine_pass_device_ms"] = path_ms["einsum engine"][name]
        entry["engine_max_abs_err"] = eng_err.get(name)
        kernels.append(entry)
    print(json.dumps({"path_device_ms": path_ms, "rowcat_chain_steps_ms": rowcat_ms,
                      "pass": {name: {"launches": n, "device_ms": ms}
                               for name, (n, ms) in pass_stats.items()}}), flush=True)
    print(json.dumps({"attention_config1_us": {
        str(d): {"dense": float(ref.split("ref_time=")[1].split(" ")[0]),
                 **{impl: float(r[8]) for impl, r in rows.items()}}
        for d, (ref, rows) in att_rows.items()}}), flush=True)
    print(json.dumps({"spgemm_sweep_s": sweep,
                      "sweep_spmm_dense_acc_launches": da_launches}), flush=True)
    print(json.dumps({"spgemm_auto": auto, "chains_steps_ms": other_chains}), flush=True)
    print(json.dumps({"mixed_chain_ms": mixed_ms, "mixed_steps_ms": {
        str(r.step): r.seconds * 1e3 for r in results}, "mixed_densify_ms": t_dens * 1e3,
        "slab_paths": slab_paths}), flush=True)
    print(json.dumps({"real_graphs": real, "int8_panel_tops": int8_rate}), flush=True)
    print(json.dumps({"einsum_engine": engine_out}), flush=True)
    print(json.dumps({"dist": dist_out}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    # the ESC kernels on the main path: the esc chain's launches (above), the
    # real-graph, engine and dist phases' launches and their holds against
    # the tensor ops on the phases' own inputs (None: not launched there)
    esc_row.update(real_graph_launches=rg_launches["spgemm_esc"],
                   real_graph_max_abs_err=rg_err.get("spgemm_esc"),
                   engine_launches=eng_launches["spgemm_esc"],
                   engine_max_abs_err=eng_err.get("spgemm_esc"),
                   dist_launches=dist_out["esc"]["launches"],
                   dist_steps_held=dist_out["esc"]["held"])
    print(json.dumps({"esc_products": esc_row}), flush=True)
    # the panel kernels on the main path: the real-graph and engine phases'
    # launches (both kernels') and each kernel's hold against the tensor ops
    # on the phases' own inputs (None: not launched there)
    panel_row.update(real_graph_launches=rg_launches["panelpack"],
                     real_graph_max_abs_err={w: rg_err.get(w) for w in PANEL_KERNELS},
                     engine_launches=eng_launches["panelpack"],
                     engine_max_abs_err={w: eng_err.get(w) for w in PANEL_KERNELS})
    print(json.dumps({"panel_pack": panel_row}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
