"""The real-graph study on the port: the counterpart of ``sparsetpu/bench/real_graphs.py``.

Citation-graph-scale graphs (Planetoid cora and nell, ogbn-arxiv) at their
published node and directed-edge counts.  Their edge files cannot be
fetched here, so where ``gen-graphs/<name>.edges`` is absent a power-law
(preferential-attachment) substitute at the same counts stands in, labelled
``<name>_pl`` and checked against the published degree moments
(``datasets.check_substitute``); the generator and its seed are JAX's, so
the substitutes are the same graphs bit for bit.

Per graph:

- the structure report: components, degrees, bandwidth before and after
  reverse Cuthill-McKee;
- the A^2..A^k chain, each step routed by the study's guards, A^2's whole
  CSR checked against the C++ oracle's (JAX checks its nnz; CSV ``graph,n,nnz_a,step,nnz_out,flops,
  seconds,algo``, JAX's);
- ``--algos``: reachability (the pattern-stable sum of powers) and the
  diameter, on the dense int8 pattern engine where its frame fits the card;
- ``--band-hybrid``: C = A x A through RCM and the band/outlier hybrid,
  held against ``spgemm_auto`` value for value.

The guards.  JAX's values (``JAX_GUARDS``) were sized for a 16 GB TPU and
its cost model; the study runs ``CARD_GUARDS`` (every function's default),
and the tests hold the routes under ``JAX_GUARDS`` to JAX's.  Only the guards
sized for the TPU change; the chain's own constants (the 32M-product sort
bound, the 2^28-product colchunk cap, the 2^26-entry stop, the 2^28-product
reachability bound and the route's per-product and per-element times) stay
JAX's, as do ``ops/spgemm.py``'s router constants.

- ``dense_fit_bytes``, the dense P and C frames of the untiled dense
  accumulator (n x padded n x 4 B each): 6e9 on the TPU; 30e9 on the card,
  3/8 of its 80 GB, leaving the rest for the output CSR and the pack's
  temporaries.  nell's two frames take 35 GB, so A^4 stays tiled, as on the
  TPU.
- ``max_dma_issues``: the tiled route's 2 x nnz(A) x panels row gathers,
  priced on the TPU at ~340 ns a DMA issue (600M ~ 3.5 min).  The panels
  are those ``spgemm_auto`` runs, ``dense_acc_panel_cols(n)`` at the
  router's own 6e9 budget (the same as JAX's ``DENSE_FIT_BYTES``, so the
  count is JAX's): 13 of 5,120 columns at nell, 83 of 2,048 at ogbn-arxiv.
  The card's kernel gathers a row of a panel (2,048 f32 at ogbn, 8 KB)
  from memory at its rate; 40e9 rows of 8 KB are ~100 s at the data
  sheet's 3.35 TB/s.
- The output guard, min(flops, n^2) x ``out_entry_bytes`` <= ``out_budget_
  bytes``: 12 B an entry and 5e9 on the TPU (nell A^4 ran out of memory
  past it); the port stores an entry in 20 B (an int32 column and two
  uint32 limbs carried in int64) and gives the output half of the card,
  40e9 B.  ogbn A^3 (697.8M products, 14 GB) then gets an attempt.
- The same budget prices a sparse closure (reachability and the diameter
  where the int8 frame does not fit): it holds at most sum |C|^2 entries
  over the weakly connected components C; past the budget both are a
  ``DNF_closure_budget`` row rather than minutes of products that end out
  of memory.  ogbn-arxiv (one component of 169,343 nodes: 28.7e9 entries,
  574 GB) is such a row; nell takes the dense engine.  JAX has no such
  guard: its rows differ only for graphs past the frame's cap.

Failures.  An out-of-memory error (``torch.cuda.OutOfMemoryError``, where
JAX catches its ``JaxRuntimeError``, or the host's ``MemoryError``), a
``ValueError`` (a poisoned capacity, a value range) and a loop that does
not converge become a DNF row naming the error; the card's memory is released before going on.  Any
other error, a kernel's failure among them, propagates.  A timed call that
fails after the step's first call is re-run only inside a handler (JAX
re-runs it outside one).

Run on the card: ``python -m sparsetpu_torch.bench.real_graphs [--graphs
cora nell ogbn_arxiv] [--max-power 4] [--iters 2] [--no-rcm] [--algos]
[--band-hybrid] [--out bench_out/real_graphs_h100.csv]
[--device cuda|cpu]``.  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..csr import SparseCSR
from ..graphs import algos, datasets, patterns
from ..graphs.patterns import ConvergenceError
from ..ops.spgemm import dense_acc_panel_cols, spgemm_auto, symbolic_flops_exact
from ..semiring import U64
from .spgemm_bench import check_against_oracle

# published sizes: directed edge counts of Planetoid cora / nell and ogbn-arxiv
GRAPHS = [
    ("cora", 2708, 10556),
    ("nell", 65755, 251550),
    ("ogbn_arxiv", 169343, 1166243),
]
HEADER = "graph,n,nnz_a,step,nnz_out,flops,seconds,algo"
PORT_ENTRY_BYTES = 20  # an int32 column and two uint32 limbs carried in int64


@dataclasses.dataclass(frozen=True)
class Guards:
    """The study's routing and budget guards (see the module docstring)."""

    max_expansion: int          # reachability's A^2 products, at most
    max_nnz: int                # the chain stops past this many entries
    max_dma_issues: float       # the tiled route's row gathers, at most
    sort_max_flops: int         # the slab route, up to this many products
    dense_fit_bytes: float      # the untiled dense accumulator's two frames
    colchunk_max_flops: int     # the column-chunked slab, up to this
    out_entry_bytes: int        # bytes an output entry
    out_budget_bytes: float     # the output's budget, and a sparse closure's


JAX_GUARDS = Guards(max_expansion=1 << 28, max_nnz=1 << 26, max_dma_issues=600_000_000,
                    sort_max_flops=32_000_000, dense_fit_bytes=6e9,
                    colchunk_max_flops=1 << 28, out_entry_bytes=12, out_budget_bytes=5e9)
CARD_GUARDS = dataclasses.replace(
    JAX_GUARDS, max_dma_issues=40e9, dense_fit_bytes=30e9,
    out_entry_bytes=PORT_ENTRY_BYTES, out_budget_bytes=40e9)


def _dnf_errors():
    """The errors that become a DNF row (JAX: ValueError, RuntimeError and
    its JaxRuntimeError): a value or capacity condition, the card's or the
    host's memory, a loop that does not settle."""
    return (ValueError, torch.cuda.OutOfMemoryError, MemoryError, ConvergenceError)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def load_or_synthesize(name: str, n: int, m: int) -> Tuple[str, tuple]:
    """The graph's edge file when present, else its power-law substitute at
    the published counts (JAX's generator and seed: the same COO)."""
    path = os.path.join("gen-graphs", f"{name}.edges")
    if os.path.exists(path):
        return name, datasets.load_edges(path)
    # power_law emits both directions, so the target is the directed count;
    # zlib.crc32 rather than hash(), which Python salts per process
    m_per_node = max(1, round(m / n / 2))
    coo = datasets.power_law(n, m_per_node, seed=zlib.crc32(name.encode()) % (1 << 31),
                             target_directed_edges=m)
    datasets.check_substitute(name, coo)
    return f"{name}_pl", coo


def structure_report(label: str, coo: tuple, a: SparseCSR, with_rcm: bool = True) -> List[str]:
    rows_np, _, _, n = coo
    deg = np.bincount(rows_np, minlength=n)
    comp = algos.connected_components(a)
    sizes = np.bincount(comp)
    sizes = np.sort(sizes[sizes > 0])[::-1]
    lines = [
        f"[{label}] n={n} nnz={int(a.nnz)}",
        f"  components: {len(sizes)} (top sizes {sizes[:5].tolist()}, "
        f"{int((sizes == 1).sum())} singletons)",
        f"  degree: min={deg.min()} median={int(np.median(deg))} "
        f"avg={deg.mean():.1f} max={deg.max()}",
    ]
    mb, ab = algos.bandwidth_stats(a)
    lines.append(f"  bandwidth (original): max={mb} avg={ab:.1f}")
    if with_rcm:
        t0 = time.perf_counter()
        a_rcm, _ = algos.rcm(a)
        t_rcm = time.perf_counter() - t0
        mb2, ab2 = algos.bandwidth_stats(a_rcm)
        lines.append(
            f"  bandwidth (RCM): max={mb2} avg={ab2:.1f} ({t_rcm*1e3:.0f} ms)"
            f"  reduction: max {mb/max(mb2,1):.1f}x avg {ab/max(ab2,1e-9):.1f}x")
    return lines


def route_step(n: int, nnz_a: int, flops: int, guards: Guards = CARD_GUARDS) -> str:
    """The chain step's route, or its DNF label, by JAX's rule under
    ``guards``: slab up to ``sort_max_flops`` products, the untiled dense
    accumulator where its frames fit, colchunk where its ~90 ns a product
    undercuts the panel sweep's ~4.3 ns a frame element, the panel sweep
    within the gather and output budgets, else a DNF."""
    padded_m = -(-n // 1024) * 1024
    dense_fits = n * padded_m * 4 * 2 <= guards.dense_fit_bytes
    panel_w = dense_acc_panel_cols(n)  # the width spgemm_auto's tiled route runs
    n_panels = -(-n // panel_w) if panel_w else 0
    t_tiled_est = n * padded_m * 4.3e-9 if panel_w else math.inf
    if flops <= guards.sort_max_flops:
        return "slab"
    if dense_fits:
        return "denseacc"
    if flops * 90e-9 < t_tiled_est and flops <= guards.colchunk_max_flops:
        return "colchunk"
    if (panel_w and 2 * nnz_a * n_panels <= guards.max_dma_issues
            and min(flops, n * n) * guards.out_entry_bytes <= guards.out_budget_bytes):
        return "denseacc_tiled"
    return "DNF_sort_ceiling" if not panel_w else "DNF_budget"


def _profiled_call(fn, device: torch.device, profile: bool = True):
    """(fn(), wall s, device times or None): with ``profile`` on the card
    the call runs under torch.profiler (CUDA activity), and its kernels'
    summed time and each hand-written kernel's come back as (device s,
    {kernel: ms})."""
    if device.type != "cuda" or not profile:
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    from .spgemm_profile import device_us

    _sync(device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    kernel_ms = {}
    for e in prof.key_averages():
        for name in ("spmm_dense_acc", "sortmerge_rows", "coalesce_blocks"):
            if f"{name}_kernel" in e.key:
                kernel_ms[name] = kernel_ms.get(name, 0.0) + device_us(e) / 1e3
    return out, wall, (busy, kernel_ms)


def bench_chain(label: str, a: SparseCSR, max_power: int, iters: int = 2,
                verbose: bool = True, flush_fn=None, guards: Guards = CARD_GUARDS,
                details: Optional[list] = None,
                on_product: Optional[Callable[[int, SparseCSR], None]] = None) -> List[str]:
    """A^2..A^max_power: each step's route (``route_step``), A^2's whole CSR
    against the oracle's first, then the least of ``iters`` whole calls by
    the host clock after a synchronisation.  Each step computes A x A^(k-1): the
    sparse operand of the dense-accumulator routes stays A.  ``details``,
    when given, receives a dict a step: route, nnz, the timed seconds, the
    first call's wall and device seconds (on the card: under
    torch.profiler, with the hand-written kernels' device ms) and the peak
    of allocated card memory.  ``on_product``, when given, is called as
    ``on_product(step, C)`` once the step is timed, with the product of its
    last timed call (a caller's own check; not for a step whose timed call
    ran out of memory)."""
    rows: List[str] = []
    n = a.n_rows
    device = a.device
    flush = (lambda: flush_fn(rows)) if flush_fn else (lambda: None)

    def emit(line: str, note: str = "") -> None:
        rows.append(line)
        flush()
        if verbose:
            print(line + note, flush=True)

    # the oracle's A^2 before anything is timed
    rp_h, ci_h, v_h = a.to_numpy()
    base = native.as_host_csr(rp_h.astype(np.int64), ci_h, v_h)
    want2 = native.spgemm(base, base, n)
    nnz_a = int(a.nnz)

    prev = a
    for step in range(2, max_power + 1):
        flops = symbolic_flops_exact(a, prev)
        algo = route_step(n, nnz_a, flops, guards)
        if algo.startswith("DNF"):
            emit(f"{label},{n},{nnz_a},{step},{algo},{flops},0,auto")
            break

        def run_once():
            return spgemm_auto(a, prev, kernel=algo)

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        try:
            c, wall1, prof = _profiled_call(lambda: run_once().check(), device,
                                            profile=details is not None)
        except _dnf_errors() as e:
            _release(device)
            emit(f"{label},{n},{nnz_a},{step},DNF_{type(e).__name__},{flops},0,{algo}",
                 f"  # {str(e)[:160]}")
            break
        if step == 2:
            check_against_oracle(c, want2, f"{label} A^2")
            del want2
        nnz_c = int(c.nnz)
        # keep at most one output alive: at this scale a second one doubles
        # the peak (nell A^4 ran out of memory on the TPU's second call)
        last_step = nnz_c > guards.max_nnz or step == max_power
        del c
        best, out = math.inf, None
        try:
            for _ in range(iters):
                out = None
                _sync(device)
                t0 = time.perf_counter()
                out = run_once()
                _sync(device)
                best = min(best, time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError:
            _release(device)
            if best == math.inf:
                emit(f"{label},{n},{nnz_a},{step},DNF_retime,{flops},0,{algo}")
                break
        emit(f"{label},{n},{nnz_a},{step},{nnz_c},{flops},{best:.6f},{algo}",
             f"  ({flops/best/1e6:.1f} Mproducts/s)" if best < math.inf else "")
        if details is not None:
            info = dict(step=step, algo=algo, nnz=nnz_c, flops=flops, seconds=best,
                        first_call_s=wall1)
            if prof is not None:
                info.update(first_call_device_s=prof[0],
                            idle_share=max(0.0, 1.0 - prof[0] / wall1), kernel_ms=prof[1],
                            peak_bytes=torch.cuda.max_memory_allocated(device))
            details.append(info)
        if on_product is not None and out is not None:
            on_product(step, out)
        if last_step:
            break
        if out is None:  # a timed call ran out of memory: recompute, in a handler
            try:
                out = run_once()
            except _dnf_errors() as e:
                _release(device)
                emit(f"{label},{n},{nnz_a},{step + 1},DNF_{type(e).__name__},0,0,{algo}")
                break
        prev = out
    return rows


def closure_bound(a: SparseCSR) -> int:
    """sum |C|^2 over the weakly connected components C of a: the most
    entries a closure (or a reachability set) of a can hold."""
    sizes = np.bincount(algos.connected_components(a)).astype(np.int64)
    return int((sizes * sizes).sum())


def _closure_dnf(a: SparseCSR, guards: Guards) -> Optional[int]:
    """The closure bound when the sparse route would be taken and its
    entries pass the output budget, else None."""
    if patterns.fits(a.n_rows):
        return None
    bound = closure_bound(a)
    return bound if bound * guards.out_entry_bytes > guards.out_budget_bytes else None


def bench_algos(label: str, a: SparseCSR, verbose: bool = True, guards: Guards = CARD_GUARDS,
                details: Optional[list] = None) -> List[str]:
    """Reachability (pattern mode) and the diameter, each timed whole by
    the host clock; CSV rows reuse the chain's columns, step = the
    algorithm.  Reachability's row carries its nnz (counted, not built as a
    CSR: nell's holds 4.3e9 entries) and k.  ``details``, when given,
    receives each algorithm's seconds, the int8 operations of its pattern
    products and, on the card, the peak of allocated memory."""
    rows: List[str] = []
    n = a.n_rows
    nnz_a = int(a.nnz)
    device = a.device

    def timed(name, fn):
        """fn() timed whole; its details noted under ``name``."""
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ops0 = patterns.PRODUCT_OPS
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        dt = time.perf_counter() - t0
        if details is not None:
            details.append(dict(algo=name, seconds=dt, int8_ops=patterns.PRODUCT_OPS - ops0,
                                peak_bytes=torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None))
        return out, dt

    closure = _closure_dnf(a, guards)
    # the closure blows up on dense-ish graphs: JAX guards with A^2's products
    flops2 = symbolic_flops_exact(a, a)
    if flops2 > guards.max_expansion:
        rows.append(f"{label},{n},{nnz_a},reachability,DNF_budget,{flops2},0,auto")
    elif closure is not None:
        rows.append(f"{label},{n},{nnz_a},reachability,DNF_closure_budget,{closure},0,auto")
    else:
        try:
            (nnz_r, k), dt = timed("reachability", lambda: algos.reachability_nnz(a))
            rows.append(f"{label},{n},{nnz_a},reachability,{nnz_r},{k},{dt:.6f},auto")
        except _dnf_errors() as e:
            _release(device)
            rows.append(f"{label},{n},{nnz_a},reachability,DNF_{type(e).__name__},"
                        f"{flops2},0,auto")
    if closure is not None:
        rows.append(f"{label},{n},{nnz_a},diameter,DNF_closure_budget,{closure},0,auto")
    else:
        try:
            d, dt = timed("diameter", lambda: algos.diameter(a))
            rows.append(f"{label},{n},{nnz_a},diameter,{d},0,{dt:.6f},auto")
        except _dnf_errors() as e:
            _release(device)
            rows.append(f"{label},{n},{nnz_a},diameter,DNF_{type(e).__name__},0,0,auto")
    if verbose:
        for ln in rows:
            print(ln, flush=True)
    return rows


def bench_band_hybrid(label: str, a: SparseCSR, iters: int = 2,
                      verbose: bool = True) -> List[str]:
    """C = A x A through RCM and the band/outlier hybrid: RCM-reorder, split
    at the 90th percentile |r - c| rounded up to 128, multiply (band product,
    column gathers, ``spgemm_auto`` on the outliers), hold the CSR against
    ``spgemm_auto``'s value for value, then time both by the host clock.
    Rows reuse the chain's columns (step = hybrid@<half-width>,
    esc_comparator)."""
    from ..ops import hybrid

    rows: List[str] = []
    n = a.n_rows
    device = a.device
    try:
        t0 = time.perf_counter()
        a_rcm, _ = algos.rcm(a)
        t_rcm = time.perf_counter() - t0
        rp, ci, _ = a_rcm.to_numpy()
        rr = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        dist = np.abs(rr - ci.astype(np.int64))
        hw = int(-(-int(np.percentile(dist, 90)) // 128) * 128) or 128
        h = hybrid.hybrid_from_csr(a_rcm, hw, block=128)
        band_frac = int(h.band.nnz()) / max(int(a_rcm.nnz), 1)
        flops = symbolic_flops_exact(a_rcm, a_rcm)
    except (OverflowError, *_dnf_errors()) as e:
        _release(device)
        rows.append(f"{label},{n},{int(a.nnz)},hybrid_setup,DNF_{type(e).__name__},0,0,band+esc")
        if verbose:
            print(rows[-1] + f"  # {e}", flush=True)
        return rows
    if verbose:
        print(f"# [{label}] RCM {t_rcm*1e3:.0f} ms; half_width={hw} band covers "
              f"{band_frac:.1%} of nnz (outliers {int(h.outliers.nnz)})", flush=True)

    def run_hybrid():
        return hybrid.hybrid_matmul(h, h, a_csr=a_rcm).to_csr(a_rcm.sr)

    try:
        got = run_hybrid().check()
        ref = spgemm_auto(a_rcm, a_rcm).check()
        if int(got.nnz) != int(ref.nnz):
            raise AssertionError(f"nnz {int(got.nnz)} != {int(ref.nnz)}")
        for part, g, r in zip(("row_ptr", "col_idx", "values"), got.to_numpy(),
                              ref.to_numpy()):
            if not np.array_equal(g, r):
                raise AssertionError(f"{part} mismatch band-hybrid vs spgemm_auto")
    except (OverflowError, AssertionError, *_dnf_errors()) as e:
        _release(device)
        rows.append(f"{label},{n},{int(a.nnz)},hybrid@{hw},DNF_{type(e).__name__},"
                    f"{flops},0,band+esc")
        if verbose:
            print(rows[-1] + f"  # {e}", flush=True)
        return rows
    for name, fn, out in ((f"hybrid@{hw}", run_hybrid, got),
                          ("esc_comparator", lambda: spgemm_auto(a_rcm, a_rcm), ref)):
        best = math.inf
        for _ in range(iters):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        rows.append(f"{label},{n},{int(a.nnz)},{name},{int(out.nnz)},{flops},{best:.6f},"
                    "band+esc")
        if verbose:
            print(rows[-1], flush=True)
    return rows


def host_diameter(coo: tuple) -> int:
    """The exact diameter of a connected undirected graph on the host, by
    BFS (scipy) with eccentricity bounds: each BFS from v gives ecc(v)
    exactly and bounds every w by max(ecc(v) - d, d) <= ecc(w) <= ecc(v) +
    d, d = d(v, w).  Sources alternate between the open node of the largest
    upper bound and that of the least lower bound; the search ends once no
    open node's upper bound exceeds the largest eccentricity found, which
    is then the diameter (no bound is returned).  Each BFS closes its
    source, so at most n run."""
    import scipy.sparse as ssp
    from scipy.sparse.csgraph import shortest_path

    rows, cols, _, n = coo
    adj = ssp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    deg = np.diff(adj.indptr)
    lo = np.zeros(n, np.int64)
    hi = np.full(n, np.iinfo(np.int64).max)
    open_ = np.ones(n, bool)
    best, i = 0, 0
    while open_.any() and hi[open_].max() > best:
        cand = np.flatnonzero(open_)
        # ties go to the highest degree, a hub first
        key = (-hi[cand], -deg[cand]) if i % 2 else (lo[cand], -deg[cand])
        v = cand[np.lexsort(key[::-1])[0]]
        d = shortest_path(adj, unweighted=True, indices=int(v))
        if np.isinf(d).any():
            raise ValueError("host_diameter needs a connected graph")
        d = d.astype(np.int64)
        ecc = int(d.max())
        lo = np.maximum(lo, np.maximum(ecc - d, d))
        hi = np.minimum(hi, ecc + d)
        open_[v] = False
        open_ &= lo < hi  # a node whose bounds meet is known exactly
        best = max(best, ecc, int(lo[~open_].max()))
        i += 1
    return best


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.real_graphs",
        description="The real-graph study: structure, the A^k chain, reachability, "
                    "diameter and the band hybrid on cora / nell / ogbn-arxiv (or their "
                    "power-law substitutes)")
    ap.add_argument("--graphs", nargs="*", default=[g[0] for g in GRAPHS])
    ap.add_argument("--max-power", type=int, default=4)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--no-rcm", action="store_true",
                    help="skip the structure report's RCM pass (host BFS)")
    ap.add_argument("--algos", action="store_true",
                    help="also time reachability and the diameter per graph")
    ap.add_argument("--band-hybrid", action="store_true",
                    help="also run the RCM + band/outlier hybrid A^2")
    ap.add_argument("--out", default="bench_out/real_graphs_h100.csv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; only an explicit --device cpu "
                           "runs the study on the CPU, with the plain versions")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# real-graph study on {name}", flush=True)

    all_rows = [HEADER]
    print(HEADER, flush=True)

    def write(pending=()):
        # after every row: a killed run keeps its finished steps
        with open(args.out, "w") as f:
            f.write("\n".join(all_rows + list(pending)) + "\n")

    for gname, n, m in GRAPHS:
        if gname not in args.graphs:
            continue
        label, coo = load_or_synthesize(gname, n, m)
        r, c, v, nn = coo
        a = SparseCSR.from_coo_host(r, c, v, nn, sr=U64, device=device)
        for ln in structure_report(label, coo, a, with_rcm=not args.no_rcm):
            print("# " + ln, flush=True)
        all_rows += bench_chain(label, a, args.max_power, iters=args.iters, flush_fn=write)
        write()
        if args.band_hybrid:
            # before the algorithms, the heaviest on memory: an out-of-memory
            # error there cannot take earlier sections' rows with it
            all_rows += bench_band_hybrid(label, a, iters=args.iters)
            write()
        if args.algos:
            all_rows += bench_algos(label, a)
            write()
        del a
        _release(device)
    print(f"# wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
