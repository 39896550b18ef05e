"""Memory-crossover study: sparse (grouped-CSR) vs dense storage for the
attention operands, from the tipover sweeps; the counterpart of
``sparsetpu/bench/memcross.py``, the same arithmetic and output.

Reproduces the reference's memory analysis shape (bench_report.md:77-94:
"CSR memory overhead at full density 1.47-1.54x dense; memory crossover
~68%") for THIS framework's format: per density step the tipover CSVs
carry exact-nnz self-reports (mem_q/mem_k, tipover.py:_csr_mem_bytes —
row_ptr + nnz * (col + limb) bytes, reference estimate_memory_usage role,
src/dense.rs:170).  The esc rows stop where the expansion exceeds the
one-chip budget, so the full-density ratio is computed analytically from
the same formula with nnz = n_weights (exact: the formula is linear in
nnz and every other term is shape-only).

It reads the ``tipover_results_{cfg}.csv`` files that the port's
``bench/tipover.py`` writes (same header: ``mem_k``, ``mem_q`` are each
operand's exact-nnz bytes, ``tipover._csr_mem_bytes``), by default from the
tipover CLI's ``--out-dir``, and writes a new file, never the JAX package's
``reports/memory_crossover.csv``.

Usage: python -m sparsetpu_torch.bench.memcross [--dir bench_out] [--out ...]
Emits one CSV row per config + a markdown summary block on stdout.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import List, Optional, Tuple


def parse_csv(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    m = re.search(r"n_weights=(\d+)", lines[0])
    n_weights = int(m.group(1))
    rows = []
    for ln in lines[2:]:
        p = ln.split(",")
        if len(p) >= 9 and p[0] == "esc":
            rows.append(dict(density=float(p[1]), q_nz=int(p[2]),
                             k_nz=int(p[3]), mem_k=int(p[5]),
                             mem_q=int(p[6])))
    return n_weights, rows


def analyze(path: str, cfg: int) -> Tuple[List[str], str]:
    n_weights, rows = parse_csv(path)
    dense_pair = 2 * n_weights * 4  # Q + K, f32
    out_rows = []
    crossover: Optional[float] = None
    prev_below = None
    for r in rows:
        sparse_pair = r["mem_q"] + r["mem_k"]
        ratio = sparse_pair / dense_pair
        out_rows.append(
            f"{cfg},{r['density']:.4f},{r['q_nz'] + r['k_nz']},"
            f"{sparse_pair},{dense_pair},{ratio:.4f}")
        if ratio <= 1.0:
            prev_below = r["density"]
        elif crossover is None and prev_below is not None:
            crossover = r["density"]  # first measured step past parity
    # analytic full density: nnz = n_weights per tensor; per-tensor bytes =
    # 4*(n_rows+1) + nnz*8 (f32: col idx + one limb).  n_rows+1 is recovered
    # from any measured row: mem = 4*(n_rows+1) + nnz*8.
    if rows:
        r0 = rows[-1]
        rows_term_q = r0["mem_q"] - r0["q_nz"] * 8
        rows_term_k = r0["mem_k"] - r0["k_nz"] * 8
        full_sparse = (rows_term_q + rows_term_k) + 2 * n_weights * 8
        full_ratio = full_sparse / dense_pair
        # exact crossover density of the analytic line: sparse(d) =
        # rows_terms + d * n_weights * 2 * 8 == dense_pair
        d_cross = (dense_pair - rows_term_q - rows_term_k) / (
            2 * n_weights * 8)
        summary = (
            f"config {cfg}: full-density sparse/dense = {full_ratio:.2f}x; "
            f"analytic memory crossover at density {d_cross:.2%} "
            f"(first measured step over 1.0: "
            f"{crossover if crossover else 'none reached'})")
    else:
        summary = f"config {cfg}: no esc rows"
    return out_rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench.memcross")
    ap.add_argument("--dir", default="bench_out",
                    help="where the tipover CSVs are (the tipover CLI's --out-dir)")
    ap.add_argument("--configs", type=int, nargs="*", default=[0, 1, 2, 3, 4])
    ap.add_argument("--out", default="bench_out/memory_crossover_h100.csv")
    args = ap.parse_args(argv)
    rows = ["config,density,pair_nnz,sparse_bytes,dense_bytes,ratio"]
    summaries = []
    for cfg in args.configs:
        path = os.path.join(args.dir, f"tipover_results_{cfg}.csv")
        if not os.path.exists(path):
            continue
        r, s = analyze(path, cfg)
        rows += r
        summaries.append(s)
        print(s, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(rows) + "\n")
        f.write("# " + "\n# ".join(summaries) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
