"""The two readings behind each limit of ``correct``, at a cell's own size.

For each seed, one process runs the cell as ``spbench.run`` does, with a
short window, and reports the numbers it compares (the program's reading,
the lower one); for the control seeds it also puts the control in the
program's place: the plain reference with every product's entries carried
in bfloat16 (``reference.round_bf16``), judged by the same comparison (the
upper reading).  The configurations state exact u64 results; their values
stay below 2^24, where u32 and the f32 carrier of the dense routes are
still exact, so the control is the 16-bit carrier a later change would be
tempted by.  It also prints each seed's route and largest values.

Run on the card: ``python -m spbench.control --workload torus30.chain7_esc
--seeds 1 2 3 ... --control-seeds 1 2 3 [--seconds 2]``.  The last line is
one JSON object: per number, the largest program reading and the smallest
control reading.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

from spbench import reference, run


def control_readings(root: str, workload: str, seed: int, pairs, judged, device) -> dict:
    """Wrong entries of the bfloat16 control, for each judged power."""
    cfg, _ = run.cell_files(root, run.load_spec(root), workload)
    rows, cols, vals, n = run.graph(root, cfg, seed)
    exact = {1: reference.from_coo(rows, cols, vals, n, device)}
    ctrl = {1: exact[1]}
    for l, r in pairs:
        if l + r not in exact:
            exact[l + r] = reference.matmul(exact[l], exact[r])
            ctrl[l + r] = reference.matmul(ctrl[l], ctrl[r], rounding=reference.round_bf16)
    wrong = {f"A^{k}": reference.wrong_entries(exact[k], ctrl[k]) for k in judged}
    return {"wrong_entries": sum(wrong.values()), "wrong_by_power": wrong}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    lower, upper = {}, {}
    for seed in args.seeds:
        log = io.StringIO()
        r = run.run_cell(run.ROOT, args.workload, seed, args.seconds, False, args.device,
                         time.perf_counter(), log=log)
        program = {k: c["value"] for k, c in r["checks"].items()}
        for k, v in program.items():
            lower[k] = max(lower.get(k, 0), v)
        line = {"seed": seed, "correct": r["correct"], "program": program,
                "route": r["info"].get("route"),
                "max_value": r["info"]["max_value"], "attempted": r["attempted"],
                "wrong_by_power": r["info"]["wrong_by_power"]}
        if seed in args.control_seeds:
            control = control_readings(run.ROOT, args.workload, seed, r["info"]["pairs"],
                                       r["info"]["judged"], args.device)
            v = control["wrong_entries"]
            upper["wrong_entries"] = min(upper.get("wrong_entries", v), v)
            line["control"] = control
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "control_seeds": args.control_seeds, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
