"""The readings that the check's limits are set from (not run by the benchmark).

    python3 benchmark/readings.py --workload <cell> --seconds <s> --seeds <n> ... [--out FILE]

Runs the cell once per seed, as `run.py` does but with a window of
`--seconds`, and reads each number the check compares (`run.compared_numbers`,
with `tv_rel` and `tv_grad_rel` where the configuration sets gamma) three
times over the same run: of the program (the lower reading is the largest
over the seeds); of the control, the plain reference in bfloat16
put in the program's place; and of a solve that hands back its prior (each
upper reading is the smallest over the seeds of the control or, for
`aee_max`, of that fault). Each of the three is judged by `run.assemble`
against the cell's limits, and its `correct` printed. Prints one JSON line
per seed and, last, both readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__" and __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import run, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    cell = spec.Cell.named(args.workload)
    rows = []
    for seed in args.seeds:
        r = run.run_cell(cell, seed, args.seconds, False, control=True,
                         t_start=time.perf_counter())
        row = {"seed": seed, "windows": sum(f["compared"]["windows"] for f in r.final),
               "edges_max": max(f["compared"].get("edges_max", 0.0) for f in r.final)}
        for judged in run.JUDGED:
            row[judged] = run.compared_numbers(r, judged)
            row[f"{judged}_correct"] = run.assemble(r, False, judged)["correct"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = list(rows[0]["program"])
    upper = {n: min(r["control"][n] for r in rows) for n in names}
    upper["aee_max"] = min(r["prior"]["aee_max"] for r in rows)
    summary = {"workload": args.workload, "seeds": args.seeds,
               "lower": {n: max(r["program"][n] for r in rows) for n in names},
               "upper": upper,
               "correct": {j: [r[f"{j}_correct"] for r in rows] for j in run.JUDGED}}
    print(json.dumps(summary))
    if args.out:
        args.out.write_text(json.dumps({"rows": rows, **summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
