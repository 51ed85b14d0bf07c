"""Compare the port's figure rows with the reference's, row by row.

    python3 tools/paper_rows_compare.py PORT_LOG REF_JSON [--section paper_validation]

``PORT_LOG`` is the output of ``python -m repro_torch.bench.paper_validation``
(one line a row, every value as the row holds it). ``REF_JSON`` is the
``BENCH_sched.json`` that the reference's ``benchmarks/paper_validation.py``
writes into ``benchmarks/results/`` (run it in a scratch copy of the repo:
``REPRO_BENCH_JOBS=4 python benchmarks/paper_validation.py``, and with
``REPRO_SCHED_EXACT=0 REPRO_SCHED_BACKEND=jax`` for the surrogate, whose
rows go under ``--section paper_validation_surrogate``). Both must be at
the same depth. Every field of every row must be equal: prints the count
and each difference, and exits 1 on any.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

ROW = re.compile(
    r"\s+(?P<fig>\S+) (?P<kernel>\S+) gpus=(?P<n_gpus>\d+) (?P<strategy>\S+)\s+"
    r"(?P<gflops>\S+) GF \(±(?P<gflops_ci95>\S+)\) (?P<gbytes>\S+) GB \(±(?P<gbytes_ci95>\S+)\) "
    r"makespan (?P<makespan_s>\S+) s steals=(?P<steals>\S+)$")
FIGS = ("fig1", "fig2", "fig3", "fig4")


def port_rows(path):
    rows = []
    for line in open(path):
        m = ROW.match(line.rstrip("\n"))
        if m:
            row = m.groupdict()
            row["n_gpus"] = int(row["n_gpus"])
            for key in ("gflops", "gflops_ci95", "gbytes", "gbytes_ci95", "makespan_s", "steals"):
                row[key] = float(row[key])
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port_log")
    ap.add_argument("ref_json")
    ap.add_argument("--section", default="paper_validation")
    args = ap.parse_args(argv)
    got = port_rows(args.port_log)
    figures = json.load(open(args.ref_json))[args.section]["figures"]
    want = [r for f in FIGS for r in figures[f]]
    if len(got) != len(want):
        print(f"{len(got)} port rows against {len(want)} reference rows")
        return 1
    diffs = 0
    for a, b in zip(got, want):
        b = {key: b[key] for key in a}
        if a != b:
            diffs += 1
            print(f"differs: port {a}\n    reference {b}")
    print(f"{len(got)} rows, {diffs} differ")
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
