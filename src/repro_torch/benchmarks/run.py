"""Run the paper's tables on the port (the twin of the reference's
``benchmarks/run.py``): prints one ``name,us_total,derived`` line per table
and writes each table's rows to ``<out>/<name>.csv``.

  python -m repro_torch.benchmarks.run [--device cuda|cpu]
      [--geometry reference|full] [--out DIR] [table ...]

``--geometry reference`` captures traces as the reference does (3 dense
steps at 32², width 0.25, 100 classes); ``--geometry full`` captures at
the paper's geometry (224², width 1.0, 1000 classes, batch 8, 3 steps at
lr 0.01 under ``IN_OUT_WR`` through the kernels).  The cost model's
outputs are modeled counts of the paper's accelerator (Table 1, 667 MHz).
``us_total`` is the whole table's wall time on the host, captures
included.  No table names runs every table, keeping going past an error;
named tables fail the run on an error.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
import time
import traceback

from repro_torch.device import resolve_device

from .common import GEOMETRIES
from .figures import ALL_FIGURES
from .kernel_audit import (bitmap_op_audit, contract_audit, depthwise_audit,
                           kernel_audit, launch_shape_audit, queue_cost_audit)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS_DIR = os.path.join(_ROOT, "build", "benchmark_results")

HEADER = "name,us_total,derived"

TABLES = dict(ALL_FIGURES)
TABLES.update({
    "kernel_audit": kernel_audit,
    "bitmap_op_audit": bitmap_op_audit,
    "queue_cost_audit": queue_cost_audit,
    "launch_shape_audit": launch_shape_audit,
    "depthwise_audit": depthwise_audit,
    "contract_audit": contract_audit,
})


def write_rows(path: str, rows) -> None:
    """Persist one table's rows as CSV, over the union of the rows' keys in
    first-seen order (blank where a row lacks one)."""
    fieldnames = []
    for r in rows:
        for k in r.keys():
            if k not in fieldnames:
                fieldnames.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--geometry", default="reference",
                    choices=sorted(GEOMETRIES))
    ap.add_argument("--out", default=None,
                    help=f"CSV directory (default {RESULTS_DIR}/<geometry>)")
    ap.add_argument("tables", nargs="*", metavar="table",
                    help=f"tables to run (default all): {sorted(TABLES)}")
    args = ap.parse_args(argv)
    unknown = [n for n in args.tables if n not in TABLES]
    if unknown:
        ap.error(f"unknown tables {unknown}; have {sorted(TABLES)}")
    resolve_device(args.device)            # no CUDA device: raise, no fallback
    cap = dataclasses.replace(GEOMETRIES[args.geometry], device=args.device)
    benches = {n: TABLES[n] for n in args.tables} if args.tables else TABLES
    out_dir = args.out or os.path.join(RESULTS_DIR, args.geometry)
    os.makedirs(out_dir, exist_ok=True)

    failed = []
    print(HEADER, flush=True)
    for name, fn in benches.items():
        t0 = time.time()
        try:
            rows, derived = fn(cap)
        except Exception as e:  # keep the sweep going; report the failure
            traceback.print_exc()
            print(f"{name},ERROR,{e!r}", flush=True)
            failed.append(name)
            continue
        us = (time.time() - t0) * 1e6
        if rows:
            write_rows(os.path.join(out_dir, f"{name}.csv"), rows)
        print(f"{name},{us:.0f},{derived}", flush=True)
    # Named tables are gates: an error fails the run.
    return 1 if args.tables and failed else 0


if __name__ == "__main__":
    sys.exit(main())
