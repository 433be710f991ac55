"""CLI entry point: ``python -m repro_torch.analysis [--fail-on-violation]``.

Runs the full verifier — the lifecycle audit over the standard workloads,
the kernel sanitizer sweep, and the lint of the port's source — and prints
one combined violation table.  ``--json`` / ``--csv`` write the same rows
as artifacts; ``--fail-on-violation`` makes any row exit 1.  The audit and
the sweep run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from . import kernel_sanitizer, lint, report, trace_audit

# What lint sweeps: the port's package (its benchmarks/ included).  The
# tests and chip_smoke.py are oracles and stay out, as the reference keeps
# tests/ out.
LINT_ROOTS = ("src/repro_torch",)


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="bitmap-contract verifier (trace + kernel + lint)")
    ap.add_argument("--fail-on-violation", action="store_true",
                    help="exit 1 if any checker reports a violation")
    ap.add_argument("--workloads", nargs="*", default=None,
                    metavar="NAME",
                    help=f"audited workloads (default: all of "
                         f"{sorted(trace_audit.WORKLOADS)})")
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["trace", "kernel", "lint"],
                    help="checkers to skip")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the violation rows as JSON")
    ap.add_argument("--csv", metavar="PATH", default=None,
                    help="write the violation rows as CSV")
    ap.add_argument("--device", default="cuda",
                    help="where the audit and the sweep run (default cuda; "
                         "cpu runs the plain versions)")
    args = ap.parse_args(argv)

    violations = []
    for name, run in [
        ("trace", lambda: trace_audit.audit_workloads(args.workloads,
                                                       device=args.device)),
        ("kernel", lambda: kernel_sanitizer.sanitize_all(args.device)),
        ("lint", lambda: lint.lint_paths(
            [p for r in LINT_ROOTS
             if os.path.isdir(p := os.path.join(_repo_root(), r))])),
    ]:
        if name in args.skip:
            print(f"[analysis] {name}: skipped")
            continue
        t0 = time.time()
        vs = run()
        violations += vs
        print(f"[analysis] {name}: {len(vs)} violation(s) "
              f"({time.time() - t0:.1f}s)")

    print()
    print(report.format_table(violations, title="contract violations"))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(report.to_json(violations))
    if args.csv:
        with open(args.csv, "w", encoding="utf-8") as f:
            f.write(report.to_csv(violations))
    if violations and args.fail_on_violation:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
