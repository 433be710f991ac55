"""Violation records shared by the three checkers (trace / kernel / lint); the
port of ``repro.analysis.report``.

One flat record type so the CLI, the CI artifact (CSV/JSON) and the
``repro_torch.benchmarks.kernel_audit.contract_audit`` table all consume
the same rows.  The code catalogue is in README.md (the port's section);
each checker owns a disjoint code namespace so a report line is
self-identifying.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
from typing import Iterable, List


@dataclasses.dataclass(frozen=True)
class Violation:
    checker: str          # "trace" | "kernel" | "lint"
    code: str             # e.g. "RESCAN", "DOUBLE_WRITE", "LOOSE_KWARG"
    where: str            # layer name / kernel+tile / file:line
    message: str          # human-readable, one line
    workload: str = ""    # the traced workload / sanitized launch, if any

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


FIELDS = [f.name for f in dataclasses.fields(Violation)]


def to_json(violations: Iterable[Violation]) -> str:
    return json.dumps([v.as_row() for v in violations], indent=2)


def to_csv(violations: Iterable[Violation]) -> str:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=FIELDS)
    w.writeheader()
    for v in violations:
        w.writerow(v.as_row())
    return buf.getvalue()


def format_table(violations: List[Violation], title: str = "violations") -> str:
    """Fixed-width text table (the CLI / benchmark rendering)."""
    if not violations:
        return f"{title}: NONE"
    rows = [FIELDS] + [[str(getattr(v, f)) for f in FIELDS]
                       for v in violations]
    widths = [max(len(r[i]) for r in rows) for i in range(len(FIELDS))]
    lines = [f"{title}: {len(violations)}"]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return "\n".join(lines)
