"""The bitmap-contract verifier — the port of ``repro.analysis``.

Three checkers:

  * ``trace_audit``      — lifecycle audit of one executed training step
  * ``kernel_sanitizer`` — guard bands, poison and the shadow build's store
                           counts around every CUDA kernel
  * ``lint``             — AST rules pinning the spec-driven GEMM API

``python -m repro_torch.analysis --fail-on-violation`` runs all three;
``repro_torch.benchmarks.kernel_audit.contract_audit`` renders the same
rows as a table.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from .kernel_sanitizer import plant, sanitize_all, sweep
from .lint import lint_paths, lint_source
from .report import Violation, format_table, to_csv, to_json
from .trace_audit import (
    WORKLOADS,
    audit_fn,
    audit_trace,
    audit_workloads,
    trace_fn,
)

__all__ = [
    "Violation",
    "WORKLOADS",
    "audit_fn",
    "audit_trace",
    "audit_workloads",
    "format_table",
    "lint_paths",
    "lint_source",
    "plant",
    "sanitize_all",
    "sweep",
    "to_csv",
    "to_json",
    "trace_fn",
]
