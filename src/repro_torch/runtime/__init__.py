"""Guarded execution (the port of ``repro.runtime``): per-step health
verdicts with a skip → rollback → degrade ladder (``runtime.guards``), and
the seeded fault injection and chaos matrix (``runtime.faults``)."""
from .guards import GuardConfig, StepGuard, VERDICTS  # noqa: F401
