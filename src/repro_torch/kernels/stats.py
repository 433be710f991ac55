"""Bitmap-op instrumentation: the port of ``repro.kernels.stats``.

Counts how many times per step sparsity metadata is *computed* (a fused
encode or a scan over tensor-sized data), how many work queues are built,
and how many GEMMs are dispatched — with the reference's keys, string for
string, so a test can compare the two packages' count dicts directly:

  encode:act / scan:<what> / scan_pallas:<what>   bitmap computations
  queue:<builder>                                 work-queue constructions
  gemm:<schedule>:<g>                             one per sparse_gemm
                                                  dispatch
  emit:grad                                       bitmaps emitted by a GEMM
                                                  epilogue
  fallback:queue_overflow                         compact dispatches whose
                                                  live count exceeded the
                                                  queue capacity, counted
                                                  only where that count is
                                                  already on the host
  registry:hit / registry:miss                    grad-bitmap registry
                                                  lookups

PyTorch runs eagerly, so one forward+backward records exactly one step's
events.  The lifecycle scopes become ``torch.profiler.record_function``
ranges under the reference's ``repro:<kind>[:<detail>]:<seq>`` and
``layer:<name>`` names, so a profiler trace carries the same tags.

Kernel launch counts are not stats keys: each kernel wrapper keeps its own
plain integer (``launches``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Dict, List, Optional

import torch

_COUNTS: "collections.Counter[str]" = collections.Counter()

# Pre-redesign per-GEMM key heads → the normalized family.
_KEY_ALIASES = {"mm": "gemm", "gmm": "gemm", "grouped_mm": "gemm"}


def _normalize(kind: str) -> str:
    head, sep, rest = kind.partition(":")
    return _KEY_ALIASES.get(head, head) + sep + rest


def record(kind: str) -> None:
    """Register one counted event; ``kind`` is ``<how>:<what>``."""
    _COUNTS[_normalize(kind)] += 1


def reset() -> None:
    _COUNTS.clear()


def counts() -> Dict[str, int]:
    return dict(_COUNTS)


def total(what: str = "") -> int:
    """Total computations, optionally filtered by the ``:<what>`` suffix."""
    return sum(v for k, v in _COUNTS.items()
               if not what or k.endswith(":" + what))


def queue_builds(builder: str = "") -> int:
    """Work-queue constructions, optionally for one builder backend."""
    return sum(v for k, v in _COUNTS.items()
               if k.startswith("queue:")
               and (not builder or k == "queue:" + builder))


def gemm_launches(schedule: str = "", groups: Optional[int] = None) -> int:
    """GEMM dispatches (``gemm:<schedule>:<g>``), optionally filtered by
    schedule and/or group count."""
    n = 0
    for k, v in _COUNTS.items():
        if not k.startswith("gemm:"):
            continue
        _, _, tail = k.partition(":")
        sched, _, g = tail.partition(":")
        if schedule and sched != schedule:
            continue
        if groups is not None and (not g.isdigit() or int(g) != groups):
            continue
        n += v
    return n


# ---------------------------------------------------------------------------
# Lifecycle scopes — profiler ranges with the reference's tag grammar
# ---------------------------------------------------------------------------

_SCOPE_SEQ = itertools.count()


def lifecycle_scope(kind: str, detail: str = ""):
    """A ``torch.profiler.record_function`` range carrying one bitmap-
    lifecycle event tag, ``repro:<kind>[:<detail>]:<seq>``."""
    parts = ["repro", kind] + ([detail] if detail else []) \
        + [str(next(_SCOPE_SEQ))]
    return torch.profiler.record_function(":".join(parts))


_LAYERS: List[str] = []


@contextlib.contextmanager
def layer_scope(name: Optional[str]):
    """A profiler range keying everything under it to one model layer
    (nothing for ``None``).  The autograd Functions read the layer with
    ``current_layer`` in their forward and reopen its range around their
    backward, so a trace keys both passes of a layer to one name."""
    if name is None:
        yield
        return
    _LAYERS.append(name)
    try:
        with torch.profiler.record_function(f"layer:{name}"):
            yield
    finally:
        _LAYERS.pop()


def current_layer() -> Optional[str]:
    """The innermost open ``layer_scope``, or None."""
    return _LAYERS[-1] if _LAYERS else None
