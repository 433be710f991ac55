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
                                                  queue capacity
  registry:hit / registry:miss                    grad-bitmap registry
                                                  lookups

PyTorch runs eagerly, so one forward+backward records exactly one step's
events.  The lifecycle scopes become ``torch.profiler.record_function``
ranges under the reference's ``repro:<kind>[:<detail>]:<seq>`` and
``layer:<name>`` names, so a profiler trace carries the same tags; the open
tags are also on a stack (``open_tags``) that the trace audit
(``repro_torch.analysis.trace_audit``) reads for every op it logs, and the
kernel wrappers note each launch's operands and results
(``note_kernel``) for it.

An event decided on the device (a queue overflow on the card, the
optimizer's non-finite skip) is added into a device-resident counter with
no host sync (``record_on_device``, ``record_at_runtime``) and folded into
the counts when they are read: that read is the one sync.

The live-tile ring buffers (``record_live_tiles``) are the measured signal
the autotuner (``kernels/autotune.py``) tunes on, one bounded deque per
autotune key, as in the reference.

Kernel launch counts are not stats keys: each kernel wrapper keeps its own
plain integer (``launches``).

Under ``cfg.remat`` the models checkpoint each encoder layer and decoder
period (``models.common.remat``), whose backward recomputes the forward.
The recomputation runs inside ``remat_scopes``' second context: it counts
nothing again, so a step's count dict is the step's work counted once,
and it replays what the first forward decided (``replayed_call``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
from typing import Dict, List, Optional, Tuple

import torch

_COUNTS: "collections.Counter[str]" = collections.Counter()
# Device-resident counters of ``record_on_device``, by (key, device).
_PENDING: Dict[Tuple[str, torch.device], torch.Tensor] = {}

# Pre-redesign per-GEMM key heads → the normalized family.
_KEY_ALIASES = {"mm": "gemm", "gmm": "gemm", "grouped_mm": "gemm"}


def _normalize(kind: str) -> str:
    head, sep, rest = kind.partition(":")
    return _KEY_ALIASES.get(head, head) + sep + rest


def record(kind: str) -> None:
    """Register one counted event; ``kind`` is ``<how>:<what>``.  Not
    counted in a recomputation (``recomputing``)."""
    if recomputing():
        return
    _COUNTS[_normalize(kind)] += 1


def record_on_device(kind: str, flag: torch.Tensor) -> None:
    """Count the set elements of the boolean or 0/1 tensor ``flag`` under
    ``kind``, on ``flag``'s device and without a host sync; ``counts`` and
    ``total`` fold the sum in when they are read."""
    if recomputing():
        return
    key = (_normalize(kind), flag.device)
    inc = flag.to(torch.int32).sum()
    prev = _PENDING.get(key)
    _PENDING[key] = inc if prev is None else prev.add_(inc)


def _fold() -> None:
    for (kind, _), count in list(_PENDING.items()):
        n = int(count)
        if n:
            _COUNTS[kind] += n
    _PENDING.clear()


def reset() -> None:
    _COUNTS.clear()
    _PENDING.clear()
    _LIVE.clear()


def counts() -> Dict[str, int]:
    _fold()
    return dict(_COUNTS)


def total(what: str = "") -> int:
    """Total computations, optionally filtered by the ``:<what>`` suffix."""
    _fold()
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


def guard_counts() -> Dict[str, int]:
    """The ``guard:*`` family — the runtime guard layer's detection and
    verdict counters."""
    return {k: v for k, v in counts().items() if k.startswith("guard:")}


# Runtime counters stay on the device until the counts are read; this
# switch lets a timing harness leave them out.  Default ON.
_RUNTIME_COUNTING = True


def set_runtime_counting(on: bool) -> bool:
    """Enable/disable ``record_at_runtime``; returns the previous setting
    (restore it in a finally)."""
    global _RUNTIME_COUNTING
    prev, _RUNTIME_COUNTING = _RUNTIME_COUNTING, bool(on)
    return prev


def record_at_runtime(kind: str, flag: torch.Tensor) -> None:
    """Count ``kind`` once when the runtime value of the scalar ``flag`` is
    nonzero — for events that exist only at run time, like the optimizer's
    non-finite skip.  It rides on ``record_on_device``: the flag is added
    into a device-resident counter with no host sync and folded in when the
    counts are read.  A no-op while ``set_runtime_counting(False)`` is in
    effect."""
    if _RUNTIME_COUNTING:
        record_on_device(kind, flag.detach().reshape(()) != 0)


@contextlib.contextmanager
def counting():
    """Scoped counter: resets on entry, yields the live ``counts`` getter."""
    reset()
    yield counts


# ---------------------------------------------------------------------------
# Live-tile telemetry — the measured signal the autotuner tunes on
# ---------------------------------------------------------------------------

LIVE_WINDOW = 128

_LIVE: Dict[str, "collections.deque[Tuple[float, float]]"] = {}


def record_live_tiles(key: str, out_frac: float,
                      operand_frac: float = 1.0) -> None:
    """Append one measured (out, operand) live-tile fraction pair for
    ``key`` (bounded: the newest ``LIVE_WINDOW`` samples are kept).  A
    recomputation's dispatches were sampled in the first forward."""
    if recomputing():
        return
    buf = _LIVE.get(key)
    if buf is None:
        buf = _LIVE[key] = collections.deque(maxlen=LIVE_WINDOW)
    buf.append((float(out_frac), float(operand_frac)))


def live_tile_stats(key: str, window: Optional[int] = None
                    ) -> Tuple[Optional[float], Optional[float], int]:
    """(mean out-live fraction, mean operand-live fraction, n) over the
    trailing ``window`` samples for ``key`` — (None, None, 0) if nothing
    has been observed."""
    buf = _LIVE.get(key)
    if not buf:
        return None, None, 0
    items = list(buf)
    if window is not None:
        items = items[-window:]
    outs = sum(o for o, _ in items) / len(items)
    opnds = sum(p for _, p in items) / len(items)
    return outs, opnds, len(items)


def live_tile_keys() -> list:
    """Keys that have at least one recorded live-tile sample."""
    return [k for k, v in _LIVE.items() if v]


# ---------------------------------------------------------------------------
# Lifecycle scopes — profiler ranges with the reference's tag grammar
# ---------------------------------------------------------------------------

_SCOPE_SEQ = itertools.count()
# The open lifecycle tags, outermost first: what the trace audit
# (``repro_torch.analysis.trace_audit``) reads for every op it logs.  One
# stack for the process, not one a thread: on the card the autograd engine
# runs the backward on its own device thread while the calling thread
# waits, and the tags a backward opens must reach the ops it issues there.
_TAGS: List[str] = []


@contextlib.contextmanager
def lifecycle_scope(kind: str, detail: str = ""):
    """A ``torch.profiler.record_function`` range carrying one bitmap-
    lifecycle event tag, ``repro:<kind>[:<detail>]:<seq>``, which is also
    on ``open_tags()`` while the range is open."""
    parts = ["repro", kind] + ([detail] if detail else []) \
        + [str(next(_SCOPE_SEQ))]
    tag = ":".join(parts)
    _TAGS.append(tag)
    try:
        with torch.profiler.record_function(tag):
            yield
    finally:
        _TAGS.pop()


def open_tags() -> Tuple[str, ...]:
    """The open lifecycle tags, outermost first."""
    return tuple(_TAGS)


# The kernel wrappers launch through ctypes, which PyTorch's dispatcher
# never sees; each notes its operands and results here, so an installed
# hook (the trace audit's) follows the dataflow through the kernel as it
# follows a plain version's aten ops.  None (the default) costs one test.
_KERNEL_HOOK = None


def set_kernel_hook(fn):
    """Install (or, with None, remove) the kernel-launch hook; returns the
    previous one.  The hook receives ``(name, inputs, outputs)``: the
    tensors a launch read and wrote (None entries allowed)."""
    global _KERNEL_HOOK
    prev, _KERNEL_HOOK = _KERNEL_HOOK, fn
    return prev


def note_kernel(name: str, inputs, outputs) -> None:
    """Offer one kernel launch's operands and results to the hook."""
    if _KERNEL_HOOK is not None:
        _KERNEL_HOOK(name, inputs, outputs)


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


# ---------------------------------------------------------------------------
# Rematerialisation — a checkpointed region recomputed in the backward pass
# ---------------------------------------------------------------------------

class _Region:
    """One open pass of a checkpointed region: its first forward, which
    keeps a tape of the decisions it took, or its recomputation, which
    replays that tape from the start."""
    __slots__ = ("tape", "replay", "cursor")

    def __init__(self, tape: list, replay: bool):
        self.tape, self.replay, self.cursor = tape, replay, 0


# The open regions, outermost first.  One stack for the process, as
# ``_TAGS``: the recomputation runs on the autograd engine's thread.
_REGIONS: List[_Region] = []
_RECOMPUTE_HOOK = None


def recomputing() -> bool:
    """Is a recomputation open?  Its events were counted in the first
    forward: ``record``, ``record_on_device``, ``record_at_runtime`` and
    ``record_live_tiles`` count nothing inside it.  Kernel launches and
    ``note_kernel`` go on counting and logging: the recomputed launches
    are work on the card."""
    return any(r.replay for r in _REGIONS)


def remat_scopes(restore=None):
    """The two contexts of one checkpointed region, as
    ``torch.utils.checkpoint``'s ``context_fn`` returns them: the first
    forward's, which tapes each ``replayed_call``; and the
    recomputation's, which replays the tape (so the recomputed forward
    takes the first forward's GEMM specs, routing and hook results,
    whatever the backward pass observed since), counts nothing, opens a
    ``repro:remat:<seq>`` lifecycle tag (the trace audit's log and a
    profiler trace mark the recomputed ops by it) and, inside all that,
    enters ``restore()`` when given (the caller's state of the first
    forward).  Both may be entered again (a second backward pass)."""
    tape: list = []
    return _RegionContext(tape, False), _RegionContext(tape, True, restore)


class _RegionContext:
    def __init__(self, tape: list, replay: bool, restore=None):
        self.tape, self.replay, self.restore = tape, replay, restore
        self._stack = None

    def __enter__(self):
        stack = contextlib.ExitStack()
        if self.replay:
            if self.restore is not None:
                stack.enter_context(self.restore())
            stack.enter_context(lifecycle_scope("remat"))
        _REGIONS.append(_Region(self.tape, self.replay))
        stack.callback(_REGIONS.pop)
        self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        return stack.__exit__(*exc)


def replayed_call(make):
    """``make()`` outside a recomputation, taped by every open first
    forward; in a recomputation the first forward's result, in order,
    without calling ``make`` (a decision that reads or changes state,
    such as an autotune resolution or a test hook)."""
    replaying = next((r for r in _REGIONS if r.replay), None)
    if replaying is None:
        value = make()
    else:
        value = replaying.tape[replaying.cursor]
        replaying.cursor += 1
    for r in _REGIONS:
        if not r.replay:
            r.tape.append(value)
    return value


def set_recompute_hook(fn):
    """Install (or, with None, remove) the recomputation hook; returns the
    previous one.  The hook receives a checkpointed region's inputs as it
    recomputes and returns the inputs it recomputes on (a test seam: a
    fault planted in the recomputation only)."""
    global _RECOMPUTE_HOOK
    prev, _RECOMPUTE_HOOK = _RECOMPUTE_HOOK, fn
    return prev


def recompute_inputs(args: tuple) -> tuple:
    """A region's inputs through the recomputation hook (unchanged outside
    a recomputation or without a hook)."""
    if _RECOMPUTE_HOOK is None or not recomputing():
        return args
    return tuple(_RECOMPUTE_HOOK(args))
