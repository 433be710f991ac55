"""Spec-keyed GEMM autotuner — schedule and tile selection from MEASURED
live-tile stats (the port of ``repro.kernels.autotune``).

  * ``AutotuneKey`` — the cache key: the spec MINUS its schedule (block,
    groups, queue builder) plus the block-padded per-group (M, K, N) when
    the caller's dims are known.
  * ``AutotuneCache`` — per-key decisions ∈ {predicated, compact, dense}
    (+ a granularity-safe block refinement) from the trailing window of
    live-tile fractions that ``kernels/stats.py`` records for every
    ``sparse_gemm`` dispatch, with drift re-evaluation, the quarantine
    ladder (``DEGRADE_LADDER``), suspect tallies for the guard's degrade
    verdict, and a decision log.

Resolution happens inside ``SparsityPolicy.gemm_spec`` when the policy
sets ``autotune=True``; without it ``apply_quarantine`` clamps the static
resolution to the key's quarantine level.

Decision rule (measured out-live fraction o, operand-live fraction p, over
≥ ``min_samples`` recent dispatches):

  o ≤ compact_max_live      → "compact"
  min(o, p) ≥ dense_min_live → "dense"
  otherwise                  → "predicated"

with the tile edges halved (floored to the caller's mask granularity) when
o ≥ ``refine_block_live`` on a masking schedule and the caller passed dims.

Telemetry without a host sync per GEMM.  On the card the dispatcher
computes a dispatch's live-tile counts as device scalars and queues them
here (``defer_observation``); a compact dispatch that may overflow queues
its overflow flag (``defer_overflow``).  ``fold_pending`` brings all of
them to the host in one copy and applies them in dispatch order; the
trainers call it once a step, so live-tile samples from a step are read by
the next step's resolutions (the reference's jitted step likewise keeps
its traced schedule until it is retraced).  A pending overflow flag is
folded before the quarantine is next read, which syncs only after a
capacity-limited dispatch.  On the CPU the dispatcher observes at once.
Under ``cfg.remat`` a recomputed forward feeds no sample and reports no
overflow again, and takes the spec its first forward resolved
(``stats.replayed_call`` in ``SparsityPolicy.gemm_spec``): the decisions
and the log are those of ``remat=False``.

The JSON documents (``export_state``, ``log_rows``) have the reference's
keys and values, so a document written by one package imports into the
other.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Tuple, TYPE_CHECKING

from . import stats
from .shapes import ceil_to

if TYPE_CHECKING:  # avoid the ops → autotune → ops import cycle
    import torch

    from .ops import GemmSpec


# ---------------------------------------------------------------------------
# The cache key: (spec minus schedule, padded shape)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutotuneKey:
    """Everything that identifies a GEMM *request* except how to run it.

    ``padded`` is the block-padded per-group (M, K, N) — the launch shape
    the decision is for — or None when the resolution point does not know
    dims (the linear-path ``gemm_spec(groups=...)`` calls); shapeless keys
    aggregate over every shape that spec serves.

    ``epilogue`` and ``out_dtype`` are deliberately NOT part of the key:
    ``core.sparse_linear._mm`` sets both on the spec AFTER policy
    resolution (``spec.with_``), so keying on them would split the
    observation stream from the resolution stream — and neither changes
    the sparsity signature the decision rule reads."""
    block: Tuple[int, int, int]
    groups: int
    queue_builder: str
    padded: Optional[Tuple[int, int, int]] = None

    @property
    def stats_key(self) -> str:
        """The ``kernels.stats`` ring-buffer key this request's live-tile
        observations are recorded under."""
        shape = "x".join(map(str, self.padded)) if self.padded else "any"
        return ("autotune:" + "x".join(map(str, self.block))
                + f":g{self.groups}:{self.queue_builder}:{shape}")


def key_for(spec: "GemmSpec",
            dims: Optional[Tuple[int, int, int]] = None) -> AutotuneKey:
    """Build the cache key from a spec (its schedule — and the
    post-resolution ``epilogue``/``out_dtype`` fields — are ignored) and
    the per-group GEMM dims, padded to the spec's block."""
    padded = None
    if dims is not None:
        padded = tuple(ceil_to(d, b) for d, b in zip(dims, spec.block))
    return AutotuneKey(
        block=tuple(spec.block), groups=spec.groups,
        queue_builder=spec.queue_builder, padded=padded)


# ---------------------------------------------------------------------------
# Decisions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Decision:
    """One cached selection, plus the measurement it was made from."""
    key: AutotuneKey
    schedule: str
    block: Tuple[int, int, int]
    live_frac: Optional[float]      # mean out-live fraction at decision time
    operand_frac: Optional[float]
    samples: int                    # measured samples behind the decision
    event: str                      # "default" | "measured" | "retune"
                                    # | "demote:<reason>"
    seq: int


# The degradation ladder (docs/resilience.md): "compact" is the most
# machinery-heavy schedule (queue construction every dispatch), "dense" the
# safest.  A quarantined key is clamped to at most the ladder rung its
# demotion level allows — a spec that persistently overflows its queue or
# trips the guard's consistency probes stops paying for the compact path.
DEGRADE_LADDER = ("compact", "predicated", "dense")


def clamp_schedule(schedule: str, level: int) -> str:
    """The schedule actually allowed for a key at demotion ``level``:
    level 0 = anything, 1 = no compact, 2 = dense only."""
    if level <= 0 or schedule not in DEGRADE_LADDER:
        return schedule
    idx = DEGRADE_LADDER.index(schedule)
    return DEGRADE_LADDER[max(idx, min(level, len(DEGRADE_LADDER) - 1))]


def _refined_block(block: Tuple[int, int, int],
                   grans: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Halve each tile edge, floored to its mask-granularity multiple —
    the only block move that keeps caller-derived masks well-formed."""
    out = []
    for b, g in zip(block, grans):
        e = max(1, b // 2)
        out.append(max(g, ceil_to(e, g)))
    return tuple(out)


class AutotuneCache:
    """Per-(spec-minus-schedule, padded shape) schedule/tile decisions from
    measured live-tile stats, with drift re-evaluation and a full decision
    log (the traceability contract)."""

    def __init__(self, *, window: int = 32, min_samples: int = 4,
                 drift_threshold: float = 0.15,
                 compact_max_live: float = 0.5,
                 dense_min_live: float = 0.98,
                 refine_block_live: float = 0.75,
                 overflow_demote_after: int = 8):
        self.window = window
        self.min_samples = min_samples
        self.drift_threshold = drift_threshold
        self.compact_max_live = compact_max_live
        self.dense_min_live = dense_min_live
        self.refine_block_live = refine_block_live
        self.overflow_demote_after = overflow_demote_after
        self.hits = 0
        self.misses = 0
        self.retunes = 0
        self.demotions = 0
        self.log: List[dict] = []
        self._decisions: Dict[AutotuneKey, Decision] = {}
        # key → demotion level on DEGRADE_LADDER (0 = unquarantined) and
        # key → {reason: count} suspicion tallies feeding the guard's
        # degrade verdict (runtime/guards.py).
        self._quarantine: Dict[AutotuneKey, int] = {}
        self._suspects: Dict[AutotuneKey, Dict[str, int]] = {}
        # dispatch signature of a resolved spec → the key that resolved it,
        # so the dispatcher's observation lands in the same buffer the NEXT
        # resolve reads even when the tuned block differs from the key's
        # nominal request.  The signature ignores schedule/epilogue/
        # out_dtype (callers may ``with_`` those after resolution).
        self._spec_keys: Dict[Any, AutotuneKey] = {}
        self._seq = itertools.count()

    @staticmethod
    def _dispatch_sig(spec: "GemmSpec",
                      dims: Optional[Tuple[int, int, int]]) -> tuple:
        padded = None if dims is None else tuple(
            ceil_to(d, b) for d, b in zip(dims, spec.block))
        return (tuple(spec.block), spec.groups, spec.queue_builder, padded)

    # -- observation ----------------------------------------------------

    def observe(self, key: AutotuneKey, out_frac: float,
                operand_frac: float = 1.0) -> None:
        """Record one measured live-tile sample for ``key`` — and for its
        shapeless twin, so no-dims resolutions see shaped traffic too."""
        stats.record_live_tiles(key.stats_key, out_frac, operand_frac)
        if key.padded is not None:
            shapeless = dataclasses.replace(key, padded=None)
            stats.record_live_tiles(shapeless.stats_key, out_frac,
                                    operand_frac)

    def _attributed_key(self, spec: "GemmSpec",
                        dims: Optional[Tuple[int, int, int]]) -> AutotuneKey:
        """The key that resolved ``spec`` (via the dispatch-signature
        reverse map), falling back to a fresh key for specs this cache
        never saw."""
        return self._spec_keys.get(self._dispatch_sig(spec, dims)) \
            or self._spec_keys.get(self._dispatch_sig(spec, None)) \
            or key_for(spec, dims)

    def observe_dispatch(self, spec: "GemmSpec",
                         dims: Tuple[int, int, int], out_frac: float,
                         operand_frac: float = 1.0) -> None:
        """Dispatcher-side entry: attribute a concrete ``sparse_gemm``'s
        measured fractions to the key that resolved ``spec``."""
        self.observe(self._attributed_key(spec, dims), out_frac,
                     operand_frac)

    # -- quarantine: the degradation ladder -----------------------------

    def quarantine_level(self, key: AutotuneKey) -> int:
        """Demotion level for ``key`` — the max of its shaped entry and
        its shapeless twin (a demotion of the spec demotes every shape)."""
        lvl = self._quarantine.get(key, 0)
        if key.padded is not None:
            twin = dataclasses.replace(key, padded=None)
            lvl = max(lvl, self._quarantine.get(twin, 0))
        return lvl

    def report_suspect(self, spec: "GemmSpec",
                       dims: Optional[Tuple[int, int, int]],
                       reason: str) -> AutotuneKey:
        """Tally one piece of evidence against the key that resolved
        ``spec`` (overflow fallback, bitmap-consistency mismatch, kernel-
        sanitizer trip).  The guard's *degrade* verdict demotes the accrued
        suspects; overflow additionally auto-demotes past its threshold."""
        key = self._attributed_key(spec, dims)
        tally = self._suspects.setdefault(key, {})
        tally[reason] = tally.get(reason, 0) + 1
        if reason == "overflow" \
                and tally[reason] >= self.overflow_demote_after \
                and self.quarantine_level(key) < 1:
            self.demote(key, reason="overflow")
        return key

    def suspects(self) -> Dict[AutotuneKey, Dict[str, int]]:
        return {k: dict(v) for k, v in self._suspects.items()}

    def demote(self, key: AutotuneKey, *, reason: str) -> Optional[str]:
        """Push ``key`` one rung down the degradation ladder.  Returns the
        newly-allowed schedule, or None when already at the bottom.  The
        demotion is a first-class decision-log event (``demote:<reason>``)
        so the audit trail shows WHY a spec left the compact schedule."""
        lvl = self._quarantine.get(key, 0)
        if lvl >= len(DEGRADE_LADDER) - 1:
            return None
        lvl += 1
        self._quarantine[key] = lvl
        self.demotions += 1
        stats.record("guard:demote")
        allowed = DEGRADE_LADDER[lvl]
        prev = self._decisions.get(key)
        block = prev.block if prev is not None else key.block
        if prev is not None:
            # Re-clamp the cached decision so subsequent hits replay (and
            # log) the demoted schedule, not the quarantined one.
            prev.schedule = clamp_schedule(prev.schedule, lvl)
        out_frac, op_frac, n = self.measured(key)
        self._append_log(
            Decision(key, allowed, tuple(block), out_frac, op_frac, n,
                     f"demote:{reason}", next(self._seq)),
            f"demote:{reason}")
        return allowed

    def demote_suspects(self, *, reason: str = "guard"
                        ) -> List[AutotuneKey]:
        """The degrade verdict's action: demote every key with accrued
        suspicion one rung; clears the tallies it acted on."""
        demoted = []
        for key in list(self._suspects):
            if self.demote(key, reason=reason) is not None:
                demoted.append(key)
            self._suspects.pop(key, None)
        return demoted

    # -- resolution -----------------------------------------------------

    def measured(self, key: AutotuneKey
                 ) -> Tuple[Optional[float], Optional[float], int]:
        return stats.live_tile_stats(key.stats_key, window=self.window)

    def resolve(self, key: AutotuneKey, default_spec: "GemmSpec", *,
                grans: Tuple[int, int, int] = (1, 1, 1),
                dims: Optional[Tuple[int, int, int]] = None) -> "GemmSpec":
        """The cache lookup: return ``default_spec`` retargeted onto the
        cached (or freshly decided) schedule/block for ``key``."""
        out_frac, op_frac, n = self.measured(key)
        prev = self._decisions.get(key)
        if prev is not None:
            newly_measured = prev.event == "default" \
                and n >= self.min_samples
            drifted = (prev.live_frac is not None and out_frac is not None
                       and abs(out_frac - prev.live_frac)
                       > self.drift_threshold)
            if not (newly_measured or drifted):
                self.hits += 1
                self._append_log(prev, "hit")
                return self._apply(prev, default_spec, key, dims)
            self.retunes += 1
            decision = self._decide(key, default_spec, out_frac, op_frac, n,
                                    grans, dims, event="retune")
        else:
            self.misses += 1
            event = "measured" if n >= self.min_samples else "default"
            decision = self._decide(key, default_spec, out_frac, op_frac, n,
                                    grans, dims, event=event)
        self._decisions[key] = decision
        self._append_log(decision, decision.event)
        return self._apply(decision, default_spec, key, dims)

    def _decide(self, key, default_spec, out_frac, op_frac, n, grans, dims,
                *, event: str) -> Decision:
        lvl = self.quarantine_level(key)
        if n < self.min_samples or out_frac is None:
            # Not enough measurement yet: the static policy resolution
            # stands, recorded as an explicit (traceable) default.
            return Decision(key,
                            clamp_schedule(default_spec.schedule, lvl),
                            tuple(default_spec.block), out_frac, op_frac, n,
                            "default", next(self._seq))
        if out_frac <= self.compact_max_live:
            schedule = "compact"
        elif min(out_frac, op_frac if op_frac is not None else 1.0) \
                >= self.dense_min_live:
            schedule = "dense"
        else:
            schedule = "predicated"
        schedule = clamp_schedule(schedule, lvl)
        block = tuple(default_spec.block)
        if schedule != "dense" and dims is not None \
                and out_frac >= self.refine_block_live:
            block = _refined_block(block, grans)
        return Decision(key, schedule, block, out_frac, op_frac, n, event,
                        next(self._seq))

    def _apply(self, decision: Decision, default_spec: "GemmSpec",
               key: AutotuneKey,
               dims: Optional[Tuple[int, int, int]]) -> "GemmSpec":
        # Defensive re-clamp: a demotion may postdate the cached decision.
        schedule = clamp_schedule(decision.schedule,
                                  self.quarantine_level(key))
        spec = default_spec.with_(schedule=schedule, block=decision.block)
        self._spec_keys[self._dispatch_sig(spec, dims)] = key
        return spec

    def _append_log(self, decision: Decision, event: str) -> None:
        self.log.append({
            "seq": decision.seq,
            "event": event,
            "key": decision.key.stats_key,
            "shape": "x".join(map(str, decision.key.padded))
            if decision.key.padded else "any",
            "groups": decision.key.groups,
            "schedule": decision.schedule,
            "block": "x".join(map(str, decision.block)),
            "live_frac": None if decision.live_frac is None
            else round(decision.live_frac, 4),
            "operand_frac": None if decision.operand_frac is None
            else round(decision.operand_frac, 4),
            "samples": decision.samples,
        })

    def decisions(self) -> Dict[AutotuneKey, Decision]:
        return dict(self._decisions)

    # -- persistence (checkpoint state.json) ----------------------------

    def export_state(self, *, log_tail: int = 256) -> dict:
        """JSON-able snapshot of the cache: decisions, quarantine levels,
        suspect tallies, counters and the decision-log tail — what a
        crash-safe resume needs so schedules don't cold-start
        (checkpoint/checkpoint.py ``state.json``)."""
        return {
            "decisions": [
                {"key": _key_doc(d.key), "schedule": d.schedule,
                 "block": list(d.block), "live_frac": d.live_frac,
                 "operand_frac": d.operand_frac, "samples": d.samples,
                 "event": d.event, "seq": d.seq}
                for d in self._decisions.values()],
            "quarantine": [
                {"key": _key_doc(k), "level": lvl}
                for k, lvl in self._quarantine.items()],
            "suspects": [
                {"key": _key_doc(k), "tally": dict(t)}
                for k, t in self._suspects.items()],
            "counters": {"hits": self.hits, "misses": self.misses,
                         "retunes": self.retunes,
                         "demotions": self.demotions},
            "log": self.log[-log_tail:],
        }

    def import_state(self, doc: dict) -> None:
        """Rehydrate a snapshot produced by ``export_state`` — resumed
        training re-enters with warm schedules and an intact quarantine."""
        max_seq = -1
        for d in doc.get("decisions", []):
            key = _key_from_doc(d["key"])
            dec = Decision(key, d["schedule"], tuple(d["block"]),
                           d["live_frac"], d["operand_frac"], d["samples"],
                           d["event"], d["seq"])
            self._decisions[key] = dec
            max_seq = max(max_seq, d["seq"])
        for q in doc.get("quarantine", []):
            key = _key_from_doc(q["key"])
            self._quarantine[key] = max(self._quarantine.get(key, 0),
                                        int(q["level"]))
        for s in doc.get("suspects", []):
            key = _key_from_doc(s["key"])
            tally = self._suspects.setdefault(key, {})
            for reason, n in s["tally"].items():
                tally[reason] = tally.get(reason, 0) + int(n)
        c = doc.get("counters", {})
        self.hits += c.get("hits", 0)
        self.misses += c.get("misses", 0)
        self.retunes += c.get("retunes", 0)
        self.demotions += c.get("demotions", 0)
        for row in doc.get("log", []):
            max_seq = max(max_seq, row.get("seq", -1))
        self.log.extend(doc.get("log", []))
        self._seq = itertools.count(max_seq + 1)


def _key_doc(key: AutotuneKey) -> dict:
    return {"block": list(key.block), "groups": key.groups,
            "queue_builder": key.queue_builder,
            "padded": None if key.padded is None else list(key.padded)}


def _key_from_doc(d: dict) -> AutotuneKey:
    return AutotuneKey(
        block=tuple(d["block"]), groups=int(d["groups"]),
        queue_builder=d["queue_builder"],
        padded=None if d["padded"] is None else tuple(d["padded"]))


# ---------------------------------------------------------------------------
# The process-global cache (mirrors the stats counters' lifetime)
# ---------------------------------------------------------------------------

_CACHE = AutotuneCache()

# Dispatch events decided on the device, in dispatch order, awaiting
# ``fold_pending``: ("live", key, out, operands) with out/operands as
# (count tensor, numel) pairs, or ("overflow", spec, dims, flag tensor).
_PENDING: List[tuple] = []
_PENDING_OVERFLOWS = 0


def get_cache() -> AutotuneCache:
    _fold_overflows()
    return _CACHE


def reset(**cache_kwargs) -> AutotuneCache:
    """Fresh global cache (optionally with non-default thresholds); the
    live-tile buffers in ``kernels.stats`` are cleared separately by
    ``stats.reset()``.  Pending device events are dropped."""
    global _CACHE, _PENDING_OVERFLOWS
    _CACHE = AutotuneCache(**cache_kwargs)
    _PENDING.clear()
    _PENDING_OVERFLOWS = 0
    return _CACHE


def resolve(default_spec: "GemmSpec", *,
            dims: Optional[Tuple[int, int, int]] = None,
            grans: Tuple[int, int, int] = (1, 1, 1)) -> "GemmSpec":
    """Module-level resolution entry used by ``SparsityPolicy.gemm_spec``."""
    _fold_overflows()
    key = key_for(default_spec, dims)
    return _CACHE.resolve(key, default_spec, grans=grans, dims=dims)


def observe_dispatch(spec: "GemmSpec", dims: Tuple[int, int, int],
                     out_frac: float, operand_frac: float = 1.0) -> None:
    """Dispatcher hook (``kernels.ops.sparse_gemm``), host fractions."""
    _CACHE.observe_dispatch(spec, dims, out_frac, operand_frac)


def tracked_key(spec: "GemmSpec", dims: Tuple[int, int, int]
                ) -> Optional[AutotuneKey]:
    """The key that resolved ``spec`` for these dims, when a resolution or
    a quarantine clamp of this cache produced it; None for a spec that
    only the static policy resolved."""
    c = _CACHE
    if not c._spec_keys:
        return None
    return c._spec_keys.get(c._dispatch_sig(spec, dims)) \
        or c._spec_keys.get(c._dispatch_sig(spec, None))


def defer_observation(key: AutotuneKey,
                      out: Optional[Tuple["torch.Tensor", int]],
                      operands: List[Tuple["torch.Tensor", int]]) -> None:
    """Queue one dispatch's live-tile counts, device scalars with the
    numel they divide, for ``fold_pending`` (no host sync)."""
    _PENDING.append(("live", key, out, operands))


def defer_overflow(spec: "GemmSpec", dims: Tuple[int, int, int],
                   flag: "torch.Tensor") -> None:
    """Queue a capacity-limited compact dispatch's device overflow flag; it
    is folded (``report_overflow`` when set) before the quarantine is next
    read."""
    global _PENDING_OVERFLOWS
    _PENDING.append(("overflow", spec, dims, flag))
    _PENDING_OVERFLOWS += 1


def fold_pending() -> int:
    """Bring every pending device event to the host in one copy and apply
    it in dispatch order — a live-tile sample to its key, a set overflow
    flag as ``report_overflow``.  The trainers call this once a step.
    Returns the number of events folded (0: nothing pending, no sync)."""
    global _PENDING_OVERFLOWS
    if not _PENDING:
        return 0
    import torch
    scalars = []
    for ev in _PENDING:
        if ev[0] == "live":
            _, _, out, operands = ev
            scalars += [t for t, _ in ([out] if out else []) + operands]
        else:
            scalars.append(ev[3])
    vals = iter(torch.stack([t.reshape(()).to(torch.float64)
                             for t in scalars]).tolist()) if scalars \
        else iter(())
    events, n = list(_PENDING), len(_PENDING)
    _PENDING.clear()
    _PENDING_OVERFLOWS = 0
    for ev in events:
        if ev[0] == "live":
            _, key, out, operands = ev

            def frac(numel):
                v = next(vals)
                return v / numel if numel else 1.0

            out_frac = frac(out[1]) if out else 1.0
            op = [frac(numel) for _, numel in operands]
            _CACHE.observe(key, out_frac, min(op) if op else 1.0)
        else:
            _, spec, dims, _ = ev
            if next(vals):
                report_overflow(spec, dims)
    return n


def _fold_overflows() -> None:
    if _PENDING_OVERFLOWS:
        fold_pending()


def report_overflow(spec: "GemmSpec",
                    dims: Optional[Tuple[int, int, int]] = None) -> None:
    """Dispatcher hook: one compact dispatch overflowed its queue and fell
    back to the predicated schedule.  Past ``overflow_demote_after``
    occurrences the key is auto-demoted off the compact schedule."""
    _CACHE.report_suspect(spec, dims, "overflow")


def apply_quarantine(spec: "GemmSpec", *,
                     dims: Optional[Tuple[int, int, int]] = None
                     ) -> "GemmSpec":
    """Clamp a statically-resolved spec to its key's quarantine level —
    the non-autotune resolution path's view of the degradation ladder."""
    _fold_overflows()
    if not _CACHE._quarantine:      # nothing demoted: the identity
        return spec
    key = key_for(spec, dims)
    lvl = _CACHE.quarantine_level(key)
    clamped = clamp_schedule(spec.schedule, lvl)
    if clamped != spec.schedule:
        stats.record("guard:quarantine_clamp")
        spec = spec.with_(schedule=clamped)
        # Keep dispatch→key attribution intact for the clamped spec so
        # subsequent observations and overflow reports land on this key.
        _CACHE._spec_keys[_CACHE._dispatch_sig(spec, dims)] = key
    return spec


def export_state() -> dict:
    """Snapshot of the global cache for checkpoint persistence."""
    _fold_overflows()
    return _CACHE.export_state()


def import_state(doc: dict) -> None:
    """Rehydrate the global cache from a checkpoint ``state.json``."""
    _CACHE.import_state(doc)


def log_rows() -> List[dict]:
    """The decision log — one row per resolve event, audit-table ready."""
    _fold_overflows()
    return list(_CACHE.log)
