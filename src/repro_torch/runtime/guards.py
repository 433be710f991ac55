"""StepGuard — per-step health folded into a verdict, and the degradation
ladder that acts on it (the port of ``repro.runtime.guards``).

Signals folded per step:

  * non-finite loss / grad-norm / the optimizer's ``skipped`` flag (the
    fp16-overflow guard in ``optim.adamw_update``),
  * counter deltas from the kernel layer — ``fallback:queue_overflow``
    (compact queue overflows) and ``registry:miss`` (grad-bitmap hand-offs
    that never arrived),
  * on demand, an emitted-bitmap/value consistency probe (``probe_emit``).

Verdict ladder (each verdict is counted under ``guard:verdict:<v>``):

  ok        step was healthy; cooldown toward forgetting past rollbacks.
  skip      non-finite step, within the consecutive-skip budget — the
            optimizer already dropped the update (master weights regenerate
            the params), nothing else to do.
  rollback  the skip budget is exhausted: corruption persists across steps
            (it lives in optimizer/master state, not in one bad batch).
            The train loop restores the newest intact checkpoint.  Each
            rollback doubles the clean-step cooldown before the rollback
            counter resets (backoff).
  degrade   rollbacks are not converging either: demote every suspect
            ``AutotuneKey`` one rung down the degradation ladder
            (compact → predicated → dense, ``kernels/autotune.py``) — the
            assumption-heavy schedules are retired before numerics are.

The guard is HOST-side and opt-in: ``train_loop(guard=...)`` syncs the
small metric scalars each step only when a guard is installed; unguarded
runs read no metric per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import autotune, stats

VERDICTS = ("ok", "skip", "rollback", "degrade")

# Raw counter families the guard scans for deltas between steps.
_SCANNED_COUNTERS = ("fallback:queue_overflow", "registry:miss")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    max_consecutive_skips: int = 3   # non-finite steps tolerated in a row
                                     # before escalating to rollback
    rollback_backoff: int = 8        # clean steps after a rollback before
                                     # the hot-rollback counter cools;
                                     # doubles with each further rollback
    max_rollbacks: int = 2           # hot rollbacks before the next
                                     # escalation becomes degrade
    registry_miss_budget: int = 0    # registry misses per scan ABOVE the
                                     # caller's expected count (the loss
                                     # cotangent's structural miss) before
                                     # guard:registry_miss fires
    history: int = 1024              # verdict history kept for inspection


class StepGuard:
    """Folds per-step health into ``ok | skip | rollback | degrade``.

    State machine: consecutive non-finite steps consume the skip budget;
    exhausting it escalates to rollback (the loop restores a checkpoint and
    the budget restarts); ``max_rollbacks`` rollbacks without an intervening
    cooldown of clean steps escalate to degrade (suspect specs are demoted
    down the schedule ladder).  Clean steps cool the machine back down.
    """

    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig()
        self.verdicts: List[Tuple[int, str]] = []
        self._consecutive_skips = 0
        self._rollbacks_hot = 0
        self._cooldown = 0
        self._counter_base: Dict[str, int] = {}

    # -- per-step fold ---------------------------------------------------

    def observe_step(self, step: int, *, loss: Optional[float] = None,
                     grad_norm: Optional[float] = None,
                     skipped: Optional[float] = None) -> str:
        """One training step's health → verdict.  ``skipped`` is the
        optimizer's non-finite-skip flag (nonzero = the update was
        dropped); loss/grad_norm are host floats, either may be None."""
        cfg = self.config
        nonfinite = bool(skipped) \
            or (loss is not None and not math.isfinite(loss)) \
            or (grad_norm is not None and not math.isfinite(grad_norm))
        if nonfinite:
            self._consecutive_skips += 1
            if self._consecutive_skips <= cfg.max_consecutive_skips:
                verdict = "skip"
            elif self._rollbacks_hot >= cfg.max_rollbacks:
                verdict = "degrade"
            else:
                verdict = "rollback"
        else:
            verdict = "ok"
            self._consecutive_skips = 0
            if self._cooldown > 0:
                self._cooldown -= 1
                if self._cooldown == 0:
                    self._rollbacks_hot = 0
        if verdict == "rollback":
            self._rollbacks_hot += 1
            self._consecutive_skips = 0       # budget restarts post-restore
            self._cooldown = cfg.rollback_backoff * 2 ** (
                self._rollbacks_hot - 1)
        elif verdict == "degrade":
            self._consecutive_skips = 0
        stats.record("guard:verdict:" + verdict)
        self.verdicts.append((int(step), verdict))
        if len(self.verdicts) > cfg.history:
            del self.verdicts[:-cfg.history]
        return verdict

    # -- counter scanning ------------------------------------------------

    def scan_counters(self, *, expected_registry_misses: int = 0
                      ) -> Dict[str, int]:
        """Deltas of the guard-relevant raw counters since the last scan.

        ``expected_registry_misses`` is the caller's structural baseline
        (e.g. one loss-cotangent miss per backward in the scanned span);
        misses beyond it plus the configured budget count as a detection
        (``guard:registry_miss``) — the registry-drop fault class."""
        now = stats.counts()
        deltas: Dict[str, int] = {}
        for key in _SCANNED_COUNTERS:
            cur = now.get(key, 0)
            deltas[key] = cur - self._counter_base.get(key, 0)
            self._counter_base[key] = cur
        excess = deltas.get("registry:miss", 0) \
            - expected_registry_misses - self.config.registry_miss_budget
        if excess > 0:
            stats.record("guard:registry_miss")
        return deltas

    # -- bitmap consistency probe ----------------------------------------

    def probe_emit(self, out, bits, gran: Tuple[int, int], *,
                   spec=None, dims=None):
        """Check an emitted (output, bitmap) pair for consistency: the
        bitmap must equal a fresh any-nonzero scan of ``out`` at ``gran``.

        A mismatch (bit flips in transit, a writeback that lied) records
        ``guard:bitmap_mismatch`` and — when the producing ``spec`` is
        given — tallies it as a suspect with the autotuner, feeding the
        degrade verdict.  Returns ``(ok, corrected_bits)``: consumers can
        continue with the rescanned (trusted) bitmap, so a flipped bit
        degrades to extra/lost skipping, never to wrong numerics."""
        ref = reference_bitmap(_host(out), gran)
        got = _host(bits)
        ok = got.shape == ref.shape and bool(np.array_equal(ref, got))
        if not ok:
            stats.record("guard:bitmap_mismatch")
            if spec is not None:
                autotune.get_cache().report_suspect(spec, dims, "bitmap")
        if isinstance(bits, torch.Tensor):
            return ok, torch.as_tensor(ref, dtype=bits.dtype,
                                       device=bits.device)
        return ok, ref.astype(got.dtype)

    # -- the degrade action ----------------------------------------------

    def degrade(self, *, reason: str = "guard"):
        """Demote every suspect key one rung down the degradation ladder;
        returns the demoted keys (``AutotuneCache.demote_suspects``)."""
        return autotune.get_cache().demote_suspects(reason=reason)

    # -- persistence (checkpoint state.json) ------------------------------

    def export_state(self) -> dict:
        return {
            "consecutive_skips": self._consecutive_skips,
            "rollbacks_hot": self._rollbacks_hot,
            "cooldown": self._cooldown,
            "counter_base": dict(self._counter_base),
            "verdicts": [[s, v] for s, v in self.verdicts[-64:]],
        }

    def import_state(self, doc: dict) -> None:
        self._consecutive_skips = int(doc.get("consecutive_skips", 0))
        self._rollbacks_hot = int(doc.get("rollbacks_hot", 0))
        self._cooldown = int(doc.get("cooldown", 0))
        self._counter_base = {k: int(v) for k, v in
                              doc.get("counter_base", {}).items()}
        self.verdicts = [(int(s), str(v))
                         for s, v in doc.get("verdicts", [])]


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def reference_bitmap(out: np.ndarray, gran: Tuple[int, int]) -> np.ndarray:
    """Ground-truth any-nonzero tile bitmap of a (possibly grouped) output
    at granularity ``gran`` — the probe's oracle, matching the unpadding
    contract of ``sparse_gemm``'s emit path (padding tiles are dead)."""
    er, ec = gran
    arr = np.asarray(out)
    if arr.ndim == 2:
        return reference_bitmap(arr[None], gran)[0]
    if arr.ndim != 3:
        raise ValueError(f"expected 2-D or 3-D output, got {arr.shape}")
    g, m, n = arr.shape
    mt, nt = -(-m // er), -(-n // ec)
    padded = np.zeros((g, mt * er, nt * ec), dtype=arr.dtype)
    padded[:, :m, :n] = arr
    tiles = padded.reshape(g, mt, er, nt, ec)
    return (np.abs(tiles).max(axis=(2, 4)) > 0).astype(np.int32)
