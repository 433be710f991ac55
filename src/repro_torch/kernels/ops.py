"""The spec-driven masked-GEMM entry point and the bitmap encoder — the port
of ``repro.kernels.ops``.

``sparse_gemm(a, b, masks, spec)`` is THE masked-GEMM entry point:

  * ``GemmSpec`` is a frozen request object — tile shape, group count,
    schedule ∈ {predicated, compact, dense}, a tuple of epilogue stages
    ⊆ {sigma_prime, bitmap_emit}, queue builder, queue capacity, output
    dtype;
  * ``GemmMasks`` carries the (out, a, b) block bitmaps; ``None`` on a slot
    means dense on that axis pair;
  * the dispatcher owns the queue / overflow-fallback contract in one place;
    2-D operands are lowered as the G=1 case of the grouped engine.

What differs from the reference on the card: the kernels bounds-check
M/K/N and write tiles straight to their place, so there is no padding of
operands and no scatter; the compact path's overflow fallback is decided on
the device (both launches read ``n_live``; one of them exits) instead of by
``lax.cond``, and ``fallback:queue_overflow`` is added on the device into a
counter of ``stats`` that is folded in when the counts are read (no host
sync per GEMM).  The ``dense`` schedule is plain torch, as it is XLA (not
Pallas) in the reference.  Operands may be float32 or bfloat16; every
schedule accumulates in float32 and casts to ``spec.out_dtype`` at the end.

Every dispatch is counted under ``gemm:<schedule>:<g>`` (plus ``emit:grad``
per emitted bitmap) and offers its live-tile fractions to the autotuner
(``_observe_live_tiles``).  The fault-injection tamper hook
(``set_tamper_hook``) sees the spec (``gemm:spec``) and the emitted bits
(``gemm:emit_bits``) of every dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from . import autotune, masked_matmul, ref, stats
from . import bitmap_scan as _bitmap_scan
from . import relu_encode as _relu_encode
from .queue_builder import build_queue
from .shapes import block_bitmap, grid_shape, pad_mask3

DEFAULT_BLOCK = (128, 128, 128)

SCHEDULES = ("predicated", "compact", "dense")
# Composable epilogue stages, in canonical application order: the σ′
# Hadamard first, then bitmap emission over the POST-σ′ values.
EPILOGUE_STAGES = ("sigma_prime", "bitmap_emit")


def normalize_epilogue(epilogue) -> Tuple[str, ...]:
    """Canonicalize an epilogue declaration to a stage tuple (legacy strings
    ``"none"``/``"sigma_prime"``, ``None``, or an iterable of stages)."""
    if epilogue is None or epilogue == "none" or epilogue == ():
        return ()
    stages = (epilogue,) if isinstance(epilogue, str) else tuple(epilogue)
    bad = [s for s in stages if s not in EPILOGUE_STAGES]
    if bad or len(set(stages)) != len(stages):
        raise ValueError(
            f"epilogue stages must be unique and drawn from "
            f"{EPILOGUE_STAGES}, got {epilogue!r}")
    return tuple(s for s in EPILOGUE_STAGES if s in stages)


# ---------------------------------------------------------------------------
# The request objects
# ---------------------------------------------------------------------------

class GemmMasks(NamedTuple):
    """Block bitmaps for one GEMM; ``None`` ⇒ dense on that axis pair.

    2-D request (G=1): out (Mb, Nb), a (Mb, Kb), b (Kb, Nb).
    Grouped request:   each mask carries a leading G axis.
    """
    out: Optional[torch.Tensor] = None
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One masked GEMM, fully described as static metadata (see
    ``repro.kernels.ops.GemmSpec``).

    ``origin`` records who resolved the spec: ``"policy"`` when it came out
    of ``SparsityPolicy.gemm_spec()`` (the one sanctioned resolution
    point), ``"adhoc"`` otherwise.  It is provenance for the trace audit's
    SPEC_UNRESOLVED check, kept out of equality and hashing so that a
    policy-resolved spec and its ad-hoc twin stay interchangeable."""
    block: Tuple[int, int, int] = DEFAULT_BLOCK
    groups: int = 1
    schedule: str = "predicated"
    epilogue: Tuple[str, ...] = ()
    emit_gran: Optional[Tuple[int, int]] = None
    queue_builder: str = "prefix_sum"
    max_active_blocks: Optional[int] = None
    out_dtype: Any = torch.float32
    origin: str = dataclasses.field(default="adhoc", compare=False)

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {self.schedule!r}")
        object.__setattr__(self, "epilogue",
                           normalize_epilogue(self.epilogue))
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if len(self.block) != 3 or any(e < 1 for e in self.block):
            raise ValueError(f"block must be 3 positive edges: {self.block}")
        if self.emits_bitmap:
            bm, _, bn = self.block
            if (self.emit_gran is None or len(self.emit_gran) != 2
                    or bm % self.emit_gran[0] or bn % self.emit_gran[1]):
                raise ValueError(
                    f"bitmap_emit epilogue requires emit_gran dividing "
                    f"(bm, bn)={bm, bn}, got {self.emit_gran!r}")
        elif self.emit_gran is not None:
            raise ValueError(
                f"emit_gran={self.emit_gran!r} without a bitmap_emit "
                f"epilogue stage")

    def with_(self, **kw) -> "GemmSpec":
        return dataclasses.replace(self, **kw)

    @property
    def fuses_mult(self) -> bool:
        return "sigma_prime" in self.epilogue

    @property
    def emits_bitmap(self) -> bool:
        return "bitmap_emit" in self.epilogue

    @property
    def stats_key(self) -> str:
        """The normalized per-launch counter key: ``gemm:<schedule>:<g>``."""
        return f"gemm:{self.schedule}:{self.groups}"

    def launch_geometry(self, m: int, k: int, n: int) -> dict:
        """The logical launch geometry this spec resolves to for per-group
        dims (M, K, N), as the reference defines it: schedule, groups,
        block, the block-padded (G, M, K, N), the compact queue's capacity
        and the grid (compact: (capacity, Kb) with the predicated
        (G, Mb, Nb, Kb) as ``fallback_grid``).  The CUDA kernels do not
        pad; what they launch for a shape is ``masked_matmul.gemm_path``,
        ``split_plan`` and ``grid_blocks``."""
        bm, bk, bn = self.block
        ni, nk, nj = grid_shape((m, k, n), self.block)
        g = self.groups
        geom = {
            "schedule": self.schedule,
            "groups": g,
            "block": (bm, bk, bn),
            "padded": (g, ni * bm, nk * bk, nj * bn),
            "queue_capacity": 0,
            "grid": (),
        }
        if self.schedule == "dense":
            return geom
        predicated_grid = (g, ni, nj, nk)
        if self.schedule == "compact":
            cap = self.max_active_blocks
            geom["queue_capacity"] = g * ni * nj if cap is None else cap
            geom["grid"] = (geom["queue_capacity"], nk)
            geom["fallback_grid"] = predicated_grid
        else:
            geom["grid"] = predicated_grid
        return geom


MasksLike = Union[GemmMasks, Sequence[Optional[torch.Tensor]], None]


def _as_masks(masks: MasksLike) -> GemmMasks:
    if masks is None:
        return GemmMasks()
    if isinstance(masks, GemmMasks):
        return masks
    return GemmMasks(*masks)


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------

# Fault-injection tap (``runtime/faults.py``): when a hook is installed,
# every dispatch offers named values for tampering — the spec
# (``gemm:spec``, e.g. a shrunk queue capacity) and the emitted bitmap
# (``gemm:emit_bits``) — without the kernels layer importing the runtime
# layer.  None (the default) is a passthrough.
_TAMPER_HOOK = None


def set_tamper_hook(fn):
    """Install (or, with None, remove) the fault-injection tamper hook;
    returns the previous hook so callers can restore it."""
    global _TAMPER_HOOK
    prev, _TAMPER_HOOK = _TAMPER_HOOK, fn
    return prev


def _tamper(site: str, value):
    return value if _TAMPER_HOOK is None else _TAMPER_HOOK(site, value)


# Spec provenance for the trace audit: while a ``collect_gemm_events()``
# context is open, every ``sparse_gemm`` dispatch appends its spec here.
_GEMM_EVENTS: Optional[List[GemmSpec]] = None


@contextlib.contextmanager
def collect_gemm_events():
    """Record the ``GemmSpec`` of every ``sparse_gemm`` dispatch run inside
    the context — the audit runs a step under this and then asserts each
    spec's provenance (``origin == "policy"``)."""
    global _GEMM_EVENTS
    prev, _GEMM_EVENTS = _GEMM_EVENTS, []
    try:
        yield _GEMM_EVENTS
    finally:
        _GEMM_EVENTS = prev


def sparse_gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    masks: MasksLike = None,
    spec: Optional[GemmSpec] = None,
    *,
    epilogue_mult: Optional[torch.Tensor] = None,
):
    """Block-sparse GEMM with output/input sparsity skipping — the single
    entry point for every masked GEMM.

    2-D request: ``a`` (M, K) @ ``b`` (K, N) with ``spec.groups == 1``.
    Grouped request: ``a`` (G, M, K) @ ``b`` (G, K, N).  The result equals
    the dense product masked by the expanded ``masks.out`` (and multiplied
    by ``epilogue_mult`` when the spec stages ``sigma_prime``) exactly.
    With ``bitmap_emit`` it returns ``(out, bitmap)``, the (⌈M/er⌉, ⌈N/ec⌉)
    int32 any-nonzero bitmap of the returned values."""
    _refuse_placed("sparse_gemm", a, b, epilogue_mult)
    spec = GemmSpec() if spec is None else spec
    spec = stats.replayed_call(lambda: _tamper("gemm:spec", spec))
    masks = _as_masks(masks)
    if (epilogue_mult is not None) != spec.fuses_mult:
        raise ValueError(
            f"spec.epilogue={spec.epilogue!r} but epilogue_mult "
            f"{'is' if epilogue_mult is not None else 'is not'} provided")
    grouped_in = a.dim() == 3
    if not grouped_in:
        if spec.groups != 1:
            raise ValueError(
                f"2-D operands require spec.groups == 1, got {spec.groups}")
        a3, b3 = a[None], b[None]
        masks = GemmMasks(*(m if m is None else m[None] for m in masks))
        mult3 = None if epilogue_mult is None else epilogue_mult[None]
    else:
        if a.shape[0] != spec.groups:
            raise ValueError(
                f"operand group axis {a.shape[0]} != spec.groups "
                f"{spec.groups}")
        a3, b3, mult3 = a, b, epilogue_mult
    stats.record(spec.stats_key)
    if _GEMM_EVENTS is not None:
        _GEMM_EVENTS.append(spec)
    if spec.emits_bitmap:
        stats.record("emit:grad")
    _observe_live_tiles(spec, a3, b3, masks)
    with stats.lifecycle_scope("gemm", f"{spec.schedule}:{spec.groups}"):
        out, bits = _dispatch(a3, b3, masks, spec, mult3)
    if spec.out_dtype != out.dtype:
        out = out.to(spec.out_dtype)
    if spec.emits_bitmap:
        bits = _tamper("gemm:emit_bits", bits)
        return (out[0], bits[0]) if not grouped_in else (out, bits)
    return out[0] if not grouped_in else out


def _refuse_placed(op: str, *tensors) -> None:
    """A kernel takes plain tensors: a DTensor would be gathered into it
    silently.  Sharded callers run the kernels on their local blocks
    (``models.ffn``'s ``local_map``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"ops.{op}: a DTensor operand; run the kernel on "
                        f"each rank's local block (local_map)")


def elide_gemm(spec: GemmSpec, dims: Tuple[int, int, int],
               masks: Optional[Callable[[], MasksLike]] = None) -> None:
    """Count one dispatch whose result autograd will not read, and run
    nothing.  The reference differentiates by tracing: its trace records
    such a dispatch (the image's gradient) and XLA then drops it.  This
    records the keys ``sparse_gemm`` would — ``spec.stats_key``,
    ``emit:grad`` and, on the compact schedule, ``queue:<builder>`` — each
    also under ``stats.elided``, builds no operand and launches nothing.
    ``dims`` are the per-group (M, K, N).  Where the autotuner resolved
    ``spec`` it reads the dispatch's live-tile fractions, as it would in
    an eager reference step: then, and only then, ``masks()`` builds the
    masks for them."""
    spec = stats.replayed_call(lambda: _tamper("gemm:spec", spec))
    stats.record_elided(spec.stats_key)
    if spec.emits_bitmap:
        stats.record_elided("emit:grad")
    if spec.schedule == "compact":
        stats.record_elided(f"queue:{spec.queue_builder}")
    if masks is not None and autotune.tracked_key(spec, dims) is not None:
        _observe_dims(spec, dims, _as_masks(masks()))


def _observe_live_tiles(spec: GemmSpec, a3, b3, masks: GemmMasks) -> None:
    """Measured live-tile telemetry for the autotuner: the fraction of live
    OUTPUT tiles (1.0 without an out mask) and the min live fraction across
    the operand masks, over the unpadded block bitmaps, as in the
    reference.  On the CPU the fractions are recorded at once.  On the card
    the live counts stay device scalars, queued with the key that resolved
    the spec until ``autotune.fold_pending`` (no host sync per GEMM); a
    spec that no autotune resolution or quarantine clamp produced is not
    observed there, so a step without the autotuner does no extra work.
    A recomputed forward's dispatches (``cfg.remat``) were observed in the
    first forward and are not observed again."""
    _observe_dims(spec, (a3.shape[1], a3.shape[2], b3.shape[2]), masks)


def _observe_dims(spec: GemmSpec, dims: Tuple[int, int, int],
                  masks: GemmMasks) -> None:
    present = [m for m in masks if m is not None]
    if not present or stats.recomputing():
        return
    if present[0].device.type != "cpu":
        _defer_live_tiles(spec, dims, masks)
    else:
        def frac(m) -> float:
            return int(torch.count_nonzero(m)) / m.numel() if m.numel() \
                else 1.0
        out_frac = frac(masks.out) if masks.out is not None else 1.0
        operand = [frac(m) for m in (masks.a, masks.b) if m is not None]
        autotune.observe_dispatch(spec, dims, out_frac,
                                  min(operand) if operand else 1.0)


def _defer_live_tiles(spec: GemmSpec, dims, masks: GemmMasks) -> None:
    """The card's path of ``_observe_live_tiles``: the masks' live counts
    as device scalars, queued for ``autotune.fold_pending``."""
    key = autotune.tracked_key(spec, dims)
    if key is None:
        return

    def count(m):
        return torch.count_nonzero(m), m.numel()

    autotune.defer_observation(
        key, count(masks.out) if masks.out is not None else None,
        [count(m) for m in (masks.a, masks.b) if m is not None])


def _dispatch(a, b, masks: GemmMasks, spec: GemmSpec, mult):
    """(Queue →) launch.  Exists exactly once.  Returns ``(out, bits)``,
    ``bits`` None unless the spec stages ``bitmap_emit``."""
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or g != spec.groups or k != k2:
        raise ValueError(f"bad operands {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"for {spec}")
    bm, bk, bn = spec.block
    emit = spec.emit_gran if spec.emits_bitmap else None
    if mult is not None:
        if tuple(mult.shape) != (g, m, n):
            raise ValueError(f"epilogue_mult {tuple(mult.shape)} != "
                             f"{(g, m, n)}")
        mult = mult.to(torch.float32).contiguous()

    if spec.schedule == "dense":
        # Dense compute + output masking, numerically the kernels' result;
        # operand masks are metadata only on this schedule.
        out = ref.grouped_masked_matmul(a.float(), b.float(), masks.out, None, None, bm=bm,
                                        bk=bk, bn=bn, epilogue_mult=mult)
        bits = None if emit is None else masked_matmul.emit_bits(out, emit)
        return out, bits

    ni, nk, nj = grid_shape((m, k, n), spec.block)
    dev = a.device
    am = None if masks.a is None else pad_mask3(masks.a, g, ni, nk).contiguous()
    bmask = None if masks.b is None \
        else pad_mask3(masks.b, g, nk, nj).contiguous()
    if spec.schedule == "predicated":
        om = None if masks.out is None \
            else pad_mask3(masks.out, g, ni, nj).contiguous()
        return masked_matmul.grouped_masked_matmul_kernel(
            a, b, om, am, bmask, block=spec.block, epilogue_mult=mult,
            emit_gran=emit)

    # compact: ONE queue over all groups — flatten (G, Mb, Nb) to
    # (G·Mb, Nb) so the row-major builder order IS lexicographic (g, i, j);
    # the kernel decodes g and i from the fused row.
    om = pad_mask3(masks.out, g, ni, nj, device=dev).contiguous()
    total = g * ni * nj
    cap = spec.max_active_blocks if spec.max_active_blocks is not None \
        else total
    fi, jj, n_live = build_queue(om.reshape(g * ni, nj), capacity=cap,
                                 builder=spec.queue_builder)
    out, bits = masked_matmul.grouped_compact_masked_matmul_kernel(
        a, b, fi, jj, n_live, am, bmask, block=spec.block,
        epilogue_mult=mult, emit_gran=emit)
    if cap < total:
        # The queue may overflow.  Both launches read n_live on the device:
        # the compact one exits when n_live > cap, the predicated fallback
        # when n_live <= cap — exact always, and no host sync; on the card
        # the overflow count stays on the device until stats are read.
        if stats.recomputing():
            pass      # the first forward's dispatch counted and reported
        elif n_live.device.type == "cpu":
            if int(n_live[0]) > cap:
                stats.record("fallback:queue_overflow")
                autotune.report_overflow(spec, (m, k, n))
        else:
            overflow = n_live > cap
            stats.record_on_device("fallback:queue_overflow", overflow)
            autotune.defer_overflow(spec, (m, k, n), overflow)
        out, bits = masked_matmul.grouped_masked_matmul_kernel(
            a, b, om, am, bmask, block=spec.block, epilogue_mult=mult,
            emit_gran=emit, out=out, bits=bits, n_live=n_live, capacity=cap)
    return out, bits


# ---------------------------------------------------------------------------
# Bitmap producers
# ---------------------------------------------------------------------------

def bitmap_scan(x: torch.Tensor, *,
                block: Tuple[int, int] = (DEFAULT_BLOCK[0], DEFAULT_BLOCK[2]),
                kind: str = "act") -> torch.Tensor:
    """Block any-nonzero bitmap of SIGNED data at granularity ``block`` —
    the encoder for tensors with no ReLU to fuse into (raw inputs), counted
    as ``scan_pallas:<kind>``.  The kernel masks the ragged edge itself, so
    nothing is padded here."""
    _refuse_placed("bitmap_scan", x)
    stats.record(f"scan_pallas:{kind}")
    with stats.lifecycle_scope("scan", kind):
        return _bitmap_scan.bitmap_scan(x, block)


def relu_encode(z: torch.Tensor, *,
                block: Tuple[int, int] = (DEFAULT_BLOCK[0], DEFAULT_BLOCK[2])
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relu(z) + block bitmap at granularity ``block`` — THE forward-
    pass bitmap computation, one fused pass per activation per step.  The
    kernel masks the ragged edge itself, so nothing is padded here."""
    _refuse_placed("relu_encode", z)
    stats.record("encode:act")
    with stats.lifecycle_scope("encode", "act"):
        return _relu_encode.relu_encode(z, block)


# ---------------------------------------------------------------------------
# The paper's composite ops, spec-driven
# ---------------------------------------------------------------------------

def relu_bwd_masked(
    dy: torch.Tensor,          # (M, K) δ_post — gradient from the layer above
    w_t: torch.Tensor,         # (K, N) Wᵀ of the producer layer
    relu_mask: torch.Tensor,   # (M, N) {0,1} σ'(z) captured in the forward
    *,
    spec: Optional[GemmSpec] = None,
    use_input_sparsity: bool = True,
    use_output_sparsity: bool = True,
) -> torch.Tensor:
    """δ_pre = (δ_post @ Wᵀ) ⊙ σ'(z) with block skipping — the paper's core
    op.  OUTPUT sparsity: tiles where σ'(z) is all-zero are never computed;
    INPUT sparsity: K-tiles of δ_post that are all-zero are skipped.  The
    σ′ multiply rides the GEMM's fused epilogue (``spec``'s epilogue is
    forced to ``sigma_prime``, its groups to 1)."""
    spec = GemmSpec() if spec is None else spec
    spec = spec.with_(epilogue="sigma_prime", groups=1)
    bm, bk, bn = spec.block
    mask32 = relu_mask.to(torch.float32)
    out_mask = block_bitmap(mask32, bm, bn) if use_output_sparsity else None
    a_mask = block_bitmap(dy.to(torch.float32), bm, bk) \
        if use_input_sparsity else None
    return sparse_gemm(dy, w_t, GemmMasks(out_mask, a_mask, None), spec,
                       epilogue_mult=mask32)


def weight_grad_masked(
    x_t: torch.Tensor,       # (N, M) Xᵀ — activations (sparse post-ReLU)
    dy: torch.Tensor,        # (N, K) δ — gradient (sparse post-Hadamard)
    *,
    spec: Optional[GemmSpec] = None,
    use_input_sparsity: bool = True,
) -> torch.Tensor:
    """dW = Xᵀ @ δ with INPUT sparsity on both operands (the paper's WG
    stage): no output sparsity, but contraction tiles where either operand
    is all-zero are skipped."""
    spec = GemmSpec() if spec is None else spec
    spec = spec.with_(epilogue="none", groups=1)
    bm, bk, bn = spec.block
    a_mask = b_mask = None
    if use_input_sparsity:
        a_mask = block_bitmap(x_t.to(torch.float32), bm, bk)
        b_mask = block_bitmap(dy.to(torch.float32), bk, bn)
    return sparse_gemm(x_t, dy, GemmMasks(None, a_mask, b_mask), spec)
