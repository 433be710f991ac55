"""Kernel sanitizer: every CUDA kernel of the port swept at small shapes
through the C entry points the wrappers use, with tripwires — the port of
``repro.analysis.kernel_sanitizer``.

The reference re-executes its Pallas kernel bodies over numpy shadow
memory.  Here the kernels are compiled CUDA, so the tripwires sit around
and inside the real launches:

  * **guard bands.**  Every output the sweep hands a launcher is the body
    of one allocation between two bands of ``GUARD`` words that hold
    ``GUARD_WORD``; a band that changed is a store outside the output
    (STORE_OOB; QUEUE_WRITE_OOB for the queue builder's slots);
  * **poison.**  An output the kernel must write in part is filled with
    ``POISON_WORD`` first: every element of a live tile must be written
    and every dead tile left untouched (DOUBLE_WRITE, "never written" or
    "dead tile written");
  * **write counts.**  The masked-GEMM launches also run on the shadow
    build (``kernels._build.load(shadow=True)``, ``-DREPRO_SHADOW``), whose
    kernels add 1 to a per-element counter at every store to the output
    and to the split-K workspace, and count the workspace loads of
    elements no split wrote: each live output element must be stored
    exactly once (DOUBLE_WRITE) and the reduce must read only written
    partials (ACC_READ_BEFORE_WRITE).  Its results must equal the default
    build's bit for bit;
  * **the queue contract.**  K2's slots below min(capacity, tiles) hold
    ``core.workredist.static_queue_order``'s order and the true live count
    (QUEUE_ORDER); every one of them is written and none past it
    (DUMP_SLOT_LEAK: the port's dump slots are the ones its caller
    zero-fills).

On the CPU the same sweep runs against the plain versions, driven by an
emulation of each C launcher that stores tile by tile in the launcher's
order, into the same guarded buffers, and counts its stores as the shadow
build does.  The planted faults go in through inputs, never by editing a
kernel: an output one tile short (STORE_OOB), a queue with one entry
duplicated (DOUBLE_WRITE), a reduce of one split more than was written
(ACC_READ_BEFORE_WRITE), queue slots one short of the capacity
(QUEUE_WRITE_OOB), an overstated tile count (DUMP_SLOT_LEAK), and a
capacity below the live count, which the overflow fallback must absorb
with no violation.

``compute-sanitizer`` (memcheck, racecheck, initcheck) would see what the
tripwires cannot; on the machine the port is measured on it refuses the
device ("Device not supported"), so ``compute_sanitizer_status`` reports
that on every run and the sweep does not use it.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.workredist import static_queue_order
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import masked_matmul as mmk
from repro_torch.kernels import relu_encode as renc
from repro_torch.kernels.queue_builder import build_queue_plain
from repro_torch.kernels.shapes import block_bitmap

from .report import Violation

GUARD = 1024                   # words in each guard band
GUARD_WORD = 0x7FBADBAD        # a NaN no kernel computes
POISON_WORD = 0x7FC0FFEE       # another one, for outputs written in part
GEMM_RTOL = 1e-4               # max|kernel - plain| <= GEMM_RTOL * max|plain|


# ---------------------------------------------------------------------------
# Guarded buffers
# ---------------------------------------------------------------------------

class Guarded:
    """``n`` 4-byte words between two guard bands, in one allocation; the
    body starts 16-byte aligned."""

    def __init__(self, n: int, device, *, fill: str = "zero"):
        self.n = n
        self.raw = torch.full((n + 2 * GUARD,), GUARD_WORD, dtype=torch.int32,
                              device=device)
        if fill == "zero":
            self.words.zero_()
        elif fill == "poison":
            self.words.fill_(POISON_WORD)

    @property
    def words(self) -> torch.Tensor:
        return self.raw[GUARD:GUARD + self.n]

    def body(self, dtype=torch.float32, shape=None) -> torch.Tensor:
        v = self.words.view(dtype)
        return v if shape is None else v.view(shape)

    def ptr(self) -> int:
        return self.words.data_ptr()

    def guard_hits(self) -> int:
        bands = torch.cat([self.raw[:GUARD], self.raw[GUARD + self.n:]])
        return int((bands != GUARD_WORD).sum())


# ---------------------------------------------------------------------------
# One GEMM launch, as the C launcher takes it
# ---------------------------------------------------------------------------

PREDICATED, COMPACT, COMPACT_OUT = mmk._PREDICATED, mmk._COMPACT, \
    mmk._COMPACT_OUT


@dataclasses.dataclass
class GemmLaunch:
    """The arguments of one ``masked_gemm_launch`` (and of its reduce)."""
    a: torch.Tensor
    b: torch.Tensor
    out: Guarded
    bits: Optional[Guarded]
    out_mask: Optional[torch.Tensor]
    a_mask: Optional[torch.Tensor]
    b_mask: Optional[torch.Tensor]
    mult: Optional[torch.Tensor]
    fi: Optional[torch.Tensor]
    jj: Optional[torch.Tensor]
    n_live: Optional[torch.Tensor]
    ws: Optional[Guarded]
    member: Optional[Guarded]
    cap: int
    block: Tuple[int, int, int]
    emit: Optional[Tuple[int, int]]
    mode: int
    path: int
    splits: int

    @property
    def dims(self):
        g, m, k = self.a.shape
        return g, m, k, self.b.shape[2]

    def grid(self):
        g, m, k, n = self.dims
        return mmk.grid_shape((m, k, n), self.block)


def _p(t) -> Optional[int]:
    if t is None:
        return None
    return t.ptr() if isinstance(t, Guarded) else t.data_ptr()


class CudaLaunchers:
    """The C entry points of ``kernels/_build.py``'s library (with
    ``shadow``, the instrumented one), called as the wrappers call them."""

    def __init__(self, device, *, shadow: bool = False):
        self.device = device
        self.lib = _build.load(shadow=shadow)
        self.counts: Dict[str, "torch.Tensor"] = {}

    def stream(self):
        return _build.stream_handle(self.device)

    def _gemm_args(self, p: GemmLaunch, splits: int):
        g, m, k, n = p.dims
        er, ec = p.emit or (1, 1)
        return (p.a.data_ptr(), *p.a.stride(), p.b.data_ptr(), *p.b.stride(),
                p.out.ptr(), _p(p.bits), _p(p.out_mask), _p(p.a_mask),
                _p(p.b_mask), _p(p.mult), _p(p.fi), _p(p.jj), _p(p.n_live),
                _p(p.ws), _p(p.member), p.cap, g, m, k, n, *p.block, er, ec,
                p.mode, p.path, splits)

    def arm(self, out: Guarded, ws: Optional[Guarded]) -> None:
        """Shadow build: zero and arm the store counters of out and ws."""
        dev = self.device
        self.counts = {
            "out": torch.zeros(out.n, dtype=torch.int32, device=dev),
            "ws": torch.zeros(ws.n if ws is not None else 1,
                              dtype=torch.int32, device=dev),
            "unwritten": torch.zeros(1, dtype=torch.int32, device=dev)}
        c = self.counts
        _build.check(self.lib.shadow_arm(
            out.ptr(), out.n, c["out"].data_ptr(), _p(ws),
            ws.n if ws is not None else 0,
            c["ws"].data_ptr() if ws is not None else None,
            c["unwritten"].data_ptr(), self.stream()), "shadow_arm")

    def disarm(self) -> None:
        _build.check(self.lib.shadow_arm(None, 0, None, None, 0, None, None,
                                         self.stream()), "shadow_arm")

    def gemm(self, p: GemmLaunch) -> None:
        _build.check(self.lib.masked_gemm_launch(
            *self._gemm_args(p, p.splits), self.stream()), "masked_gemm")

    def reduce(self, p: GemmLaunch, splits: int) -> None:
        g, m, _, n = p.dims
        plan = mmk.reduce_plan(p.path, g, m, n, splits)
        _build.check(self.lib.masked_gemm_reduce_launch(
            *self._gemm_args(p, splits), *plan, self.stream()),
            "masked_gemm split-K reduce")

    def queue(self, bitmap: Guarded, tiles: int, cols: int, cap: int,
              ii: Guarded, jj: Guarded, n_live: Guarded) -> None:
        _build.check(self.lib.queue_builder_launch(
            bitmap.ptr(), tiles, cols, cap, ii.ptr(), jj.ptr(), n_live.ptr(),
            self.stream()), "queue_builder")

    def encode(self, x: torch.Tensor, y: Optional[Guarded], bits: Guarded,
               gran) -> None:
        m, n = x.shape
        yb = None if y is None else y.body(shape=(m, n))
        bb = bits.body(torch.int32, (-(-m // gran[0]), -(-n // gran[1])))
        fn = self.lib.relu_encode_launch if y is not None \
            else self.lib.bitmap_scan_launch
        renc.launch_encoder(fn, x, x.stride(0), yb, bb, gran)

    def member(self, fi, jj, n_live, n_cols: int, member: Guarded) -> None:
        _build.check(self.lib.queue_member_launch(
            fi.data_ptr(), jj.data_ptr(), n_live.data_ptr(), fi.numel(),
            n_cols, member.ptr(), member.n, self.stream()), "queue_member")

    def fixup(self, out: Guarded, bits: Guarded, dims, emit) -> None:
        g, m, n = dims
        _build.check(self.lib.emit_nan_fixup_launch(
            out.ptr(), bits.ptr(), g, m, n, *emit, self.stream()),
            "emit_nan_fixup")


class CpuLaunchers:
    """The C launchers emulated on the CPU with the plain versions: each
    stores into the same guarded buffers, tile by tile in the launcher's
    order and at the flat offsets the kernel computes, and counts its
    stores as the shadow build does."""

    def __init__(self, device):
        self.device = device
        self.counts: Dict[str, "torch.Tensor"] = {}

    def arm(self, out: Guarded, ws: Optional[Guarded]) -> None:
        self.counts = {
            "out": torch.zeros(out.n, dtype=torch.int32),
            "ws": torch.zeros(ws.n if ws is not None else 1,
                              dtype=torch.int32),
            "unwritten": torch.zeros(1, dtype=torch.int32)}

    def disarm(self) -> None:
        pass

    @staticmethod
    def _store(buf: Guarded, offsets: torch.Tensor, values: torch.Tensor,
               counts: Optional[torch.Tensor] = None) -> None:
        """Store ``values`` at body offsets (past the body: the guard)."""
        raw = buf.raw
        if values.dtype == torch.float32:
            values = values.view(torch.int32)
        raw[GUARD + offsets] = values.to(torch.int32)
        if counts is not None:
            inside = offsets[(offsets >= 0) & (offsets < buf.n)]
            counts.index_add_(0, inside, torch.ones_like(inside,
                                                         dtype=torch.int32))

    def _tiles(self, p: GemmLaunch):
        """(slot, g, i, j) of every tile the launch writes, in order."""
        g, m, k, n = p.dims
        mb, _, nb = p.grid()
        if p.mode == PREDICATED:
            if p.n_live is not None and int(p.n_live[0]) <= p.cap:
                return []
            live = torch.ones(g, mb, nb, dtype=torch.int32) \
                if p.out_mask is None else p.out_mask
            return [(0, gi, i, j) for gi, i, j in
                    torch.nonzero(live).tolist()]
        nl = int(p.n_live[0])
        if (p.mode == COMPACT and nl > p.cap) or p.cap == 0:
            return []
        slots = [(s, int(p.fi[s]) // mb, int(p.fi[s]) % mb, int(p.jj[s]))
                 for s in range(min(nl, p.cap))]
        if p.mode == COMPACT and p.path != mmk.STANDARD:
            # Group-major: the queue's membership bitmap, one write a tile.
            return [(0, gi, i, j) for gi, i, j in sorted(
                {(gi, i, j) for _, gi, i, j in slots})]
        return slots

    def _offsets(self, p: GemmLaunch, slot, gi, i, j):
        g, m, k, n = p.dims
        bm, _, bn = p.block
        ms = torch.arange(i * bm, min((i + 1) * bm, m))
        ns = torch.arange(j * bn, min((j + 1) * bn, n))
        flat = ((gi * m + ms[:, None]) * n + ns[None, :]).reshape(-1)
        if p.mode == COMPACT_OUT:
            comp = ((slot * bm + (ms[:, None] - i * bm)) * bn
                    + (ns[None, :] - j * bn)).reshape(-1)
            return flat, comp, ms, ns
        return flat, flat, ms, ns

    def _partial(self, p: GemmLaunch, lo: int, hi: int) -> torch.Tensor:
        """The raw (pre-epilogue) product over k blocks [lo, hi)."""
        g, m, k, n = p.dims
        mb, kb, nb = p.grid()
        am = torch.ones(g, mb, kb, dtype=torch.int32) if p.a_mask is None \
            else p.a_mask.clone()
        am[:, :, :lo] = 0
        am[:, :, hi:] = 0
        return mmk._masked_product(p.a, p.b, None, am, p.b_mask, p.block,
                                   None)

    def _epilogue_store(self, p: GemmLaunch, tiles, value) -> None:
        g, m, k, n = p.dims
        v = value if p.mult is None else value * p.mult
        for slot, gi, i, j in tiles:
            flat, dst, ms, ns = self._offsets(p, slot, gi, i, j)
            vals = v.reshape(-1)[flat]
            self._store(p.out, dst, vals, self.counts.get("out"))
            if p.bits is not None:
                er, ec = p.emit
                mc, nc = -(-m // er), -(-n // ec)
                cells = ((gi * mc + ms[:, None] // er) * nc
                         + ns[None, :] // ec).reshape(-1)
                self._store(p.bits, cells[vals.abs() > 0],
                            torch.ones(int((vals.abs() > 0).sum()),
                                       dtype=torch.int32))

    def gemm(self, p: GemmLaunch) -> None:
        g, m, k, n = p.dims
        if p.mode != PREDICATED and p.cap == 0:
            return
        mb, kb, nb = p.grid()
        if p.member is not None and p.mode == COMPACT:
            self.member(p.fi, p.jj, p.n_live, nb, p.member)
        tiles = self._tiles(p)
        if p.splits > 1:
            slice_n = g * m * n
            for z, (lo, hi) in enumerate(mmk.split_bounds(kb, p.splits)):
                part = self._partial(p, lo, hi).reshape(-1)
                for slot, gi, i, j in tiles:
                    flat, _, _, _ = self._offsets(p, slot, gi, i, j)
                    self._store(p.ws, z * slice_n + flat, part[flat],
                                self.counts.get("ws"))
            return
        self._epilogue_store(p, tiles, self._partial(p, 0, kb))
        if p.bits is not None:
            self._fixup_gated(p)

    def reduce(self, p: GemmLaunch, splits: int) -> None:
        g, m, k, n = p.dims
        slice_n = g * m * n
        plan = mmk.reduce_plan(p.path, g, m, n, splits)
        tiles = self._tiles(p)
        ws = p.ws.raw[GUARD:].view(torch.float32)
        value = torch.zeros(slice_n)
        for slot, gi, i, j in tiles:
            flat, _, _, _ = self._offsets(p, slot, gi, i, j)
            parts = []
            for z in range(splits):
                idx = z * slice_n + flat
                if "ws" in self.counts:
                    cw = self.counts["ws"]
                    inside = idx[idx < cw.numel()]
                    unwritten = int((cw[inside] == 0).sum()) \
                        + int((idx >= cw.numel()).sum())
                    self.counts["unwritten"] += unwritten
                parts.append(ws[idx])
            value[flat] = mmk.splitk_reduce_plain(
                torch.stack(parts)[:, None, None, :], plan).reshape(-1)
        self._epilogue_store(p, tiles, value.reshape(g, m, n))
        if p.bits is not None:
            self._fixup_gated(p)

    def _fixup_gated(self, p: GemmLaunch) -> None:
        g, m, k, n = p.dims
        out = p.out.body()[:g * m * n] if p.out.n >= g * m * n else None
        if out is not None and bool(out.isnan().any()):
            self.fixup(p.out, p.bits, (g, m, n), p.emit)

    def queue(self, bitmap: Guarded, tiles: int, cols: int, cap: int,
              ii: Guarded, jj: Guarded, n_live: Guarded) -> None:
        words = bitmap.raw[GUARD:GUARD + tiles]
        live = words != 0
        rank = torch.cumsum(live.to(torch.int64), 0) - live.to(torch.int64)
        t = torch.arange(tiles)
        nl = int(live.sum())
        dead_rank = t - rank - 1 + (~live).to(torch.int64)
        slot = torch.where(live, rank, tiles - 1 - dead_rank)
        ok = slot < cap
        vals_i = torch.where(live, t // cols, torch.zeros_like(t))
        vals_j = torch.where(live, t % cols, torch.zeros_like(t))
        self._store(ii, slot[ok], vals_i[ok].to(torch.int32))
        self._store(jj, slot[ok], vals_j[ok].to(torch.int32))
        self._store(n_live, torch.zeros(1, dtype=torch.int64),
                    torch.tensor([nl], dtype=torch.int32))

    def encode(self, x: torch.Tensor, y: Optional[Guarded], bits: Guarded,
               gran) -> None:
        m, n = x.shape
        if y is not None:
            yv, bv = renc.relu_encode_plain(x, gran)
            self._store(y, torch.arange(m * n), yv.reshape(-1))
        else:
            bv = block_bitmap(x, *gran)
        self._store(bits, torch.arange(bv.numel()), bv.reshape(-1))

    def member(self, fi, jj, n_live, n_cols: int, member: Guarded) -> None:
        mem = torch.zeros(member.n, dtype=torch.int32)
        mmk.queue_member_plain(fi, jj, n_live, mem, n_cols=n_cols)
        self._store(member, torch.arange(member.n), mem)

    def fixup(self, out: Guarded, bits: Guarded, dims, emit) -> None:
        g, m, n = dims
        er, ec = emit
        bv = bits.body(torch.int32, (g, -(-m // er), -(-n // ec))).clone()
        mmk.emit_nan_fixup_plain(out.body(shape=(g, m, n)), bv, emit)
        self._store(bits, torch.arange(bv.numel()), bv.reshape(-1))


def launchers(device, *, shadow: bool = False):
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CpuLaunchers(dev)
    return CudaLaunchers(dev, shadow=shadow)


# ---------------------------------------------------------------------------
# Sweep records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Sweep:
    """What a sweep found: violations, kernel launches by name (the names
    of ``chip_smoke.py``'s kernel table) and each case's largest
    |kernel - plain| against its bound."""
    violations: List[Violation] = dataclasses.field(default_factory=list)
    launches: "collections.Counter[str]" = dataclasses.field(
        default_factory=collections.Counter)
    errors: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    queue: Optional[tuple] = None    # the last K2 case's (ii, jj, n_live)

    def report(self, code: str, where: str, message: str, workload: str):
        v = Violation("kernel", code, where, message, workload)
        if v not in self.violations:
            self.violations.append(v)

    def error(self, label: str, err: float, bound: float) -> None:
        self.errors[label] = (float(err), float(bound))

    def bad_errors(self) -> Dict[str, Tuple[float, float]]:
        return {k: v for k, v in self.errors.items() if not v[0] <= v[1]}


def _check_guards(sw: Sweep, label: str, kernel: str,
                  **bufs: Optional[Guarded]) -> None:
    for name, buf in bufs.items():
        if buf is None:
            continue
        hits = buf.guard_hits()
        if hits:
            sw.report("STORE_OOB", f"{kernel}:{name}",
                      f"{hits} word(s) of {name}'s guard bands overwritten "
                      f"— a store outside the output", label)


# ---------------------------------------------------------------------------
# Kernel families
# ---------------------------------------------------------------------------

def run_encoder(sw: Sweep, lz, x: torch.Tensor, gran, *, relu: bool,
                label: str) -> None:
    """K1 (``relu``) or K5 on ``x``: every element of y and every cell of
    the bitmap written, the guards intact, both equal to the plain
    version."""
    m, n = x.shape
    kernel = "relu_encode" if relu else "bitmap_scan"
    cells = -(-m // gran[0]) * -(-n // gran[1])
    y = Guarded(m * n, x.device, fill="poison") if relu else None
    bits = Guarded(cells, x.device, fill="poison")
    lz.encode(x, y, bits, gran)
    sw.launches[kernel] += 1
    _check_guards(sw, label, kernel, y=y, bits=bits)
    xc = x.cpu()
    if relu:
        want_y, want_b = renc.relu_encode_plain(xc, gran)
    else:
        want_y, want_b = None, block_bitmap(xc, *gran)
    for name, buf, want in (("y", y, want_y), ("bits", bits, want_b)):
        if buf is None:
            continue
        words = buf.words.cpu()
        if bool((words == POISON_WORD).any()):
            sw.report("DOUBLE_WRITE", f"{kernel}:{name}",
                      f"{int((words == POISON_WORD).sum())} element(s) of "
                      f"{name} never written (contract: every one)", label)
        got = words.view(want.dtype).reshape(want.shape) \
            if want.dtype != torch.int32 else words.reshape(want.shape)
        same = torch.equal(got, want) if want.dtype == torch.int32 else \
            torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
        sw.error(f"{label}:{name}", 0.0 if same else 1.0, 0.0)


def run_queue_builder(sw: Sweep, lz, bitmap: np.ndarray, capacity: int, *,
                      label: str, slots: Optional[int] = None,
                      claimed_tiles: Optional[int] = None):
    """K2 over ``bitmap`` at ``capacity`` into poisoned (ii, jj) of
    ``slots`` (default the capacity) slots, told ``claimed_tiles`` tiles
    (default the bitmap's).  Returns (ii, jj, n_live) as read back."""
    if capacity < 1:
        raise ValueError("the sweep's queues have a capacity of 1 or more")
    dev = lz.device
    bmp = np.asarray(bitmap, np.int32)
    rows, cols = bmp.shape
    tiles = rows * cols if claimed_tiles is None else claimed_tiles
    slots = capacity if slots is None else slots
    src = Guarded(bmp.size, dev)
    src.words.copy_(torch.as_tensor(bmp.reshape(-1), device=dev))
    ii = Guarded(slots, dev, fill="poison")
    jj = Guarded(slots, dev, fill="poison")
    nl = Guarded(1, dev, fill="poison")
    lz.queue(src, tiles, max(cols, 1), capacity, ii, jj, nl)
    sw.launches["queue_builder"] += 1
    for name, buf in (("ii", ii), ("jj", jj), ("n_live", nl)):
        hits = buf.guard_hits()
        if hits:
            sw.report("QUEUE_WRITE_OOB", f"queue_builder:{name}",
                      f"{hits} word(s) past the {name} slots overwritten — "
                      f"a queue store beyond the capacity", label)
    written = min(capacity, rows * cols)
    ref_ii, ref_jj, ref_n = static_queue_order(bmp, capacity)
    got_ii = ii.words.cpu().numpy()
    got_jj = jj.words.cpu().numpy()
    for name, got in (("ii", got_ii), ("jj", got_jj)):
        head = got[:min(written, slots)]
        if (head == POISON_WORD).any():
            bad = int(np.flatnonzero(head == POISON_WORD)[0])
            sw.report("DUMP_SLOT_LEAK", f"queue_builder:{name}",
                      f"slot {bad} below min(capacity, tiles) = {written} "
                      f"never written (contract: every one, dead tiles "
                      f"with (0, 0))", label)
        tail = got[written:slots]
        if (tail != POISON_WORD).any():
            bad = written + int(np.flatnonzero(tail != POISON_WORD)[0])
            sw.report("DUMP_SLOT_LEAK", f"queue_builder:{name}",
                      f"slot {bad} past min(capacity, tiles) = {written} "
                      f"written (those slots are the caller's to "
                      f"zero-fill)", label)
    k = min(written, slots)
    if not (np.array_equal(got_ii[:k], ref_ii[:k])
            and np.array_equal(got_jj[:k], ref_jj[:k])):
        sw.report("QUEUE_ORDER", "queue_builder",
                  "queue content differs from the WDU reference order "
                  "(core.workredist.static_queue_order)", label)
    n_got = int(nl.words.cpu()[0])
    if n_got != int(ref_n):
        sw.report("QUEUE_ORDER", "queue_builder",
                  f"emitted n_live={n_got} != true set-bit count "
                  f"{int(ref_n)}", label)
    return got_ii[:k], got_jj[:k], n_got


@dataclasses.dataclass
class GemmCase:
    """One masked-GEMM request for the sweep, and the faults planted in
    it.  ``schedule``: predicated, compact, overflow (compact at a capacity
    below the live count, then the predicated fallback) or compact_out
    (K7).  ``kernel`` is its row of the kernel table."""
    label: str
    g: int
    m: int
    k: int
    n: int
    block: Tuple[int, int, int]
    schedule: str
    kernel: str
    emit: Optional[Tuple[int, int]] = None
    mult: bool = False
    live: float = 0.5
    short_output: bool = False       # plant: out one tile short
    duplicate_slot: bool = False     # plant: queue slot 1 := slot 0
    extra_split: bool = False        # plant: reduce one split more


def _gemm_inputs(c: GemmCase, device, arrays=None):
    """(a, b, out_mask, a_mask, b_mask, mult) on ``device``: ``arrays``
    (numpy, any of the masks or mult None) or drawn from the case's
    seed."""
    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)
    if arrays is not None:
        return tuple(t(x) for x in arrays)
    r = np.random.RandomState(0)
    bm, bk, bn = c.block
    mb, kb, nb = -(-c.m // bm), -(-c.k // bk), -(-c.n // bn)
    a = r.randn(c.g, c.m, c.k).astype(np.float32)
    b = r.randn(c.g, c.k, c.n).astype(np.float32)
    om = (r.rand(c.g, mb, nb) < c.live).astype(np.int32)
    if c.short_output:
        om[:] = 1
    am = (r.rand(c.g, mb, kb) < 0.8).astype(np.int32)
    bmask = (r.rand(c.g, kb, nb) < 0.8).astype(np.int32)
    mult = (r.rand(c.g, c.m, c.n) < 0.7).astype(np.float32) if c.mult \
        else None
    return t(a), t(b), t(om), t(am), t(bmask), t(mult)


def run_gemm(sw: Sweep, lz, c: GemmCase, *, shadow_lz=None,
             arrays=None) -> torch.Tensor:
    """One request on the default launchers (guards, poison, values) and,
    with ``shadow_lz``, again on the shadow build (store counts, unwritten
    partial reads, results equal to the default build's); its inputs
    ``arrays`` (see ``_gemm_inputs``) or drawn from the case's seed.
    Returns the default run's output body (float32, on the CPU)."""
    dev = lz.device
    a, b, om, am, bmask, mult = _gemm_inputs(c, dev, arrays)
    g, m, k, n = c.g, c.m, c.k, c.n
    bm, bk, bn = c.block
    mb, kb, nb = mmk.grid_shape((m, k, n), c.block)
    path = mmk.gemm_path(g, m, k, n, c.block)
    splits = mmk.split_plan(g, m, k, n, c.block)
    reduce_splits = splits + (1 if c.extra_split else 0)
    # The queue over the out_mask, from the plain builder.
    om_cpu = om.cpu()
    flat_om = om_cpu.reshape(g * mb, nb)
    n_true = int(flat_om.sum())
    cap = {"overflow": max(1, n_true // 2),
           "compact_out": n_true + 2}.get(c.schedule, g * mb * nb)
    fi = jj = n_live = None
    if c.schedule != "predicated":
        fi_c, jj_c, nl_c = build_queue_plain(flat_om, cap)
        if c.duplicate_slot:
            fi_c[1], jj_c[1] = fi_c[0], jj_c[0]
        fi, jj, n_live = fi_c.to(dev), jj_c.to(dev), nl_c.to(dev)
    want = mmk._masked_product(a.cpu(), b.cpu(), om_cpu,
                               None if am is None else am.cpu(),
                               None if bmask is None else bmask.cpu(),
                               c.block, None if mult is None else mult.cpu())
    results = []
    for which in ("default", "shadow"):
        z = lz if which == "default" else shadow_lz
        if z is None:
            continue
        n_out = (cap * bm * bn if c.schedule == "compact_out"
                 else g * m * n) - (bm * bn if c.short_output else 0)
        out = Guarded(n_out, dev, fill="poison")
        er_ec = c.emit
        bits = None if er_ec is None else Guarded(
            g * -(-m // er_ec[0]) * -(-n // er_ec[1]), dev)
        # Zero-filled: an unwritten partial shows in the store counts
        # (ACC_READ_BEFORE_WRITE), not as poison in the output.
        ws = None if splits < 2 else Guarded(reduce_splits * g * m * n, dev)
        member = Guarded(g * mb * nb, dev, fill="poison") \
            if path != mmk.STANDARD and c.schedule in ("compact", "overflow") \
            else None
        mode = {"predicated": PREDICATED, "compact_out": COMPACT_OUT}.get(
            c.schedule, COMPACT)
        p = GemmLaunch(a, b, out, bits, om if mode == PREDICATED else None,
                       am, bmask, mult, fi, jj, n_live, ws, member,
                       cap if mode != PREDICATED else 0, c.block, c.emit,
                       mode, path, splits)
        if which == "shadow" or isinstance(z, CpuLaunchers):
            z.arm(out, ws)
        launches = [p]
        if c.schedule == "overflow":
            launches.append(dataclasses.replace(
                p, mode=PREDICATED, out_mask=om, member=None, fi=None,
                jj=None))
        for q in launches:
            z.gemm(q)
            if splits > 1:
                z.reduce(q, reduce_splits)
            if which == "default":
                _tally_gemm(sw, c, q)
        counts = {name: t.cpu() for name, t in z.counts.items()}
        if which == "shadow" or isinstance(z, CpuLaunchers):
            z.disarm()
        if which == "default":
            _check_guards(sw, c.label, "masked_gemm", out=out, bits=bits,
                          ws=ws, member=member)
        results.append((which, out, bits, counts))
    _check_gemm_outputs(sw, c, results, want, om_cpu, cap, n_true)
    return results[0][1].words.cpu().view(torch.float32)


def _tally_gemm(sw: Sweep, c: GemmCase, q: GemmLaunch) -> None:
    g, m, k, n = q.dims
    if q.mode != PREDICATED and q.cap == 0:
        return
    if c.kernel in ("masked_matmul_2d", "compact_masked_matmul_2d"):
        sw.launches[c.kernel] += 1
    else:
        sw.launches["compact_gemm" if q.mode == COMPACT
                    else "predicated_gemm"] += 1
    if q.member is not None and q.mode == COMPACT:
        sw.launches["queue_member"] += 1
    if q.splits > 1:
        sw.launches["splitk_reduce"] += 1
    if q.bits is not None:
        sw.launches["emit_nan_fixup"] += 1


def _live_elements(c: GemmCase, om, cap: int, n_true: int) -> torch.Tensor:
    """The output elements the contract says are written (bool, flat)."""
    bm, _, bn = c.block
    if c.schedule == "compact_out":
        live = torch.zeros(cap, bm, bn, dtype=torch.bool)
        live[:min(n_true, cap)] = True
        return live.reshape(-1)
    return mmk._expand(om, bm, bn, c.m, c.n).reshape(-1)


def _check_gemm_outputs(sw: Sweep, c: GemmCase, results, want, om, cap,
                        n_true) -> None:
    bm, _, bn = c.block
    live = _live_elements(c, om, cap, n_true)
    if c.schedule == "compact_out":
        fi, jj, _ = build_queue_plain(om.reshape(-1, om.shape[-1]), cap)
        tiles = want[0].reshape(c.m // bm, bm, c.n // bn, bn)
        want_flat = tiles[fi.long(), :, jj.long(), :]
        want_flat[min(n_true, cap):] = 0
        want_flat = want_flat.reshape(-1)
    else:
        want_flat = want.reshape(-1)
    default = None
    for which, out, bits, counts in results:
        n_body = out.n
        words = out.words.cpu()
        lv = live[:n_body]
        if which == "default":
            never = int((words[lv] == POISON_WORD).sum())
            if never:
                sw.report("DOUBLE_WRITE", "masked_gemm:out",
                          f"{never} element(s) of live tiles never written "
                          f"(contract: every live tile written once)",
                          c.label)
            stray = int((words[~lv] != POISON_WORD).sum())
            if stray:
                sw.report("DOUBLE_WRITE", "masked_gemm:out",
                          f"{stray} element(s) of dead tiles written "
                          f"(contract: dead tiles untouched)", c.label)
            got = words.view(torch.float32)
            sel = lv & (words != POISON_WORD)
            err = float((got[sel] - want_flat[:n_body][sel]).abs().max()) \
                if bool(sel.any()) else 0.0
            scale = float(want_flat.abs().max()) if want_flat.numel() else 0.0
            sw.error(c.label, err, GEMM_RTOL * scale)
            if bits is not None:
                er, ec = c.emit
                want_bits = mmk.emit_bits(want, (er, ec)).reshape(-1)
                sw.error(f"{c.label}:bits",
                         0.0 if torch.equal(bits.words.cpu(), want_bits)
                         else 1.0, 0.0)
            default = words
        if "out" in counts:
            cnt = counts["out"]
            over = int((cnt[lv] > 1).sum())
            if over:
                sw.report("DOUBLE_WRITE", "masked_gemm:out",
                          f"{over} element(s) of live tiles stored "
                          f"{int(cnt.max())} times (contract: once)",
                          c.label)
            zero = int((cnt[lv] == 0).sum())
            if zero:
                sw.report("DOUBLE_WRITE", "masked_gemm:out",
                          f"{zero} element(s) of live tiles never stored "
                          f"(contract: once)", c.label)
            dead = int((cnt[~lv] > 0).sum())
            if dead:
                sw.report("DOUBLE_WRITE", "masked_gemm:out",
                          f"{dead} element(s) of dead tiles stored "
                          f"(contract: never)", c.label)
            unwritten = int(counts["unwritten"][0])
            if unwritten:
                sw.report("ACC_READ_BEFORE_WRITE", "splitk_reduce:ws",
                          f"{unwritten} workspace load(s) of partials no "
                          f"split wrote", c.label)
        if which == "shadow" and default is not None \
                and not torch.equal(words, default):
            sw.report("DOUBLE_WRITE", "masked_gemm:out",
                      "the shadow build's output differs from the default "
                      "build's (the instrumentation changed a result)",
                      c.label)


def run_member(sw: Sweep, lz, *, label: str) -> None:
    """``queue_member`` alone: the membership of a queue with a dead tail
    equal to the plain version's, the guards intact."""
    dev = lz.device
    om = (np.random.RandomState(3).rand(6, 5) < 0.5).astype(np.int32)
    fi, jj, nl = build_queue_plain(torch.as_tensor(om), om.size)
    member = Guarded(om.size, dev, fill="poison")
    lz.member(fi.to(dev), jj.to(dev), nl.to(dev), om.shape[1], member)
    sw.launches["queue_member"] += 1
    _check_guards(sw, label, "queue_member", member=member)
    want = torch.as_tensor(om.reshape(-1))
    sw.error(label, 0.0 if torch.equal(member.words.cpu(), want) else 1.0,
             0.0)


def run_fixup(sw: Sweep, lz, *, label: str) -> None:
    """The NaN fix-up alone over an output holding NaNs: their cells 0,
    the others as given."""
    dev = lz.device
    g, m, n, emit = 2, 12, 10, (4, 5)
    r = np.random.RandomState(4)
    val = r.randn(g, m, n).astype(np.float32)
    val[0, 1, 2] = np.nan
    val[1, 11, 9] = np.nan
    out = Guarded(g * m * n, dev)
    out.body(shape=(g, m, n)).copy_(torch.as_tensor(val, device=dev))
    cells = g * 3 * 2
    bits = Guarded(cells, dev)
    bits.words.fill_(1)
    lz.fixup(out, bits, (g, m, n), emit)
    sw.launches["emit_nan_fixup"] += 1
    _check_guards(sw, label, "emit_nan_fixup", out=out, bits=bits)
    want = mmk.emit_nan_fixup_plain(
        torch.as_tensor(val), torch.ones(g, 3, 2, dtype=torch.int32), emit)
    sw.error(label, 0.0 if torch.equal(bits.words.cpu(), want.reshape(-1))
             else 1.0, 0.0)


# ---------------------------------------------------------------------------
# The standard sweep, and the planted faults
# ---------------------------------------------------------------------------

def gemm_cases() -> List[GemmCase]:
    """Every path and schedule of the masked-GEMM launcher at small
    shapes: standard unsplit (289 tiles, two waves), split-K, group rows,
    group k, the overflow fallback, K6 and K7."""
    std = dict(g=1, m=272, k=32, n=272, block=(16, 16, 16))
    split = dict(g=2, m=40, k=64, n=36, block=(16, 16, 16))
    rows = dict(g=64, m=50, k=9, n=1, block=(16, 3, 1))
    gk = dict(g=40, m=4, k=600, n=2, block=(4, 64, 2))
    d2 = dict(g=1, m=64, k=64, n=64, block=(16, 16, 16))
    return [
        GemmCase("predicated", **std, schedule="predicated",
                 kernel="predicated_gemm", emit=(4, 4), mult=True),
        GemmCase("compact", **std, schedule="compact", kernel="compact_gemm",
                 emit=(4, 4), mult=True),
        GemmCase("overflow", **std, schedule="overflow",
                 kernel="compact_gemm", emit=(4, 4), mult=True),
        GemmCase("split:predicated", **split, schedule="predicated",
                 kernel="predicated_gemm", emit=(4, 4), mult=True),
        GemmCase("split:compact", **split, schedule="compact",
                 kernel="compact_gemm", emit=(4, 4), mult=True),
        GemmCase("rows:compact", **rows, schedule="compact",
                 kernel="compact_gemm", emit=(1, 1), mult=True),
        GemmCase("rows:predicated", **rows, schedule="predicated",
                 kernel="predicated_gemm", emit=(1, 1), mult=True),
        GemmCase("groupk:compact", **gk, schedule="compact",
                 kernel="compact_gemm", live=1.0),
        GemmCase("2d:predicated", **d2, schedule="predicated",
                 kernel="masked_matmul_2d", mult=True),
        GemmCase("2d:compact_out", **d2, schedule="compact_out",
                 kernel="compact_masked_matmul_2d"),
    ]


QUEUE_CASES = [
    ("queue:half", lambda r: (r.rand(4, 6) > 0.5).astype(np.int32), 24),
    ("queue:empty", lambda r: np.zeros((3, 5), np.int32), 15),
    ("queue:full", lambda r: np.ones((4, 4), np.int32), 16),
    ("queue:overflow", lambda r: np.ones((4, 4), np.int32), 5),
    ("queue:ragged", lambda r: (np.arange(7 * 3).reshape(7, 3) % 2)
     .astype(np.int32), 11),
    ("queue:past_tiles", lambda r: (r.rand(3, 3) > 0.4).astype(np.int32),
     12),
    ("queue:look_back", lambda r: (r.rand(80, 70) > 0.5).astype(np.int32),
     5600),
]

ENCODE_CASES = [
    # (label, relu, (m, n), gran): K1 on each encoder path, K5 on two.
    ("encode:quads", True, (37, 24), (1, 4)),
    ("encode:segments", True, (30, 64), (1, 32)),
    ("encode:thread", True, (19, 10), (2, 3)),
    ("encode:warp", True, (40, 40), (8, 8)),
    ("scan:flat", False, (37, 3), (1, 1)),
    ("scan:cells", False, (33, 20), (4, 5)),
]


def sweep(device=None, *, shadow: bool = True) -> Sweep:
    """The clean sweep: every kernel family on representative sparse
    geometries; with ``shadow`` the masked-GEMM cases run on the shadow
    build too (on the CPU the emulation always counts)."""
    lz = launchers(device)
    shadow_lz = launchers(device, shadow=True) \
        if shadow and isinstance(lz, CudaLaunchers) else None
    sw = Sweep()
    r = np.random.RandomState(0)
    for label, relu, (m, n), gran in ENCODE_CASES:
        x = torch.as_tensor(r.randn(m, n).astype(np.float32)
                            * (r.rand(m, n) > 0.6), device=lz.device)
        x[0, 0] = float("nan")
        run_encoder(sw, lz, x, gran, relu=relu, label=label)
    for label, make, cap in QUEUE_CASES:
        run_queue_builder(sw, lz, make(r), cap, label=label)
    for c in gemm_cases():
        run_gemm(sw, lz, c, shadow_lz=shadow_lz)
    run_member(sw, lz, label="queue_member")
    run_fixup(sw, lz, label="emit_nan_fixup")
    if lz.device.type == "cuda":
        torch.cuda.synchronize(lz.device)
    return sw


def sanitize_all(device=None) -> List[Violation]:
    """The kernel half of the zero-violation gate: the clean sweep's
    violations on ``device`` (default the card).  A kernel whose values
    disagree with its plain version raises: the codes name breaches of the
    write contract, not wrong values."""
    sw = sweep(device)
    bad = sw.bad_errors()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return sw.violations


PLANTS = ("short_output", "duplicate_slot", "extra_split", "queue_short",
          "tiles_overstated", "capacity_below_live")


def plant(name: str, device=None) -> Sweep:
    """Run one planted fault (``PLANTS``) and return what the sweep saw."""
    lz = launchers(device)
    shadow_lz = launchers(device, shadow=True) \
        if isinstance(lz, CudaLaunchers) else None
    sw = Sweep()
    std = dict(g=1, m=272, k=32, n=272, block=(16, 16, 16))
    split = dict(g=2, m=40, k=64, n=36, block=(16, 16, 16))
    if name == "short_output":
        run_gemm(sw, lz, GemmCase("plant:short_output", **std,
                                  schedule="predicated",
                                  kernel="predicated_gemm",
                                  short_output=True))
    elif name == "duplicate_slot":
        run_gemm(sw, lz, GemmCase("plant:duplicate_slot", **std,
                                  schedule="compact", kernel="compact_gemm",
                                  duplicate_slot=True), shadow_lz=shadow_lz)
    elif name == "extra_split":
        run_gemm(sw, lz, GemmCase("plant:extra_split", **split,
                                  schedule="predicated",
                                  kernel="predicated_gemm", extra_split=True),
                 shadow_lz=shadow_lz)
    elif name == "queue_short":
        run_queue_builder(sw, lz, np.ones((4, 4), np.int32), 8,
                          label="plant:queue_short", slots=7)
    elif name == "tiles_overstated":
        bmp = (np.arange(16).reshape(4, 4) % 2).astype(np.int32)
        run_queue_builder(sw, lz, bmp, 24, label="plant:tiles_overstated",
                          claimed_tiles=20)
    elif name == "capacity_below_live":
        sw.queue = run_queue_builder(sw, lz, np.ones((4, 4), np.int32), 5,
                                     label="plant:capacity_below_live")
        run_gemm(sw, lz, GemmCase("plant:capacity_below_live", **std,
                                  schedule="overflow", kernel="compact_gemm",
                                  emit=(4, 4), mult=True),
                 shadow_lz=shadow_lz)
    else:
        raise ValueError(f"unknown plant {name!r}; one of {PLANTS}")
    if lz.device.type == "cuda":
        torch.cuda.synchronize(lz.device)
    return sw


# ---------------------------------------------------------------------------
# compute-sanitizer
# ---------------------------------------------------------------------------

def compute_sanitizer_path() -> Optional[str]:
    """``compute-sanitizer`` beside the ``nvcc`` that ``_build`` finds."""
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        return None
    cand = os.path.join(os.path.dirname(os.path.realpath(nvcc)),
                        "compute-sanitizer")
    return cand if os.path.exists(cand) else shutil.which(
        "compute-sanitizer")


def compute_sanitizer_status(timeout: float = 120.0) -> str:
    """Whether memcheck can attach to a process that launches one of the
    port's kernels: ``"usable"``, or why not (the tool missing, or its own
    error line)."""
    tool = compute_sanitizer_path()
    if tool is None:
        return "missing: no compute-sanitizer beside nvcc"
    code = ("import sys; sys.path.insert(0, %r); import torch; "
            "from repro_torch.kernels.queue_builder import "
            "build_queue_kernel as q; "
            "q(torch.ones(2, 2, dtype=torch.int32, device='cuda'), "
            "capacity=4); torch.cuda.synchronize(); print('launched')"
            % os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))))
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    r = subprocess.run([tool, "--tool", "memcheck", sys.executable, "-c",
                        code], capture_output=True, text=True,
                       timeout=timeout, env=env)
    for line in (r.stdout + r.stderr).splitlines():
        if "Error:" in line and "=====" in line:
            return "unusable: " + line.strip("= ").strip()
    if r.returncode != 0 or "launched" not in r.stdout:
        return f"unusable: exit {r.returncode}"
    return "usable"
