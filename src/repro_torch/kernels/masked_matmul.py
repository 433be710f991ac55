"""Block-sparse GEMMs: kernels K3 (grouped compact), K4 (grouped
predicated), K6 (2-D predicated) and K7 (2-D compact, compacted output), and
their plain versions.

Source note.  K3 replaces the TPU kernel ``repro/kernels/masked_matmul.py``
(``grouped_compact_masked_matmul_kernel`` → ``_gmm_compact_kernel``); K4
replaces ``grouped_masked_matmul_kernel`` → ``_gmm_kernel``.  For a tile
(g, i, j) both compute Σ over k blocks with a_mask ∧ b_mask of A·B in f32,
then the ``_apply_epilogue`` stages: ×σ′ multiplier, and the any(|out| > 0)
bitmap of the post-σ′ values per (er, ec) cell.  Both are one CUDA
launcher, ``csrc/masked_matmul.cu``, in two grid modes: compact (the queue
slots s < n_live) and predicated (every out_mask tile).  Tiles and bits go
straight to their (g, i, j) place in a zero-filled output, operands are
read through their strides (so transposed operands need no copy), and
queue overflow is decided on the device: the compact launch exits when
n_live > capacity, the predicated fallback when it is not.  Full f32 FMA,
no TF32 or tensor cores; the kernels are bound by operations on the dense
GEMMs and by bytes on the degenerate depthwise ones.

The wrapper picks a path and a split count from the shape and the mask
block alone (``gemm_path``, ``split_plan``; never from the masks, the
capacity or the live count, so every schedule of one shape sums in one
order):

  * standard: a block owns a 128×128 register tile and covers its mask
    tile with it;
  * group rows, for the degenerate per-group FP and dX tiles of depthwise
    convs (N ≤ 8 columns in one tile, K·N ≤ 64): 32 groups per block, one
    per lane, since the group is the unit stride of the regrouped patches;
    each thread owns one (g, m) output row, and the tile is staged through
    shared memory so that stores, σ′ and bits walk m.  In compact mode a
    pre-pass marks the queue's tiles in a membership bitmap;
  * group k, for the degenerate per-group weight gradients (one M × N tile
    per group, M·N⁺ ≤ 32): 32 groups per block, the 8 warps split each k
    block and their sums are added in warp order;
  * split-K: a grid smaller than two waves of the H100 (a wave is the
    blocks the 132 SMs hold at once) is split along K into slices of whole
    mask k blocks (``split_bounds``), as many as fit in three waves, each of
    at least ``MIN_KBLOCKS_PER_SPLIT``.  Each slice writes raw partial sums into a
    (splits, G, M, N) workspace, and a second launch, the reduce, adds them
    in the order ``reduce_plan`` fixes from the shape (chunks of the
    splits in split order, then the chunks in order; no atomics: the same
    bits on every run), applies the epilogue and writes the live tiles it
    enumerates exactly as the GEMM launch did.  It is counted on
    ``splitk_reduce_launches``.

Two small launches go with the GEMM, inside its C launchers (one host
call a launch, as the dispatch is host-bound): the group-major compact
pre-pass (``queue_member_kernel``), and the NaN fix-up after every launch
that emits a bitmap (``emit_nan_fixup_kernel``: a cell whose output holds
a NaN gets bit 0, as in the reference).  ``_launch`` counts them from the
launcher's return; ``queue_member`` and ``emit_nan_fixup`` launch each
alone, against its plain version.

K6 and K7 replace the 2-D TPU kernels ``masked_matmul_kernel``
(``_mm_kernel``, ``_mm_epilogue_kernel``) and ``compact_masked_matmul_kernel``
(``_mm_compact_kernel``, ``_mm_compact_epilogue_kernel``).  No training path
runs them: as in the reference they are the frozen 2-D oracle that pins
``sparse_gemm(G=1)``.  They are the same launcher at G = 1 (always the
standard path, split as ``split_plan`` says), K6 in predicated mode and K7
in a compacted-output mode where the tile of slot s goes to slot s of an
(S, bm, bn) buffer, slots s ≥ n_active staying zero.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors.  Both forms write into a caller-provided zero-filled
``out``/``bits`` when given, so the compact launch and its overflow
fallback share one output and exactly one of them writes it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, ref
from .shapes import ceil_to, grid_shape

# Kernel launches since the last reset (plain-version calls are not counted).
compact_launches = 0
predicated_launches = 0
masked_2d_launches = 0
compact_2d_launches = 0
splitk_reduce_launches = 0
queue_member_launches = 0
emit_fixup_launches = 0

_PREDICATED, _COMPACT, _COMPACT_OUT = 0, 1, 2

Result = Tuple[torch.Tensor, Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def emit_bits(out: torch.Tensor, emit_gran: Tuple[int, int]) -> torch.Tensor:
    """(G, ⌈M/er⌉, ⌈N/ec⌉) int32 any(|out| > 0) bitmap of a (G, M, N)
    output — the ``bitmap_emit`` stage's plain form."""
    er, ec = emit_gran
    g, m, n = out.shape
    me, ne = ceil_to(m, er), ceil_to(n, ec)
    ob = torch.nn.functional.pad(out.abs(), (0, ne - n, 0, me - m))
    return (ob.reshape(g, me // er, er, ne // ec, ec).amax(dim=(2, 4)) > 0) \
        .to(torch.int32)


def _expand(mask, b0, b1, d0, d1):
    """A (G, ·, ·) block mask as a (G, d0, d1) bool map of its elements."""
    return ref.expand_block_mask(mask, b0, b1)[:, :d0, :d1].bool()


def _zero_dead(x, mask, b0, b1):
    return x if mask is None else torch.where(
        _expand(mask, b0, b1, *x.shape[1:]), x, 0.0)


def _masked_product(a, b, out_mask, a_mask, b_mask, block, mult):
    """The product the kernels compute: Σ over the k blocks with a_mask ∧
    b_mask of A·B, ×σ′, on the live output tiles; a dead tile is exactly 0.

    Dead blocks and tiles are cleared with ``torch.where``, so a NaN or an
    infinity in a skipped block never reaches the output, as in the kernels
    (a multiply by the mask would give NaN).  On finite operands one
    ``bmm`` of the zeroed operands sums in the kernels' terms.  Where a
    live operand block holds a non-finite value and meets a dead partner
    block (``inf · 0``), the k blocks are taken one at a time, each block
    product kept only where both its blocks are live, in k-block order."""
    bm, bk, bn = block
    g, m, k = a.shape
    n = b.shape[2]
    af = _zero_dead(a.float(), a_mask, bm, bk)
    bf = _zero_dead(b.float(), b_mask, bk, bn)
    exact = (a_mask is not None or b_mask is not None) and not (
        bool(af.isfinite().all()) and bool(bf.isfinite().all()))
    if not exact:
        out = torch.bmm(af, bf)
    else:
        nk = -(-k // bk)
        ni, nj = -(-m // bm), -(-n // bn)
        am = a_mask if a_mask is not None else torch.ones(
            g, ni, nk, dtype=torch.int32, device=a.device)
        bmk = b_mask if b_mask is not None else torch.ones(
            g, nk, nj, dtype=torch.int32, device=a.device)
        out = torch.zeros(g, m, n, dtype=torch.float32, device=a.device)
        for kb in range(nk):
            ks = slice(kb * bk, (kb + 1) * bk)
            pair = am[:, :, kb, None] * bmk[:, None, kb, :]    # (G, Mb, Nb)
            out += torch.where(_expand(pair, bm, bn, m, n),
                               torch.bmm(af[:, :, ks], bf[:, ks, :]), 0.0)
    if mult is not None:
        out = out * mult.float()
    return _zero_dead(out, out_mask, bm, bn)


def _write(out, bits, value, emit_gran):
    out.copy_(value)
    if bits is not None:
        bits.copy_(emit_bits(value, emit_gran))


def grouped_masked_matmul_plain(a, b, out_mask, a_mask, b_mask, *, block,
                                epilogue_mult, emit_gran, out, bits,
                                n_live=None, capacity=0) -> Result:
    """Plain version of K4: the full (G, Mb, Nb) grid; with ``n_live`` it
    is the overflow fallback and writes only when n_live > capacity."""
    if n_live is None or int(n_live[0]) > capacity:
        _write(out, bits, _masked_product(a, b, out_mask, a_mask, b_mask,
                                          block, epilogue_mult), emit_gran)
    return out, bits


def grouped_compact_masked_matmul_plain(a, b, fi, jj, n_live, a_mask, b_mask,
                                        *, block, epilogue_mult, emit_gran,
                                        out, bits) -> Result:
    """Plain version of K3: the tiles named by queue slots
    s < min(n_live, capacity); writes nothing when n_live > capacity."""
    nl, cap = int(n_live[0]), fi.numel()
    if nl > cap:
        return out, bits
    g, m, _ = a.shape
    ni, nj = grid_shape((m, b.shape[2]), (block[0], block[2]))
    tiles = torch.zeros((g * ni, nj), dtype=torch.int32, device=a.device)
    tiles[fi[:nl].long(), jj[:nl].long()] = 1
    _write(out, bits, _masked_product(a, b, tiles.reshape(g, ni, nj), a_mask,
                                      b_mask, block, epilogue_mult),
           emit_gran)
    return out, bits


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_mask(name, mask, shape, device):
    if mask is None:
        return
    if mask.dtype != torch.int32 or tuple(mask.shape) != shape:
        raise ValueError(f"{name} must be int32 of shape {shape}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != device or not mask.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _validate(a, b, out_mask, a_mask, b_mask, block, mult):
    """Check the operands, masks and multiplier of a grouped request."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"grouped GEMM wants 3-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(
            f"masked GEMM: only float32 operands, got {a.dtype}, {b.dtype}")
    dev = a.device
    if b.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if min(block) < 1:
        raise ValueError(f"bad block {block}")
    ni, nk, nj = grid_shape((m, k, n), block)
    _check_mask("out_mask", out_mask, (g, ni, nj), dev)
    _check_mask("a_mask", a_mask, (g, ni, nk), dev)
    _check_mask("b_mask", b_mask, (g, nk, nj), dev)
    if mult is not None and (mult.dtype != torch.float32
                             or tuple(mult.shape) != (g, m, n)
                             or mult.device != dev
                             or not mult.is_contiguous()):
        raise ValueError(f"epilogue_mult must be contiguous float32 "
                         f"{(g, m, n)} on {dev}")


def _prepare(a, b, out_mask, a_mask, b_mask, block, mult, emit_gran, out,
             bits):
    """Validate the operands and allocate the zero-filled outputs."""
    _validate(a, b, out_mask, a_mask, b_mask, block, mult)
    g, m, _ = a.shape
    n = b.shape[2]
    dev = a.device
    bm, _, bn = block
    if out is None:
        out = torch.zeros((g, m, n), dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (g, m, n)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError("out must be contiguous float32 (G, M, N)")
    if emit_gran is not None:
        er, ec = emit_gran
        if bm % er or bn % ec:
            raise ValueError(f"emit_gran {emit_gran} must divide ({bm}, {bn})")
        shape = (g, -(-m // er), -(-n // ec))
        if bits is None:
            bits = torch.zeros(shape, dtype=torch.int32, device=dev)
        elif (bits.dtype != torch.int32 or tuple(bits.shape) != shape
              or bits.device != dev or not bits.is_contiguous()):
            raise ValueError(f"bits must be contiguous int32 {shape}")
    elif bits is not None:
        raise ValueError("bits given without emit_gran")
    return out, bits


def _check_queue(rows, cols, count, device):
    """A queue is two (S,) and one (1,) contiguous int32 tensors."""
    for t in (rows, cols, count):
        if t.dtype != torch.int32 or t.device != device \
                or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"queue arrays must be contiguous 1-D int32 "
                             f"tensors on {device}")
    if rows.numel() != cols.numel() or count.numel() != 1:
        raise ValueError("queue arrays disagree in length")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The launch plan: a pure function of the shape and the mask block
# ---------------------------------------------------------------------------

SM_COUNT = 132                 # H100 SXM
MIN_KBLOCKS_PER_SPLIT = 2
REGISTER_TILE = 128            # the standard path's block tile edge
GROUP_LANES = 32               # groups per group-major block
ROWS_MAX_KN = 64               # group rows: K·N of B held in shared memory
K_MAX_MN = 32                  # group k: accumulators per thread

STANDARD, GROUP_ROWS, GROUP_K = 0, 1, 2
# Blocks of each split path that one SM holds at once (registers: 253 per
# thread on the standard path, 64 on group k; 256 threads a block).
RESIDENT = {STANDARD: 1, GROUP_K: 4}


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def gemm_path(g: int, m: int, k: int, n: int,
              block: Tuple[int, int, int]) -> int:
    """Which kernel path a (G, M, K, N) request on ``block`` takes:
    ``GROUP_ROWS`` for degenerate per-group FP/dX tiles (a few columns, one
    column tile, K·N ≤ 64), ``GROUP_K`` for degenerate per-group weight
    gradients (one M × N tile per group with M·N⁺ ≤ 32, N⁺ the next power
    of two), else ``STANDARD`` (the 128×128 register tile).  G = 1 always
    takes ``STANDARD``, so K6/K7 and ``sparse_gemm(G=1)`` share one path."""
    mb, _, nb = grid_shape((m, k, n), block)
    if g < 2 or n > 8 or nb != 1:
        return STANDARD
    if k * n <= ROWS_MAX_KN:
        return GROUP_ROWS
    if mb == 1 and m * _pow2_at_least(n) <= K_MAX_MN:
        return GROUP_K
    return STANDARD


def split_plan(g: int, m: int, k: int, n: int,
               block: Tuple[int, int, int]) -> int:
    """Split-K slices for a (G, M, K, N) request on ``block``.  A wave is
    what the card holds at once (``SM_COUNT`` × ``RESIDENT`` blocks).  A
    grid of two waves or more keeps one slice (so does the group rows path,
    whose K is short); a smaller one gets as many slices as fit in three
    waves, so that the last wave is nearly full, each of at least
    ``MIN_KBLOCKS_PER_SPLIT`` whole k blocks.  Never a function of the
    masks, the capacity or the live count, so every schedule of one shape
    sums in one order."""
    path = gemm_path(g, m, k, n, block)
    if path == GROUP_ROWS:
        return 1
    wave = SM_COUNT * RESIDENT[path]
    blocks = grid_blocks(g, m, k, n, block)
    if blocks >= 2 * wave:
        return 1
    kb = grid_shape((m, k, n), block)[1]
    return max(1, min(3 * wave // blocks, kb // MIN_KBLOCKS_PER_SPLIT))


def grid_blocks(g: int, m: int, k: int, n: int,
                block: Tuple[int, int, int]) -> int:
    """Blocks of the predicated GEMM launch before any split: 32 groups by
    ``min(64, 256 // N)`` rows (group rows), 32 groups (group k), or a
    block per 128×128 piece of every (g, i, j) tile (standard)."""
    bm, _, bn = block
    mb, _, nb = grid_shape((m, k, n), block)
    path = gemm_path(g, m, k, n, block)
    gchunks = -(-g // GROUP_LANES)
    if path == GROUP_ROWS:
        return gchunks * -(-m // min(64, 256 // n))
    if path == GROUP_K:
        return gchunks
    return g * mb * nb * -(-bm // REGISTER_TILE) * -(-bn // REGISTER_TILE)


def split_bounds(kb: int, splits: int):
    """The k-block range [lo, hi) of each split, as the kernel takes it
    (and the split range of each chunk of the reduce)."""
    return [(z * kb // splits, (z + 1) * kb // splits)
            for z in range(splits)]


class ReducePlan(NamedTuple):
    """How the split-K reduce adds S partials (``reduce_plan``)."""
    chunks: int     # C: split chunks, each summed in split order
    quads: int      # work units of 4 adjacent outputs a block (256 / C)
    grid: int       # blocks over the flat (G, M, N) workspace (group k),
    #                 or over one 128 × 128 piece of a tile (standard)


REDUCE_THREADS = 256
REDUCE_LOADS = 8              # loads a thread issues before its adds
REDUCE_MAX_CHUNKS = 64
REDUCE_MIN_LOADS = 4          # splits a chunk keeps when C grows to fill
REDUCE_FILL_THREADS = SM_COUNT * REDUCE_THREADS


def reduce_plan(path: int, g: int, m: int, n: int, splits: int
                ) -> ReducePlan:
    """The split-K reduce's plan for a (G, M, N) output of ``splits``
    partials on ``path``.  C doubles from 1 while a chunk holds more than
    ``REDUCE_LOADS`` splits, so that every load of a thread is in flight at
    once, or while the launch would have fewer threads than one block per
    SM and each chunk would keep ``REDUCE_MIN_LOADS`` splits; so C = 1 at
    small S (the FP/dX reduces of 2–7 splits sum in split order), and
    conv2's WG (79 splits, 9,216 units) gets C = 16: all 11.6 MB in flight.
    Never a function of the masks, the capacity or the live count, so every
    schedule of one shape sums in one order."""
    if splits < 2:
        raise ValueError(f"a reduce needs 2 splits or more, got {splits}")
    if path == GROUP_K:
        units = -(-g * m * n // 4)
    else:
        units = g * m * -(-n // 4)
    c = 1
    while c < REDUCE_MAX_CHUNKS and 2 * c <= splits and (
            -(-splits // c) > REDUCE_LOADS
            or (units * c < REDUCE_FILL_THREADS
                and splits // (2 * c) >= REDUCE_MIN_LOADS)):
        c *= 2
    quads = REDUCE_THREADS // c
    if path == GROUP_K:
        per = units
    else:
        per = min(m, REGISTER_TILE) * -(-min(n, REGISTER_TILE) // 4)
    return ReducePlan(c, quads, max(1, -(-per // quads)))


def splitk_reduce_plain(ws: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
    """The reduce's sum of a (S, G, M, N) workspace in the plan's order:
    each chunk's splits in split order, then the chunk sums in chunk
    order — the float32 adds the kernel does, so the two are bit-equal."""
    total = None
    for lo, hi in split_bounds(ws.shape[0], plan.chunks):
        part = ws[lo].clone()
        for z in range(lo + 1, hi):
            part += ws[z]
        total = part if total is None else total.add_(part)
    return total


def launch_args(mode, a, b, out, bits, out_mask, a_mask, b_mask, mult, fi,
                jj, n_live, capacity, block, emit_gran):
    """The C arguments of one GEMM launch and of its reduce launch (None
    when the plan does not split K: the GEMM launch's, the reduce plan
    before the stream), the split count, and the buffers they point at
    (workspace, membership), which must outlive the launches."""
    g, m, k = a.shape
    n = b.shape[2]
    er, ec = emit_gran if emit_gran is not None else (1, 1)
    path = gemm_path(g, m, k, n, block)
    splits = split_plan(g, m, k, n, block)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, g, m, n), dtype=torch.float32,
                         device=a.device)
    member = None
    if path != STANDARD and mode == _COMPACT:
        ni, _, nj = grid_shape((m, k, n), block)
        member = torch.empty(g * ni * nj, dtype=torch.int32, device=a.device)
    stream = _build.stream_handle(a.device)
    args = (a.data_ptr(), a.stride(0), a.stride(1), a.stride(2),
            b.data_ptr(), b.stride(0), b.stride(1), b.stride(2),
            out.data_ptr(), _ptr(bits), _ptr(out_mask), _ptr(a_mask),
            _ptr(b_mask), _ptr(mult), _ptr(fi), _ptr(jj), _ptr(n_live),
            _ptr(ws), _ptr(member), capacity, g, m, k, n, *block, er, ec,
            mode, path, splits)
    reduce_args = None
    if splits > 1:
        reduce_args = args + (*reduce_plan(path, g, m, n, splits), stream)
    return args + (stream,), reduce_args, splits, (ws, member)


def _launch(mode, a, b, out, bits, out_mask, a_mask, b_mask, mult, fi, jj,
            n_live, capacity, block, emit_gran):
    """One GEMM launch (with the group-major compact pre-pass, and the NaN
    fix-up when it emits unsplit), and its reduce launch (with the fix-up
    when it emits) when the plan splits K."""
    global splitk_reduce_launches, queue_member_launches, emit_fixup_launches
    g, m, _ = a.shape
    if g * m * b.shape[2] == 0 or (mode != _PREDICATED and capacity == 0):
        return
    args, reduce_args, splits, (_ws, member) = launch_args(
        mode, a, b, out, bits, out_mask, a_mask, b_mask, mult, fi, jj,
        n_live, capacity, block, emit_gran)
    lib = _build.load()
    _build.check(lib.masked_gemm_launch(*args), "masked_gemm")
    if member is not None:
        queue_member_launches += 1
    if splits > 1:
        _build.check(lib.masked_gemm_reduce_launch(*reduce_args),
                     "masked_gemm split-K reduce")
        splitk_reduce_launches += 1
    if bits is not None:
        emit_fixup_launches += 1


# ---------------------------------------------------------------------------
# The launches around the GEMM: membership pre-pass and NaN fix-up
# ---------------------------------------------------------------------------

def queue_member_plain(fi, jj, n_live, member, *, n_cols):
    """Plain version of ``queue_member``: member zero-filled, then
    member[fi[s]·Nb + jj[s]] = 1 for the slots s < n_live, nothing when
    n_live > capacity."""
    member.zero_()
    nl = int(n_live[0])
    if nl <= fi.numel():
        member[fi[:nl].long() * n_cols + jj[:nl].long()] = 1
    return member


def queue_member(fi: torch.Tensor, jj: torch.Tensor, n_live: torch.Tensor,
                 member: torch.Tensor, *, n_cols: int) -> torch.Tensor:
    """The group-major compact pre-pass alone, as the GEMM launcher runs
    it: zero-fills the (G·Mb·Nb,) int32 membership bitmap and marks the
    queue's live tiles in it, read by the group rows and group k kernels
    and the reduce in place of an out_mask.  Launches
    ``queue_member_kernel`` for CUDA tensors (counted on
    ``queue_member_launches``)."""
    global queue_member_launches
    _check_queue(fi, jj, n_live, fi.device)
    if member.dtype != torch.int32 or member.device != fi.device \
            or not member.is_contiguous():
        raise ValueError("member must be contiguous int32 on the queue's "
                         "device")
    if fi.device.type == "cpu":
        return queue_member_plain(fi, jj, n_live, member, n_cols=n_cols)
    _build.check(_build.load().queue_member_launch(
        fi.data_ptr(), jj.data_ptr(), n_live.data_ptr(), fi.numel(), n_cols,
        member.data_ptr(), member.numel(), _build.stream_handle(fi.device)),
        "queue_member")
    if fi.numel() > 0:
        queue_member_launches += 1
    return member


def emit_nan_fixup_plain(out, bits, emit_gran):
    """Plain version of ``emit_nan_fixup``: bits = 0 in every (er, ec) cell
    whose output holds a NaN."""
    bits[emit_bits(out.isnan().float(), emit_gran).bool()] = 0
    return bits


def emit_nan_fixup(out: torch.Tensor, bits: torch.Tensor,
                   emit_gran: Tuple[int, int]) -> torch.Tensor:
    """The NaN fix-up alone: a cell whose output holds a NaN gets bit 0, as
    the reference's max over the cell gives it.  The GEMM launchers run it
    after every emitting launch, where it returns at once unless that
    launch raised its NaN flag; alone it reads the whole output whatever
    the flag says.  Launches ``emit_nan_fixup_kernel`` for CUDA tensors
    (counted on ``emit_fixup_launches``)."""
    global emit_fixup_launches
    if out.device.type == "cpu":
        return emit_nan_fixup_plain(out, bits, emit_gran)
    g, m, n = out.shape
    _build.check(_build.load().emit_nan_fixup_launch(
        out.data_ptr(), bits.data_ptr(), g, m, n, *emit_gran,
        _build.stream_handle(out.device)), "emit_nan_fixup")
    if g * m * n > 0:
        emit_fixup_launches += 1
    return bits


def grouped_masked_matmul_kernel(
    a: torch.Tensor,                      # (G, M, K), any strides
    b: torch.Tensor,                      # (G, K, N), any strides
    out_mask: Optional[torch.Tensor],     # (G, Mb, Nb) int32 or None (live)
    a_mask: Optional[torch.Tensor],       # (G, Mb, Kb)
    b_mask: Optional[torch.Tensor],       # (G, Kb, Nb)
    *,
    block: Tuple[int, int, int],
    epilogue_mult: Optional[torch.Tensor] = None,   # (G, M, N)
    emit_gran: Optional[Tuple[int, int]] = None,
    out: Optional[torch.Tensor] = None,
    bits: Optional[torch.Tensor] = None,
    n_live: Optional[torch.Tensor] = None,
    capacity: int = 0,
) -> Result:
    """K4, the predicated schedule: every (g, i, j) tile whose out_mask bit
    is set.  With ``n_live`` it is the compact path's overflow fallback and
    runs only when n_live > capacity (decided on the device)."""
    global predicated_launches
    out, bits = _prepare(a, b, out_mask, a_mask, b_mask, block,
                         epilogue_mult, emit_gran, out, bits)
    if a.device.type == "cpu":
        return grouped_masked_matmul_plain(
            a, b, out_mask, a_mask, b_mask, block=block,
            epilogue_mult=epilogue_mult, emit_gran=emit_gran, out=out,
            bits=bits, n_live=n_live, capacity=capacity)
    if n_live is not None and (n_live.dtype != torch.int32
                               or n_live.device != a.device):
        raise ValueError("n_live must be int32 on the operands' device")
    _launch(_PREDICATED, a, b, out, bits, out_mask, a_mask, b_mask,
            epilogue_mult, None, None, n_live, capacity, block, emit_gran)
    predicated_launches += 1
    return out, bits


def grouped_compact_masked_matmul_kernel(
    a: torch.Tensor,                      # (G, M, K), any strides
    b: torch.Tensor,                      # (G, K, N), any strides
    fi: torch.Tensor,                     # (S,) int32 fused row g·Mb + i
    jj: torch.Tensor,                     # (S,) int32
    n_live: torch.Tensor,                 # (1,) int32 true live count
    a_mask: Optional[torch.Tensor],
    b_mask: Optional[torch.Tensor],
    *,
    block: Tuple[int, int, int],
    epilogue_mult: Optional[torch.Tensor] = None,
    emit_gran: Optional[Tuple[int, int]] = None,
    out: Optional[torch.Tensor] = None,
    bits: Optional[torch.Tensor] = None,
) -> Result:
    """K3, the compact schedule: one tile per queue slot s < n_live, written
    to its (g, i, j) place; does nothing when n_live > S (overflow)."""
    global compact_launches
    out, bits = _prepare(a, b, None, a_mask, b_mask, block, epilogue_mult,
                         emit_gran, out, bits)
    _check_queue(fi, jj, n_live, a.device)
    if a.device.type == "cpu":
        return grouped_compact_masked_matmul_plain(
            a, b, fi, jj, n_live, a_mask, b_mask, block=block,
            epilogue_mult=epilogue_mult, emit_gran=emit_gran, out=out,
            bits=bits)
    _launch(_COMPACT, a, b, out, bits, None, a_mask, b_mask, epilogue_mult,
            fi, jj, n_live, fi.numel(), block, emit_gran)
    compact_launches += 1
    return out, bits


# ---------------------------------------------------------------------------
# The 2-D launches K6 and K7 (block-aligned, float32, no bitmap emit)
# ---------------------------------------------------------------------------

def _check_2d(a, b, block, out_dtype):
    """The 2-D launches take block-aligned float32 requests only."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad 2-D operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if out_dtype != torch.float32:
        raise NotImplementedError(f"out_dtype {out_dtype}: only float32")
    (m, k), n = a.shape, b.shape[1]
    bm, bk, bn = block
    if m % bm or k % bk or n % bn:
        raise ValueError(f"shapes {(m, k, n)} are not multiples of the "
                         f"block {block}")


def _lift(*ts):
    return [None if t is None else t[None] for t in ts]


def masked_matmul_plain(a, b, out_mask, a_mask, b_mask, *, bm, bk, bn,
                        epilogue_mult=None) -> torch.Tensor:
    """Plain version of K6: the masked product, ×σ′."""
    return _masked_product(*_lift(a, b, out_mask, a_mask, b_mask),
                           (bm, bk, bn), *_lift(epilogue_mult))[0]


def masked_matmul_kernel(
    a: torch.Tensor,                      # (M, K) float32
    b: torch.Tensor,                      # (K, N) float32
    out_mask: torch.Tensor,               # (M/bm, N/bn) int32
    a_mask: torch.Tensor,                 # (M/bm, K/bk) int32
    b_mask: torch.Tensor,                 # (K/bk, N/bn) int32
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype=torch.float32,
    epilogue_mult: Optional[torch.Tensor] = None,   # (M, N) float32
) -> torch.Tensor:
    """K6, the 2-D predicated launch: the (M, N) product over the live
    out_mask tiles with dead operand blocks skipped, ×``epilogue_mult``.
    Shapes must be block-aligned."""
    global masked_2d_launches
    _check_2d(a, b, (bm, bk, bn), out_dtype)
    _validate(*_lift(a, b, out_mask, a_mask, b_mask), (bm, bk, bn),
              *_lift(epilogue_mult))
    if a.device.type == "cpu":
        return masked_matmul_plain(a, b, out_mask, a_mask, b_mask, bm=bm,
                                   bk=bk, bn=bn, epilogue_mult=epilogue_mult)
    out = torch.zeros((1, a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    _launch(_PREDICATED, *_lift(a, b), out, None,
            *_lift(out_mask, a_mask, b_mask, epilogue_mult), None, None,
            None, 0, (bm, bk, bn), None)
    masked_2d_launches += 1
    return out[0]


def compact_masked_matmul_plain(a, b, ii, jj, n_active, a_mask, b_mask, *,
                                bm, bk, bn, epilogue_mult=None
                                ) -> torch.Tensor:
    """Plain version of K7: slot s < n_active holds tile (ii[s], jj[s]) of
    the masked product ×σ′; the other slots are zero."""
    (m, _), n = a.shape, b.shape[1]
    full = _masked_product(*_lift(a, b, None, a_mask, b_mask), (bm, bk, bn),
                           *_lift(epilogue_mult))[0]
    tiles = full.reshape(m // bm, bm, n // bn, bn)[ii.long(), :, jj.long(), :]
    live = torch.arange(ii.numel(), device=a.device) < n_active[0]
    return torch.where(live[:, None, None], tiles, torch.zeros_like(tiles))


def compact_masked_matmul_kernel(
    a: torch.Tensor,                      # (M, K) float32
    b: torch.Tensor,                      # (K, N) float32
    ii: torch.Tensor,                     # (S,) int32 active tile rows
    jj: torch.Tensor,                     # (S,) int32 active tile cols
    n_active: torch.Tensor,               # (1,) int32 live slots
    a_mask: torch.Tensor,                 # (M/bm, K/bk) int32
    b_mask: torch.Tensor,                 # (K/bk, N/bn) int32
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype=torch.float32,
    epilogue_mult: Optional[torch.Tensor] = None,   # (M, N) float32
) -> torch.Tensor:
    """K7, the 2-D compact launch: the COMPACTED (S, bm, bn) output, slot s
    holding tile (ii[s], jj[s]) for s < n_active and zeros after; the caller
    scatters it to (M, N).  Shapes must be block-aligned."""
    global compact_2d_launches
    _check_2d(a, b, (bm, bk, bn), out_dtype)
    _validate(*_lift(a, b), None, *_lift(a_mask, b_mask), (bm, bk, bn),
              *_lift(epilogue_mult))
    _check_queue(ii, jj, n_active, a.device)
    if a.device.type == "cpu":
        return compact_masked_matmul_plain(
            a, b, ii, jj, n_active, a_mask, b_mask, bm=bm, bk=bk, bn=bn,
            epilogue_mult=epilogue_mult)
    out = torch.zeros((ii.numel(), bm, bn), dtype=torch.float32,
                      device=a.device)
    _launch(_COMPACT_OUT, *_lift(a, b), out, None, None,
            *_lift(a_mask, b_mask, epilogue_mult), ii, jj, n_active,
            ii.numel(), (bm, bk, bn), None)
    compact_2d_launches += 1
    return out
