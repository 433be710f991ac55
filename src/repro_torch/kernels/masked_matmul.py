"""Block-sparse GEMMs: kernels K3 (grouped compact), K4 (grouped
predicated), K6 (2-D predicated) and K7 (2-D compact, compacted output), and
their plain versions.

Source note.  K3 replaces the TPU kernel ``repro/kernels/masked_matmul.py``
(``grouped_compact_masked_matmul_kernel`` → ``_gmm_compact_kernel``); K4
replaces ``grouped_masked_matmul_kernel`` → ``_gmm_kernel``.  For a tile
(g, i, j) both compute Σ over k blocks with a_mask ∧ b_mask of A·B in f32,
then the ``_apply_epilogue`` stages: ×σ′ multiplier, and the any(|out| > 0)
bitmap of the post-σ′ values per (er, ec) cell.  Both are one CUDA kernel,
``csrc/masked_matmul.cu``, in two grid modes.  On the H100 they are bound
by operations (live-tile f32 FLOPs; full f32 FMA, no TF32 or tensor cores
in this version).  A block owns a 128×128 register tile and covers its
mask tile with it; A and B are read through their strides (so transposed
operands need no copy); tiles and bits are written straight to their
(g, i, j) place in a zero-filled output, so the TPU path's compacted buffer,
its scatter and the padded operand copies disappear; queue overflow is
decided on the device (see ``csrc/masked_matmul.cu``).

K6 and K7 replace the 2-D TPU kernels ``masked_matmul_kernel``
(``_mm_kernel``, ``_mm_epilogue_kernel``) and ``compact_masked_matmul_kernel``
(``_mm_compact_kernel``, ``_mm_compact_epilogue_kernel``).  No training path
runs them: as in the reference they are the frozen 2-D oracle that pins
``sparse_gemm(G=1)``.  They are the same CUDA kernel at G = 1, K6 in
predicated mode and K7 in a compacted-output mode where block s writes its
tile to slot s of an (S, bm, bn) buffer, slots s ≥ n_active staying zero;
like K3/K4 they are bound by operations.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors.  Both forms write into a caller-provided zero-filled
``out``/``bits`` when given, so the compact launch and its overflow
fallback share one output and exactly one of them writes it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref
from .shapes import ceil_to, grid_shape

# Kernel launches since the last reset (plain-version calls are not counted).
compact_launches = 0
predicated_launches = 0
masked_2d_launches = 0
compact_2d_launches = 0

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


def _masked_product(a, b, out_mask, a_mask, b_mask, block, mult):
    """The dense product with dead operand blocks zeroed and dead output
    tiles cleared — exactly the arithmetic the kernels do."""
    bm, bk, bn = block
    return ref.grouped_masked_matmul(a, b, out_mask, a_mask, b_mask, bm=bm,
                                     bk=bk, bn=bn, epilogue_mult=mult)


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


def _launch(mode, a, b, out, bits, out_mask, a_mask, b_mask, mult, fi, jj,
            n_live, capacity, block, emit_gran):
    g, m, k = a.shape
    n = b.shape[2]
    er, ec = emit_gran if emit_gran is not None else (1, 1)
    lib = _build.load()
    err = lib.masked_gemm_launch(
        a.data_ptr(), a.stride(0), a.stride(1), a.stride(2),
        b.data_ptr(), b.stride(0), b.stride(1), b.stride(2),
        out.data_ptr(), _ptr(bits), _ptr(out_mask), _ptr(a_mask),
        _ptr(b_mask), _ptr(mult), _ptr(fi), _ptr(jj), _ptr(n_live),
        capacity, g, m, k, n, *block, er, ec, mode,
        _build.stream_handle(a.device))
    _build.check(err, "masked_gemm")


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
    """Plain version of K6: the masked dense product, ×σ′."""
    return ref.masked_matmul(a, b, out_mask, a_mask, b_mask, bm=bm, bk=bk,
                             bn=bn, epilogue_mult=epilogue_mult)


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
    full = ref.masked_matmul(a, b, None, a_mask, b_mask, bm=bm, bk=bk, bn=bn,
                             epilogue_mult=epilogue_mult)
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
