"""Fused ReLU forward + block-bitmap encode: kernel K1, its plain version,
and the launch plan of the cell-bitmap encoder that K1 and K5 share.

Source note.  Replaces the TPU kernel ``repro/kernels/relu_encode.py``
(``relu_encode_kernel`` → ``_relu_encode_kernel``): y = max(z, 0) and, per
(gr, gc) cell, bit = any(y > 0) and no NaN in the cell (the reference's max
over the cell carries a NaN, and NaN > 0 is false).  The CUDA kernel is
``csrc/relu_encode.cu``, a launcher over the encoder of
``csrc/cell_encode.cuh``.  On the H100 it is bound by memory (8 bytes per
element plus 4 per cell): the encoder moves 16 bytes a lane, sizes the lanes
per cell to the cell (``encode_plan``), runs a grid-stride loop over a grid
sized to the card, and masks the ragged edge itself, so no padded copy is
made.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .shapes import block_bitmap

# Kernel launches since the last reset (plain-version calls are not counted).
launches = 0

SM_COUNT = 132                 # H100 SXM
THREADS = 256                  # threads per block
BLOCKS_PER_SM = 8              # 2,048 threads: a full SM
THREAD_CELL = 8                # thread path: elements per cell at most
                               # (kThreadCell in csrc/cell_encode.cuh)
MAX_INDEX = 2 ** 31 - 1        # the kernel indexes elements in 32 bits

QUADS, SEGMENTS, WARP, THREAD = "quads", "segments", "warp", "thread"
PATH_IDS = {QUADS: 0, SEGMENTS: 1, WARP: 2, THREAD: 3}


class EncodePlan(NamedTuple):
    """How one encode launch walks its operand (see csrc/cell_encode.cuh)."""
    path: str               # quads, segments, warp or thread
    lanes_per_cell: int     # lanes that share one cell (on the quads
                            # path one lane covers 4 // gc cells)
    vector: bool            # 16-byte loads (and stores)
    flat: bool              # quads: the operand walked as one row of M·N
    grid: int               # blocks of THREADS threads


@functools.lru_cache(maxsize=1024)
def encode_plan(m: int, n: int, gran: Tuple[int, int], aligned: bool,
                ld: Optional[int] = None,
                sm_count: int = SM_COUNT) -> EncodePlan:
    """The encoder's launch plan for an (m, n) float32 operand with row
    stride ``ld`` (default n: contiguous) at cell ``gran``; ``aligned``
    says that its data pointers (and K1's output) are 16-byte aligned.
    A pure function of these alone:

      * quads — gr == 1, gc in {1, 2, 4}, every row start 16-byte aligned
        or the operand contiguous with whole cells per row (then walked
        flat as one row of m·n): a lane takes 4 elements, 4 // gc cells;
      * segments — gr == 1, gc = 4·L with L in {2, 4, 8, 16, 32}, rows
        16-byte aligned: L lanes per cell, 32 // L cells a warp;
      * thread — any other cell of at most ``THREAD_CELL`` elements: a
        thread per cell, scalar;
      * warp — the rest: a warp per cell, 16-byte loads where rows allow.

    The grid covers the work, at most ``BLOCKS_PER_SM`` blocks per SM.
    Memoized: a training step asks for the same few plans every step."""
    gr, gc = gran
    if gr < 1 or gc < 1:
        raise ValueError(f"bad granularity {gran}")
    if m * n > MAX_INDEX:
        raise ValueError(f"encode of {m} x {n} elements: the kernel takes "
                         f"at most {MAX_INDEX}")
    ld = n if ld is None else ld
    rows16 = aligned and n % 4 == 0 and ld % 4 == 0
    cells = -(-m // gr) * -(-n // gc)

    def grid(threads):
        return max(1, min(-(-threads // THREADS), sm_count * BLOCKS_PER_SM))

    if gr == 1 and gc in (1, 2, 4):
        flat = aligned and (ld == n or m <= 1) and n % gc == 0
        if flat or rows16:
            quads = (m * n) // 4 if flat else m * (n // 4)
            return EncodePlan(QUADS, 1, True, flat, grid(quads))
    lanes = gc // 4
    if gr == 1 and rows16 and gc % 4 == 0 and lanes in (2, 4, 8, 16, 32):
        return EncodePlan(SEGMENTS, lanes, True, False, grid(cells * lanes))
    if gr * gc <= THREAD_CELL:
        return EncodePlan(THREAD, 1, False, False, grid(cells))
    return EncodePlan(WARP, 32, rows16 and gc % 4 == 0, False,
                      grid(cells * 32))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_encoder(fn, x: torch.Tensor, ld: int, y: Optional[torch.Tensor],
                   bits: torch.Tensor, gran: Tuple[int, int]) -> None:
    """Plan and launch one encode of ``x`` (K1 when ``y`` is given, else
    K5) through the C launcher ``fn``; raises on a failed launch."""
    m, n = x.shape
    aligned = x.data_ptr() % 16 == 0 and (y is None or y.data_ptr() % 16 == 0)
    plan = encode_plan(m, n, tuple(gran), aligned, ld=ld,
                       sm_count=_sm_count(x.device.index or 0))
    lead = (x.data_ptr(), y.data_ptr()) if y is not None \
        else (x.data_ptr(), ld)
    err = fn(*lead, bits.data_ptr(), m, n, *gran, PATH_IDS[plan.path],
             plan.lanes_per_cell, int(plan.vector), int(plan.flat),
             plan.grid, _build.stream_handle(x.device))
    _build.check(err, "relu_encode" if y is not None else "bitmap_scan")


def relu_encode_plain(z: torch.Tensor, gran: Tuple[int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (relu(z), (ceil(M/gr), ceil(N/gc)) int32
    any-positive bitmap, 0 where a cell holds a NaN)."""
    y = torch.relu(z)
    return y, block_bitmap(y, *gran)


def relu_encode(z: torch.Tensor, gran: Tuple[int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(relu(z), bitmap) for a 2-D float32 ``z`` at bitmap granularity
    ``gran``.  Launches K1 for a CUDA tensor; runs the plain version for a
    CPU tensor."""
    global launches
    if z.dim() != 2:
        raise ValueError(f"relu_encode wants a 2-D tensor, got {tuple(z.shape)}")
    if z.dtype != torch.float32:
        raise NotImplementedError(f"relu_encode: only float32, got {z.dtype}")
    gr, gc = gran
    if gr < 1 or gc < 1:
        raise ValueError(f"bad granularity {gran}")
    if z.device.type == "cpu":
        return relu_encode_plain(z, gran)
    if z.device.type != "cuda":
        raise ValueError(f"relu_encode: unsupported device {z.device}")
    if not z.is_contiguous():
        raise ValueError("relu_encode: z must be contiguous")
    m, n = z.shape
    lib = _build.load()
    y = torch.empty_like(z)
    bits = torch.empty((-(-m // gr), -(-n // gc)), dtype=torch.int32,
                       device=z.device)
    launch_encoder(lib.relu_encode_launch, z, n, y, bits, gran)
    launches += 1
    return y, bits
