"""Block any-nonzero bitmap of signed data: kernel K5 and its plain version.

Source note.  Replaces the TPU kernel ``repro/kernels/bitmap_scan.py``
(``bitmap_scan_kernel`` → ``_bitmap_scan_kernel``): per (gr, gc) cell of a
signed (M, N) tensor, bit = any(|x| > 0) and no NaN in the cell (the
reference's max over the cell carries a NaN).  It runs only where no ReLU
made the bitmap for free: the opt-in scan of raw signed inputs
(``SparsityPolicy.scan_signed_inputs``).  The CUDA kernel is
``csrc/bitmap_scan.cu``, a launcher over the encoder of
``csrc/cell_encode.cuh`` that K1 shares, on the plan of
``relu_encode.encode_plan``.  On the H100 it is bound by memory (4 bytes
per element plus 4 per cell) and, at the shapes a training step gives it,
by launch latency.  The kernel masks the ragged edge itself, so no padded
copy is made (the TPU wrapper pads to its launch slab).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import PLAIN_DEVICES

from . import _build, stats
from .relu_encode import launch_encoder
from .shapes import block_bitmap

# Kernel launches since the last reset (plain-version calls are not counted).
launches = 0


def bitmap_scan_plain(x: torch.Tensor, gran: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version: the (ceil(M/gr), ceil(N/gc)) int32
    any(|x| > 0) bitmap, 0 where a cell holds a NaN, the ragged edge
    zero-padded."""
    return block_bitmap(x, *gran)


def bitmap_scan(x: torch.Tensor, gran: Tuple[int, int]) -> torch.Tensor:
    """Bitmap of a 2-D float32 or bfloat16 ``x`` at granularity ``gran``.
    Launches K5 for a CUDA tensor (a bf16 ``x`` widened to f32 for it,
    which changes no sign and no NaN); runs the plain version for a CPU
    or meta tensor."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"bitmap_scan wants a 2-D tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"bitmap_scan: float32 or bfloat16 only, got {x.dtype}")
    gr, gc = gran
    if gr < 1 or gc < 1:
        raise ValueError(f"bad granularity {gran}")
    if x.device.type in PLAIN_DEVICES:
        return bitmap_scan_plain(x, gran)
    if x.device.type != "cuda":
        raise ValueError(f"bitmap_scan: unsupported device {x.device}")
    m, n = x.shape
    if n > 1 and x.stride(1) != 1:
        raise ValueError("bitmap_scan: x must have unit column stride")
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    lib = _build.load()
    bits = torch.empty((-(-m // gr), -(-n // gc)), dtype=torch.int32,
                       device=x.device)
    launch_encoder(lib.bitmap_scan_launch, x, x.stride(0), None, bits, gran)
    launches += 1
    stats.note_kernel("bitmap_scan", (x,), (bits,))
    return bits
