"""Fused ReLU forward + block-bitmap encode: kernel K1 and its plain version.

Source note.  Replaces the TPU kernel ``repro/kernels/relu_encode.py``
(``relu_encode_kernel`` → ``_relu_encode_kernel``): y = max(z, 0) and, per
(gr, gc) cell, bit = any(y > 0).  The CUDA kernel is
``csrc/relu_encode.cu``.  On the H100 it is bound by memory (8 bytes per
element plus 4 per cell); one warp per cell reduces the bit with
``__any_sync`` in the same pass, with 16-byte loads where rows allow, and
masks the ragged edge itself, so no padded copy is made.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .shapes import block_bitmap

# Kernel launches since the last reset (plain-version calls are not counted).
launches = 0


def relu_encode_plain(z: torch.Tensor, gran: Tuple[int, int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (relu(z), (ceil(M/gr), ceil(N/gc)) int32
    any-positive bitmap)."""
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
    vec = int(gc % 4 == 0 and n % 4 == 0 and z.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    err = lib.relu_encode_launch(z.data_ptr(), y.data_ptr(), bits.data_ptr(),
                                 m, n, gr, gc, vec,
                                 _build.stream_handle(z.device))
    _build.check(err, "relu_encode")
    launches += 1
    return y, bits
