"""Shared shape/padding/bitmap helpers for the masked-GEMM stack.

The port of ``repro.kernels.shapes``: pure shape arithmetic with no policy
or kernel knowledge, so any layer may import it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref


def ceil_to(v: int, b: int) -> int:
    """Round ``v`` up to the next multiple of ``b``."""
    return -(-v // b) * b


def pad_to(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor up to (m, n) on the trailing edges."""
    pm, pn = m - x.shape[0], n - x.shape[1]
    if pm < 0 or pn < 0:
        raise ValueError(f"cannot pad {tuple(x.shape)} down to {(m, n)}")
    if pm == 0 and pn == 0:
        return x
    return F.pad(x, (0, pn, 0, pm))


def pad3(x: torch.Tensor, d1: int, d2: int) -> torch.Tensor:
    """Zero-pad a (G, ·, ·) tensor up to (G, d1, d2) on the trailing edges
    (the leading group axis is never padded)."""
    p1, p2 = d1 - x.shape[1], d2 - x.shape[2]
    if p1 < 0 or p2 < 0:
        raise ValueError(f"cannot pad {tuple(x.shape)} down to {(d1, d2)}")
    if p1 == 0 and p2 == 0:
        return x
    return F.pad(x, (0, p2, 0, p1))


def ones_bitmap(nb0: int, nb1: int, device=None) -> torch.Tensor:
    """All-live (nb0, nb1) tile bitmap — the ``mask=None`` (dense) meaning."""
    return torch.ones((nb0, nb1), dtype=torch.int32, device=device)


def pad_mask(mask: Optional[torch.Tensor], nb0: int, nb1: int,
             device=None) -> torch.Tensor:
    """A (≤nb0, ≤nb1) tile bitmap zero-padded to (nb0, nb1); ``None`` means
    dense ⇒ all-ones.  Padded tiles describe padded (all-zero) data."""
    if mask is None:
        return ones_bitmap(nb0, nb1, device)
    return pad_to(mask.to(torch.int32), nb0, nb1)


def pad_mask3(mask: Optional[torch.Tensor], g: int, nb0: int, nb1: int,
              device=None) -> torch.Tensor:
    """Grouped form of ``pad_mask``: (G, ≤nb0, ≤nb1) → (G, nb0, nb1)."""
    if mask is None:
        return torch.ones((g, nb0, nb1), dtype=torch.int32, device=device)
    return pad3(mask.to(torch.int32), nb0, nb1)


def block_bitmap(x: torch.Tensor, b0: int, b1: int) -> torch.Tensor:
    """Any-nonzero block bitmap of a 2-D tensor at tile (b0, b1), zero-padding
    ragged edges first (padding is dead data, so its bits are 0)."""
    m, n = x.shape
    return ref.block_any_nonzero(pad_to(x, ceil_to(m, b0), ceil_to(n, b1)),
                                 b0, b1)


def grid_shape(dims: Tuple[int, ...], block: Tuple[int, ...]
               ) -> Tuple[int, ...]:
    """Per-axis tile counts: ceil(dim / edge) for each (dim, edge) pair."""
    if len(dims) != len(block):
        raise ValueError(f"dims {dims} and block {block} differ in rank")
    return tuple(ceil_to(d, e) // e for d, e in zip(dims, block))
