"""Sparsity footprints, bitmaps and statistics (paper §3) — the port of
``repro.core.sparsity``, in torch over ``kernels.ref``.

The paper's two structural views of a (C, H, W) feature map:

  * Through-Channel (TC) sparsity — per spatial location, zeros along C.
    Drives INPUT sparsity.
  * Within-Channel (WC) sparsity — per channel, zeros across H×W.
    Drives OUTPUT sparsity.

On the card both become block bitmaps over a 2-D GEMM view of the tensor
(pixels × channels).  This module holds the element↔block "capture rate"
diagnostics and the footprint-identity check (forward activation footprint
== backward gradient footprint across a ReLU), the paper's central
theorem.  Every function takes tensors on any device and computes there.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ref as kref

block_any_nonzero = kref.block_any_nonzero
expand_block_mask = kref.expand_block_mask


def relu_mask(z: torch.Tensor) -> torch.Tensor:
    """σ'(z) for ReLU — the footprint captured in the forward pass, with
    σ'(0) = 0 (``z > 0``, not ``>=``)."""
    return (z > 0).to(z.dtype)


def element_sparsity(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exactly-zero elements."""
    return (x == 0).to(torch.float32).mean()


def block_sparsity(x2d: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Fraction of fully-zero (bm, bn) blocks in a 2-D view."""
    bitmap = block_any_nonzero(x2d, bm, bn)
    return 1.0 - bitmap.to(torch.float32).mean()


def capture_rate(x2d: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Fraction of zero *elements* that live inside fully-zero *blocks*:
    how much of the paper's element-granular skipping the block-granular
    schedule captures (1.0 when zeros are perfectly clustered)."""
    zeros = (x2d == 0).to(torch.float32)
    total_zero = zeros.sum()
    bitmap = block_any_nonzero(x2d, bm, bn)
    dead = expand_block_mask(1 - bitmap, bm, bn).to(torch.float32)
    captured = (zeros * dead).sum()
    return torch.where(total_zero > 0, captured / total_zero,
                       torch.ones_like(total_zero))


def tc_sparsity(x_chw: torch.Tensor) -> torch.Tensor:
    """Through-channel sparsity per (H, W) location: mean fraction of zero
    channels (paper §4.2, Fig. 7a)."""
    return (x_chw == 0).to(torch.float32).mean(dim=0)


def wc_sparsity(x_chw: torch.Tensor) -> torch.Tensor:
    """Within-channel sparsity per channel: fraction of zero pixels
    (paper §4.2, Fig. 7c)."""
    c = x_chw.shape[0]
    return (x_chw == 0).reshape(c, -1).to(torch.float32).mean(dim=1)


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    element: float
    block: float
    capture: float

    @staticmethod
    def of(x2d: torch.Tensor, bm: int, bn: int) -> "SparsityStats":
        return SparsityStats(
            element=float(element_sparsity(x2d)),
            block=float(block_sparsity(x2d, bm, bn)),
            capture=float(capture_rate(x2d, bm, bn)),
        )


def footprints_identical(fwd_act: torch.Tensor,
                         bwd_grad_pre: torch.Tensor) -> bool:
    """Paper §3.2: zeros of relu(z) ⊆ zeros of δ_pre = δ_post ⊙ σ'(z).

    Every location where the forward activation is zero must have zero
    pre-activation gradient (δ may have extra zeros where δ_post is 0: the
    containment is one-directional, which is what makes the forward
    footprint a safe skip-list)."""
    return not bool(((fwd_act == 0) & (bwd_grad_pre != 0)).any())
