"""Pure-torch oracles: the port of ``repro.kernels.ref``.

The ground truth the kernels' plain versions and the CPU tests are held
against — exact block semantics: a masked GEMM equals masking the dense
product, because the paper's skipping is lossless.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Block bitmap helpers
# ---------------------------------------------------------------------------

def block_any_nonzero(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(M, N) -> (M//bm, N//bn) int32 bitmap; 1 where a block has any
    nonzero."""
    m, n = x.shape
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} not a multiple of "
                         f"({bm}, {bn})")
    xb = x.reshape(m // bm, bm, n // bn, bn)
    return (xb.abs().amax(dim=(1, 3)) > 0).to(torch.int32)


def expand_block_mask(mask: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """(Mb, Nb) bitmap -> (Mb*bm, Nb*bn) elementwise {0,1} map."""
    return mask.repeat_interleave(bm, dim=-2).repeat_interleave(bn, dim=-1)


# ---------------------------------------------------------------------------
# masked_matmul oracles
# ---------------------------------------------------------------------------

def masked_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    out_mask: Optional[torch.Tensor] = None,   # (M//bm, N//bn)
    a_mask: Optional[torch.Tensor] = None,     # (M//bm, K//bk)
    b_mask: Optional[torch.Tensor] = None,     # (K//bk, N//bn)
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype=torch.float32,
    epilogue_mult: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Oracle for the 2-D block-sparse GEMM:
    out[i, j] = Σ_k a[i, k] @ b[k, j] over k where both operand masks are
    set, and exact zeros where ``out_mask`` is clear."""
    return _masked_product(
        a[None], b[None],
        None if out_mask is None else out_mask[None],
        None if a_mask is None else a_mask[None],
        None if b_mask is None else b_mask[None],
        bm=bm, bk=bk, bn=bn, out_dtype=out_dtype,
        epilogue_mult=None if epilogue_mult is None else epilogue_mult[None],
    )[0]


def grouped_masked_matmul(
    a: torch.Tensor,                              # (G, M, K)
    b: torch.Tensor,                              # (G, K, N)
    out_mask: Optional[torch.Tensor] = None,      # (G, M//bm, N//bn)
    a_mask: Optional[torch.Tensor] = None,        # (G, M//bm, K//bk)
    b_mask: Optional[torch.Tensor] = None,        # (G, K//bk, N//bn)
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype=torch.float32,
    epilogue_mult: Optional[torch.Tensor] = None,  # (G, M, N)
) -> torch.Tensor:
    """Oracle for the grouped block-sparse GEMM: per-group semantics are
    exactly ``masked_matmul``'s; groups never mix."""
    return _masked_product(a, b, out_mask, a_mask, b_mask, bm=bm, bk=bk,
                           bn=bn, out_dtype=out_dtype,
                           epilogue_mult=epilogue_mult)


def _masked_product(a, b, out_mask, a_mask, b_mask, *, bm, bk, bn,
                    out_dtype, epilogue_mult):
    """Zero the dead operand blocks, multiply, clear the dead output tiles.
    Operands need not be block-aligned: a mask covers the ragged edge with
    its last tile, and the expanded mask is cut to the operand's extent."""
    _, m, k = a.shape
    n = b.shape[2]

    def expand(mask, b0, b1, d0, d1):
        return expand_block_mask(mask.to(torch.float32), b0, b1)[:, :d0, :d1]

    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    if a_mask is not None:
        af = af * expand(a_mask, bm, bk, m, k)
    if b_mask is not None:
        bf = bf * expand(b_mask, bk, bn, k, n)
    out = torch.bmm(af, bf)
    if out_mask is not None:
        out = out * expand(out_mask, bm, bn, m, n)
    if epilogue_mult is not None:
        out = out * epilogue_mult.to(torch.float32)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# relu_encode oracle
# ---------------------------------------------------------------------------

def relu_encode(z: torch.Tensor, *, bm: int, bn: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused forward ReLU + block-bitmap encode: (relu(z), bitmap) with
    bitmap[i, j] == 1 iff block (i, j) of relu(z) has a positive element."""
    y = torch.relu(z)
    return y, block_any_nonzero(y, bm, bn)


# ---------------------------------------------------------------------------
# relu_bwd_masked oracle
# ---------------------------------------------------------------------------

def relu_bwd_masked(
    dy: torch.Tensor,          # (M, K)
    w_t: torch.Tensor,         # (K, N)
    relu_mask: torch.Tensor,   # (M, N) {0,1}
    *,
    bm: int,
    bk: int,
    bn: int,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """δ_pre = (δ_post @ Wᵀ) ⊙ σ'(z) — the plain dense expression."""
    out = (dy.to(torch.float32) @ w_t.to(torch.float32)) \
        * relu_mask.to(torch.float32)
    return out.to(out_dtype)
