"""SparseTensor — the bitmap carrier threading FP sparsity into BP (the port
of ``repro.core.sparse_tensor``).

A ``SparseTensor`` holds a fine-granularity block bitmap computed exactly
once (by the fused ``relu_encode`` on the hot
path).  Every mask a backward GEMM needs is then *derived* by
``coarsen_bitmap`` (OR-reduce fine cells into coarser tiles) and transposes
— exact, never a rescan of the data.

The backward-pass hand-off keeps the reference's design: the dX GEMM of
layer L+1 emits the bitmap of its output (layer L's dy) and registers it
against the EXACT tensor object it returns; layer L's backward looks up the
object autograd hands it.  PyTorch's autograd engine passes a backward's
returned tensor on unchanged when nothing lies between the two nodes, and
the registry's strong reference keeps the Python object alive, so identity
holds; a miss only loses skipping, never numerics, and is counted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import stats


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def coarsen_bitmap(bitmap: torch.Tensor, gran: Tuple[int, int],
                   block: Tuple[int, int]) -> torch.Tensor:
    """(M/gr, N/gc) fine bitmap -> (ceil(M/B0), ceil(N/B1)) coarse bitmap.

    Exact: a coarse cell is the OR of its fine cells; ragged edges are
    zero-padded.  A 3-D bitmap is a batch of 2-D bitmaps over its leading
    (group) axis."""
    gr, gc = gran
    b0, b1 = block
    if b0 % gr or b1 % gc:
        raise ValueError(f"block {block} is not a multiple of gran {gran}")
    f0, f1 = b0 // gr, b1 // gc
    with stats.lifecycle_scope("derive", "coarsen"):
        r, c = bitmap.shape[-2:]
        rp, cp = _ceil_div(r, f0) * f0, _ceil_div(c, f1) * f1
        if rp != r or cp != c:
            bitmap = F.pad(bitmap, (0, cp - c, 0, rp - r))
        lead = bitmap.shape[:-2]
        return bitmap.reshape(*lead, rp // f0, f0, cp // f1, f1) \
            .amax(dim=(-3, -1)).to(torch.int32)


@dataclasses.dataclass
class SparseTensor:
    """The once-computed fine nonzero bitmap of a tensor's 2-D view (the
    tensor itself for a GEMM, the (N·H·W, C) view of an NHWC activation for
    a conv) and its granularity.  Unlike the reference's pytree, it carries
    no payload: the autograd Functions keep their tensors in
    ``save_for_backward``.  ``bitmap`` is None when the policy needs no
    sparsity metadata."""
    bitmap: Optional[torch.Tensor]
    gran: Optional[Tuple[int, int]]

    def mask_for(self, block: Tuple[int, int]) -> Optional[torch.Tensor]:
        """Block bitmap of the 2-D view at tile shape ``block``."""
        if self.bitmap is None:
            return None
        return coarsen_bitmap(self.bitmap, self.gran, block)

    def t_mask_for(self, block: Tuple[int, int]) -> Optional[torch.Tensor]:
        """Block bitmap of the TRANSPOSED 2-D view at ``block``."""
        if self.bitmap is None:
            return None
        gr, gc = self.gran
        return coarsen_bitmap(self.bitmap.t(), (gc, gr), block)


# ---------------------------------------------------------------------------
# Granularity selection
# ---------------------------------------------------------------------------

def linear_act_granularity(block: Tuple[int, int, int]) -> Tuple[int, int]:
    """Finest granularity serving an activation X (T, K) of a GEMM layer."""
    bm, bk, bn = block
    gr = math.gcd(bm, bk)
    return gr, math.gcd(gr, bn)


def linear_grad_granularity(block: Tuple[int, int, int]) -> Tuple[int, int]:
    """Finest granularity serving an incoming gradient dY (T, N)."""
    bm, bk, bn = block
    return math.gcd(bm, bk), math.gcd(bk, bn)


def conv_channel_granularity(channels: int,
                             block: Tuple[int, int, int],
                             groups: int = 1) -> int:
    """Channel granularity for a conv tensor's (pixels, channels) view: it
    divides C//groups and every block edge a derived mask can take."""
    bm, bk, bn = block
    if channels % groups:
        raise ValueError(f"{channels} channels in {groups} groups")
    per_group = channels // groups
    return math.gcd(math.gcd(per_group, bm), math.gcd(bk, bn))


# ---------------------------------------------------------------------------
# Backward-pass bitmap hand-off — producer GEMM → consumer layer
# ---------------------------------------------------------------------------

# A bounded ring matched by ``is``, sized like the reference's so every WG
# bitmap of a vgg16 backward survives the whole pass.
_GRAD_BITMAP_RING_SIZE = 64
_GRAD_BITMAPS: list = []

# Fault-injection tap (``runtime/faults.py``): an installed hook may veto a
# registration (the "registry drop" fault class), so the chaos matrix can
# show a missed hand-off is detected (``registry:miss``) and survived.
_REGISTER_HOOK = None


def set_register_hook(fn):
    """Install (or, with None, remove) the registry fault hook; returns the
    previous hook.  The hook receives ``(obj, bitmap, gran)`` and returns
    False to drop the registration."""
    global _REGISTER_HOOK
    prev, _REGISTER_HOOK = _REGISTER_HOOK, fn
    return prev


def register_grad_bitmap(obj, bitmap: Optional[torch.Tensor],
                         gran: Tuple[int, int]) -> None:
    """Record ``bitmap`` (granularity ``gran``) as describing the 2-D view
    of gradient tensor ``obj``.  No-op when ``bitmap`` is None."""
    if bitmap is None:
        return
    if _REGISTER_HOOK is not None \
            and _REGISTER_HOOK(obj, bitmap, gran) is False:
        return
    _GRAD_BITMAPS.append((obj, bitmap, gran))
    if len(_GRAD_BITMAPS) > _GRAD_BITMAP_RING_SIZE:
        del _GRAD_BITMAPS[0]


def lookup_grad_bitmap(obj, *, peek: bool = False):
    """The ``(bitmap, gran)`` registered for this exact gradient object, or
    None; hits and misses are counted unless ``peek``."""
    for entry, bitmap, gran in reversed(_GRAD_BITMAPS):
        if entry is obj:
            if not peek:
                stats.record("registry:hit")
            return bitmap, gran
    if not peek:
        stats.record("registry:miss")
    return None


# ---------------------------------------------------------------------------
# Bitmap computation — the ONLY function that scans tensor-sized data
# ---------------------------------------------------------------------------

def scan_bitmap(x2d: torch.Tensor, gran: Tuple[int, int],
                *, kind: str = "act", impl: str = "xla_ref") -> torch.Tensor:
    """One counted dense scan -> fine bitmap, for signed data where no fused
    encode produced one.  ``impl="pallas"`` runs the ``bitmap_scan`` kernel
    (counted as ``scan_pallas:<kind>``); otherwise a plain scan (counted as
    ``scan:<kind>``)."""
    if impl == "pallas":
        return kops.bitmap_scan(x2d, block=gran, kind=kind)
    gr, gc = gran
    m, n = x2d.shape
    mp, np_ = _ceil_div(m, gr) * gr, _ceil_div(n, gc) * gc
    stats.record(f"scan:{kind}")
    with stats.lifecycle_scope("scan", kind):
        if mp != m or np_ != n:
            x2d = F.pad(x2d, (0, np_ - n, 0, mp - m))
        return kref.block_any_nonzero(x2d.to(torch.float32), gr, gc)
