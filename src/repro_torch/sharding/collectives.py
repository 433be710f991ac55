"""Bitmap-aware gradient collectives — sparsity on the wire; the port of
``repro.sharding.collectives`` on ``torch.distributed``.

A data-parallel gradient all-reduce moves every block of ``dW`` across the
ranks even when the WG masks already proved most blocks exactly zero.
``sparse_psum`` is the bitmap-aware all-reduce.  On every rank it:

  1. coarsens the fine bitmap to the wire-block granularity
     (``core.sparse_tensor.coarsen_bitmap``; never a rescan);
  2. all-reduces the tiny block bitmap (``collective:bitmap_psum``): the
     union says which blocks are live on some rank;
  3. gathers the union-live blocks into a buffer of static capacity
     ``ceil(cutoff · nblocks)`` (prefix-sum compaction) and all-reduces
     that (``collective:compressed``), scattering the sums back into
     zeros — exact, because a union-dead block is zero on every rank;
  4. all-reduces the whole tensor (``collective:dense_fallback``) when the
     union's live count exceeds the capacity.

The reference chooses between 3 and 4 with ``lax.cond`` on the device.
Eager PyTorch must choose which collective to launch on the host, so the
union's live count is read back: the union is all-reduced, so every rank
reads the same count and takes the same branch.  ``psum_grads`` all-reduces
the bitmaps of every leaf in one flat buffer and reads all their counts in
one device→host copy, then launches each leaf's reduce in order, the
leaves without a bitmap through ``dense_psum`` as in the reference.

A mesh without a process group (``launch.mesh``) makes every reduce the
identity, the reference's one-device mesh.  Counts: the trace-time keys
(``collective:bitmap_psum``, ``collective:dense``) count once per leaf on
each rank; the runtime keys (``collective:compressed``,
``collective:dense_fallback``) once per rank, so their sum over ranks is
the reference's count over shards.

Fault site (``runtime/faults.py``): ``collective:allreduce`` — an armed
hook may tamper with one rank's compact-buffer contribution.  The dense
paths are never tampered: falling back to them is the survival story.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.core.sparse_tensor import coarsen_bitmap, lookup_grad_bitmap
from repro_torch.kernels import stats

AxisNames = Union[str, Sequence[str]]

# Fault-injection tap (runtime/faults.py installs here; this layer never
# imports runtime).  The hook receives ``(site, contrib, index, size)``:
# this rank's compact buffer, its index over the reduced axes and their
# size, and returns the (possibly tampered) contribution.
_COLLECTIVE_HOOK = None


def set_collective_hook(fn):
    """Install (or, with None, remove) the collective fault hook; returns
    the previous hook."""
    global _COLLECTIVE_HOOK
    prev, _COLLECTIVE_HOOK = _COLLECTIVE_HOOK, fn
    return prev


def _axes(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _all_reduce_(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axes`` (the identity on a
    mesh without a process group)."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


# Bytes this process handed to all-reduces since the last reset (each
# reduce's payload once, whatever the algorithm moves): the wire metric
# of the distribution layer.
_WIRE = {"bytes": 0}


def wire_bytes() -> int:
    return _WIRE["bytes"]


def reset_wire_bytes() -> None:
    _WIRE["bytes"] = 0


def _count_wire(t: torch.Tensor, mesh, axes) -> None:
    if mesh.group(axes) is not None:
        _WIRE["bytes"] += t.numel() * t.element_size()


def _reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A reduced copy of ``t`` (``t`` itself on a mesh without a group)."""
    if mesh.group(axes) is None:
        return t
    out = t.clone()
    _count_wire(out, mesh, axes)
    return _all_reduce_(out, mesh, axes)


def _record_runtime(kind: str, flag: bool) -> None:
    stats.record_at_runtime(kind, torch.tensor(int(flag)))


def dense_psum(x: torch.Tensor, axis_name: AxisNames, *,
               mesh) -> torch.Tensor:
    """The tagged dense all-reduce — the path for bitmap-less gradients."""
    stats.record("collective:dense")
    with stats.lifecycle_scope("collective", "dense"):
        return _reduce(x, mesh, _axes(axis_name))


def psum_scalar(x: torch.Tensor, axis_name: AxisNames, *, mesh):
    """Tagged scalar reduction (losses, metrics) — tiny, always dense."""
    with stats.lifecycle_scope("collective", "scalar"):
        return _reduce(x, mesh, _axes(axis_name))


def _compact_queue(live_flat: torch.Tensor, capacity: int) -> torch.Tensor:
    """Prefix-sum compaction of live block ids into a fixed-capacity queue:
    entry ``q`` is the flat id of the q-th live block; unused slots hold
    the sentinel ``nblk``."""
    nblk = live_flat.shape[0]
    pos = torch.cumsum(live_flat, 0) - 1
    slot = torch.where((live_flat > 0) & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    queue = torch.full((capacity + 1,), nblk, dtype=torch.int64,
                       device=live_flat.device)
    queue.scatter_(0, slot.to(torch.int64),
                   torch.arange(nblk, device=live_flat.device))
    return queue[:capacity]


def _block_view(x: torch.Tensor, block: Tuple[int, int]):
    """(M, N) → (mt, b0, nt, b1) zero-padded 4-D block view + the grid.  A
    pure reshape (no transpose copy): block (i, j) is ``view[i, :, j, :]``,
    so the compressed path's local traffic stays proportional to the
    capacity, not the tensor."""
    b0, b1 = block
    m, n = x.shape
    mt, nt = -(-m // b0), -(-n // b1)
    if (mt * b0, nt * b1) != (m, n):
        x = torch.nn.functional.pad(x, (0, nt * b1 - n, 0, mt * b0 - m))
    return x.reshape(mt, b0, nt, b1), (mt, nt)


def _capacity(nblk: int, cutoff: float) -> int:
    return max(1, int(math.ceil(cutoff * nblk)))


def _compressed(x: torch.Tensor, live_flat: torch.Tensor, capacity: int,
                block: Tuple[int, int], mesh, axes) -> torch.Tensor:
    with stats.lifecycle_scope("collective", "compressed"):
        queue = _compact_queue(live_flat, capacity)
        x4, (mt, nt) = _block_view(x, block)
        qi, qj = queue // nt, queue % nt
        # The sentinel id nblk is row mt: the gather reads a real block
        # into a dead slot instead (harmless), and the scatter writes dead
        # slots to a dump row that is cut off, so they never reach the
        # output.
        contrib = x4[qi.clamp(max=mt - 1), :, qj, :]   # (capacity, b0, b1)
        if _COLLECTIVE_HOOK is not None:
            contrib = _COLLECTIVE_HOOK(
                "collective:allreduce", contrib, mesh.axis_index(axes),
                math.prod(mesh.shape[a] for a in axes))
        _count_wire(contrib, mesh, axes)
        summed = _all_reduce_(contrib, mesh, axes)
        out4 = torch.zeros((mt + 1, x4.shape[1], nt, x4.shape[3]),
                           dtype=summed.dtype, device=x.device)
        out4[qi, :, qj, :] = summed
        return out4[:mt].reshape(mt * x4.shape[1], nt * x4.shape[3])[
            :x.shape[0], :x.shape[1]].to(x.dtype)


def _dense_fallback(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    with stats.lifecycle_scope("collective", "dense"):
        return _reduce(x, mesh, axes)


def _coarse(bitmap, gran, block):
    b0, b1 = block or tuple(gran)
    blk = bitmap if (b0, b1) == tuple(gran) \
        else coarsen_bitmap(bitmap, tuple(gran), (b0, b1))
    return blk.to(torch.int32), (b0, b1)


def sparse_psum(x: torch.Tensor, bitmap: torch.Tensor,
                gran: Tuple[int, int], *, mesh, axis_name: AxisNames,
                block: Optional[Tuple[int, int]] = None,
                cutoff: float = 0.5, return_bits: bool = False):
    """Bitmap-compressed all-reduce of a 2-D gradient over ``axis_name``
    of ``mesh``.

    ``bitmap`` is this rank's fine bitmap of ``x`` at granularity ``gran``
    (emitted or derived, never rescanned here); ``block`` the wire-block
    granularity it is coarsened to (default ``gran``); ``cutoff`` the
    compressed path's capacity as a fraction of the block count.  Returns
    the all-reduced gradient; with ``return_bits=True`` also the union
    block bitmap (``(mt, nt)`` int32 live counts) for
    ``runtime.guards.StepGuard.probe_emit``."""
    if x.ndim != 2:
        raise ValueError(f"sparse_psum wants a 2-D view, got {x.shape}")
    axes = _axes(axis_name)
    blk, block = _coarse(bitmap, gran, block)
    with stats.lifecycle_scope("collective", "bitmap"):
        stats.record("collective:bitmap_psum")
        union = _reduce(blk, mesh, axes)
    live_flat = (union > 0).to(torch.int32).reshape(-1)
    nblk = live_flat.shape[0]
    capacity = _capacity(nblk, cutoff)
    if capacity >= nblk:
        # The cutoff admits every block: compression cannot move fewer
        # bytes than the dense reduce.
        out = dense_psum(x, axes, mesh=mesh)
        return (out, union) if return_bits else out
    count = int(live_flat.sum())          # the same on every rank
    out = _dense_fallback(x, mesh, axes) if _overflows(count, capacity) \
        else _compressed(x, live_flat, capacity, block, mesh, axes)
    return (out, union) if return_bits else out


def _overflows(count: int, capacity: int) -> bool:
    """The branch every rank takes (``count`` is read from the all-reduced
    union, so it is the same on every rank), counted at run time."""
    overflow = count > capacity
    _record_runtime("collective:dense_fallback", overflow)
    _record_runtime("collective:compressed", not overflow)
    return overflow


def psum_grads(grads: Any, *, mesh, axis_name: AxisNames,
               cutoff: float = 0.5,
               block: Optional[Tuple[int, int]] = None) -> Any:
    """All-reduce a gradient tree: leaves whose bitmap the backward pass
    registered (``core.sparse_tensor.register_grad_bitmap``) go through the
    bitmap-compressed path; everything else takes the dense all-reduce.

    The registry consult is a PEEK: most leaves legitimately have no
    bitmap, and those misses must not count against the guard's
    ``registry:miss`` budget.  It matches by identity, so ``grads`` must
    hold the very tensors ``torch.autograd.grad`` returned."""
    axes = _axes(axis_name)
    leaves = _tree.leaves(grads)
    sparse = {}                 # leaf index → (coarse bitmap, wire block)
    for i, leaf in enumerate(leaves):
        hit = lookup_grad_bitmap(leaf, peek=True) \
            if getattr(leaf, "ndim", 0) == 2 else None
        if hit is not None:
            sparse[i] = _coarse(hit[0], hit[1], block)
    decided = {}                # leaf index → (live blocks, live count)
    if sparse:
        # Every leaf's bitmap in one all-reduce, every live count in one
        # device→host copy.
        with stats.lifecycle_scope("collective", "bitmap"):
            union = _reduce(torch.cat([b.reshape(-1)
                                       for b, _ in sparse.values()]),
                            mesh, axes)
        lives = ((union > 0).to(torch.int32)
                 .split([b.numel() for b, _ in sparse.values()]))
        counts = torch.stack([lv.sum() for lv in lives]).tolist()
        decided = dict(zip(sparse, zip(lives, counts)))
    out = []
    for i, leaf in enumerate(leaves):
        if i not in sparse:
            out.append(dense_psum(leaf, axes, mesh=mesh))
            continue
        stats.record("collective:bitmap_psum")
        live_flat, count = decided[i]
        capacity = _capacity(live_flat.shape[0], cutoff)
        if capacity >= live_flat.shape[0]:
            out.append(dense_psum(leaf, axes, mesh=mesh))
        elif _overflows(count, capacity):
            out.append(_dense_fallback(leaf, mesh, axes))
        else:
            out.append(_compressed(leaf, live_flat, capacity,
                                   sparse[i][1], mesh, axes))
    return _tree.unflatten_like(grads, out)
