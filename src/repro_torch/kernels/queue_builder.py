"""On-device work-queue construction: kernel K2, its plain version, and the
argsort reference builder.

Source note.  Replaces the TPU kernel ``repro/kernels/queue_builder.py``
(``build_queue_kernel`` → ``_queue_builder_kernel``): row-major stream
compaction of a tile bitmap into ``(ii, jj, n_live)``, in the order of
``repro.core.workredist.static_queue_order``; ``n_live`` is the true
set-bit count and may exceed the capacity; dead slots hold (0, 0).  The
CUDA kernel is ``csrc/queue_builder.cu``.  On the H100 it is bound by launch
latency, then one pass over the bitmap's bytes: blocks of 4,096 tiles, 16 a
thread read as int4, a popc/shuffle scan in each block and a decoupled
look-back across blocks (one block, no look-back, up to 4,096 tiles), in
place of the TPU's sequential grid with its SMEM carry.  Nothing is
zero-filled before the launch: the dead tiles write the dead slots.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build, stats

# Kernel launches since the last reset (plain-version calls are not counted).
launches = 0
# 65,536 blocks of 4,096 tiles: the kernel's status words.
MAX_TILES = 2 ** 28

Queue = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(bitmap: torch.Tensor, capacity: int) -> None:
    if bitmap.dim() != 2:
        raise ValueError(f"queue bitmap must be 2-D, got {tuple(bitmap.shape)}")
    if bitmap.dtype != torch.int32:
        raise ValueError(f"queue bitmap must be int32, got {bitmap.dtype}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")


def build_queue_plain(bitmap: torch.Tensor, capacity: int) -> Queue:
    """Plain PyTorch version of K2: ``(ii, jj)`` (capacity,) int32 row-major
    coordinates of the set bits, zero past the live count; ``n_live`` (1,)
    int32, the true count."""
    _, nb = bitmap.shape
    idx = torch.nonzero(bitmap.reshape(-1) != 0).reshape(-1)
    live = idx[:capacity]
    ii = torch.zeros(capacity, dtype=torch.int32, device=bitmap.device)
    jj = torch.zeros(capacity, dtype=torch.int32, device=bitmap.device)
    ii[:live.numel()] = (live // nb).to(torch.int32)
    jj[:live.numel()] = (live % nb).to(torch.int32)
    n_live = torch.tensor([idx.numel()], dtype=torch.int32,
                          device=bitmap.device)
    return ii, jj, n_live


def build_queue_kernel(bitmap: torch.Tensor, *, capacity: int) -> Queue:
    """Prefix-sum stream compaction of ``bitmap``.  Launches K2 for a CUDA
    tensor; runs the plain version for a CPU tensor."""
    global launches
    _check(bitmap, capacity)
    if bitmap.device.type == "cpu":
        return build_queue_plain(bitmap, capacity)
    if bitmap.device.type != "cuda":
        raise ValueError(f"build_queue: unsupported device {bitmap.device}")
    if not bitmap.is_contiguous():
        raise ValueError("build_queue: bitmap must be contiguous")
    mb, nb = bitmap.shape
    tiles = mb * nb
    if tiles > MAX_TILES:
        raise ValueError(f"bitmap of {tiles} tiles is too large (at most "
                         f"{MAX_TILES})")
    lib = _build.load()
    # One allocation, ii, jj, n_live: the kernel writes every slot below
    # min(capacity, T); only slots past T (capacity > T) are filled here.
    buf = torch.empty(2 * capacity + 1, dtype=torch.int32,
                      device=bitmap.device)
    ii, jj, n_live = buf[:capacity], buf[capacity:2 * capacity], buf[-1:]
    if capacity > tiles:
        ii[tiles:].zero_()
        jj[tiles:].zero_()
    err = lib.queue_builder_launch(bitmap.data_ptr(), tiles, max(nb, 1),
                                   capacity, ii.data_ptr(), jj.data_ptr(),
                                   n_live.data_ptr(),
                                   _build.stream_handle(bitmap.device))
    _build.check(err, "build_queue")
    launches += 1
    return ii, jj, n_live


def build_queue_argsort(bitmap: torch.Tensor, capacity: int) -> Queue:
    """The O(T log T) reference builder: a stable descending argsort of the
    flattened {0,1} bitmap (plain torch on every device, as in the
    reference, where it is not a Pallas kernel either)."""
    _, nb = bitmap.shape
    flat = (bitmap.reshape(-1) != 0).to(torch.int32)
    order = torch.argsort(-flat, stable=True)[:capacity]
    if order.numel() < capacity:           # capacity may exceed T
        order = torch.cat([order, order.new_zeros(capacity - order.numel())])
    n = flat.sum()
    live = torch.arange(capacity, device=bitmap.device) < n
    ii = torch.where(live, order // nb, 0).to(torch.int32)
    jj = torch.where(live, order % nb, 0).to(torch.int32)
    return ii, jj, n.reshape(1).to(torch.int32)


def build_queue(bitmap: torch.Tensor, *, capacity: int,
                builder: str = "prefix_sum") -> Queue:
    """Active-tile queue ``(ii, jj, n_live)`` from a (Mb, Nb) tile bitmap,
    counted as ``queue:<builder>``."""
    _check(bitmap, capacity)
    if builder not in ("prefix_sum", "argsort"):
        raise ValueError(f"unknown queue builder: {builder!r}")
    stats.record(f"queue:{builder}")
    with stats.lifecycle_scope("queue", builder):
        if builder == "argsort":
            return build_queue_argsort(bitmap, capacity)
        return build_queue_kernel(bitmap, capacity=capacity)
