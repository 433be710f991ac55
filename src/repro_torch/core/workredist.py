"""Work ReDistribution Unit (WDU) — the port of ``repro.core.workredist``,
a numpy copy kept in this package so that the port never imports the
reference.

Each PE-tile owns a slice (U/Tx × V/Ty) of the output map; spatial sparsity
variation makes some tiles finish early.  The WDU tracks per-tile progress
as a state tuple <iter, x, y>, detects idle ("source") tiles, picks the
lexicographically-most-behind ("target") tile, and if the target's
remaining work exceeds a threshold (paper: 30%), splits the remaining work
in half and reassigns the lower half to the idle tile.

This is a discrete-event simulation over per-tile work counts (active MACs
measured from real masks).  It drives Fig. 17 and the WR bars of Figs.
11–15.  On the card the same policy is realized statically by the compacted
work-queue GEMM, whose queue (kernel K2, ``kernels.queue_builder``) follows
``static_queue_order`` below.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class WDUResult:
    makespan: float          # cycles until the last tile finishes
    busy_min: float
    busy_avg: float
    busy_max: float
    utilization: float       # Σ busy / (n_tiles × makespan)
    n_redistributions: int


def simulate(
    work: np.ndarray,
    *,
    redistribute: bool = True,
    threshold: float = 0.30,
    split: float = 0.5,
    redistribution_overhead: float = 0.02,
) -> WDUResult:
    """Simulate one layer-phase execution over per-tile work counts.

    work[i] = active MACs assigned to tile i (already scaled by the tile's
    PE throughput, so 1 work unit = 1 cycle).  ``threshold`` gates a
    transfer on remaining/original fraction of the *target* tile, per the
    paper's empirical 30% lower bound.  ``redistribution_overhead`` charges
    the input-sharing + result-merge cost as a fraction of moved work.
    """
    remaining = work.astype(np.float64).copy()
    original = np.maximum(work.astype(np.float64), 1e-9)
    busy = np.zeros_like(remaining)
    t = 0.0
    n_redist = 0
    active = remaining > 0
    while active.any():
        dt = remaining[active].min()
        t += dt
        busy[active] += dt
        remaining[active] -= dt
        remaining[np.abs(remaining) < 1e-9] = 0.0
        active = remaining > 0
        if not redistribute:
            continue
        idle = np.flatnonzero(~active)
        for src in idle:
            if not active.any():
                break
            tgt = int(np.argmax(remaining))
            if remaining[tgt] <= 0:
                break
            if remaining[tgt] / original[tgt] < threshold:
                continue  # not worth the transfer overhead
            moved = remaining[tgt] * split
            remaining[tgt] -= moved
            remaining[src] += moved * (1.0 + redistribution_overhead)
            n_redist += 1
            active = remaining > 0
    util = float(busy.sum() / (len(work) * t)) if t > 0 else 1.0
    return WDUResult(
        makespan=float(t),
        busy_min=float(busy.min()),
        busy_avg=float(busy.mean()),
        busy_max=float(busy.max()),
        utilization=util,
        n_redistributions=n_redist,
    )


def wdu_dispatch_order(bitmap: np.ndarray) -> list:
    """The WDU's tile-dispatch rule, executed literally (paper §4.6): among
    the remaining active tiles, repeatedly pick the one with the
    lexicographically smallest state tuple — i.e. smallest (i, j).  O(T²)
    by construction; exists only to pin ``static_queue_order`` (and through
    it both kernel queue builders) to the paper's rule, not to be fast."""
    remaining = {(int(i), int(j))
                 for i, j in zip(*np.nonzero(np.asarray(bitmap) != 0))}
    order = []
    while remaining:
        nxt = min(remaining)               # lexicographic on the (i, j) tuple
        order.append(nxt)
        remaining.remove(nxt)
    return order


def static_queue_order(
    bitmap: np.ndarray,
    capacity: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """REFERENCE order of the static work queue: ``(ii, jj, n_live)``.

    Row-major coordinates of the set bits of a (Mb, Nb) tile bitmap — which
    is exactly the WDU dispatch order (``wdu_dispatch_order``), since
    row-major (i, j) IS ascending lexicographic on the state tuple.  Both
    the Pallas prefix-sum builder and the argsort reference in
    ``kernels.ops.build_queue`` must emit this order bit-for-bit
    (tests/test_queue_builder.py).

    ``capacity`` > 0 pads/truncates ``ii``/``jj`` to that many slots (dead
    slots are zero — valid coords for the consumer's gathers); ``n_live``
    is always the true set-bit count, so callers can detect overflow.
    """
    bm = np.asarray(bitmap) != 0
    ri, rj = np.nonzero(bm)                # C order == row-major == WDU order
    n_live = int(ri.size)
    cap = capacity if capacity > 0 else bm.size
    ii = np.zeros(cap, np.int32)
    jj = np.zeros(cap, np.int32)
    k = min(n_live, cap)
    ii[:k] = ri[:k]
    jj[:k] = rj[:k]
    return ii, jj, n_live


def tile_work_from_mask(
    active_outputs: np.ndarray,  # (U, V) work per output location
    tx: int,
    ty: int,
    macs_per_output: float,
) -> np.ndarray:
    """Partition a (U, V) work map into the paper's Tx×Ty PE tiles and
    return per-tile MAC counts (work-conserving fractional binning, so a
    map of any resolution — including < Tx — bins without zero-padding
    artifacts).  Halo effects are second-order and ignored, as in the
    paper's own mapping discussion (§4.2)."""
    import math
    u, v = active_outputs.shape
    su = math.lcm(u, tx) // u
    sv = math.lcm(v, ty) // v
    a = np.kron(active_outputs, np.ones((su, sv))) / (su * sv)
    u2, v2 = a.shape
    tiles = a.reshape(tx, u2 // tx, ty, v2 // ty).sum(axis=(1, 3))
    return (tiles * macs_per_output).reshape(-1)
