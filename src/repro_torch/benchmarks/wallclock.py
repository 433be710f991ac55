"""Wall-clock harness — measured time, honestly bounded; the port of the
reference's ``benchmarks/wallclock.py``.

  python -m repro_torch.benchmarks.wallclock [--smoke] [--out PATH]
      [--emit-out PATH] [--collective-out [PATH]] [--collective-only]
      [--check PATH] [--device cuda|cpu]

Every number this module emits follows the same methodology:

  1. the measured callable is called ``warmup`` times first, so the
     kernels' first-use build (``kernels/_build.py``) and any autotune
     resolution are EXCLUDED from every reported figure, as the
     reference's jit compile is;
  2. every call, warm-up and timed alike, is fenced with
     ``torch.cuda.synchronize`` on the devices of its output (nothing on
     the CPU): launches are asynchronous, so an unfenced
     ``time.perf_counter`` pair measures the enqueue, not the work;
  3. the reported figure is the MEDIAN of ``reps`` fenced calls with the
     inter-quartile range as spread — never a single sample.

Three documents, each with the reference's schema and checker:

  * ``BENCH_TORCH_7.json`` — the ``gemm`` table (one
    ``kernels.ops.sparse_gemm`` dispatch per schedule ∈ {predicated,
    compact, dense} for a CNN-derived and an FFN workload), the
    ``train_step`` table (one forward, backward and SGD update of a small
    VGG16 and a ReLU FFN) and the decision log of a scripted autotune
    session (``autotune_session``);
  * ``BENCH_TORCH_8.json`` — the ``emit`` table: per backward-dX
    workload × schedule the same σ′ GEMM run ``plain``, ``fused`` (σ′ +
    ``bitmap_emit``, one launch returning ``(out, bits)``) and
    ``gemm_scan`` (σ′ GEMM, then the standalone ``kernels.bitmap_scan``);
  * ``BENCH_TORCH_9.json`` — the ``collective`` table: per mesh × live
    fraction the same row-block-sparse gradient all-reduced by
    ``sharding.collectives.dense_psum`` and by the bitmap-compressed
    ``sparse_psum``, on gloo ranks of a ``launch.mesh.RankPool`` (on the
    card they share it, as NCCL refuses two ranks on one GPU).  Each timed
    call starts after a barrier and takes the slowest rank's time, since
    the collective ends when its last rank does.  ``sparse_psum`` picks
    its branch by a host read of the union's live count: that
    device→host copy lies inside the timed window.

The files go under ``build/benchmark_results/`` by default, the CSVs
beside them; nothing is written at the repository root.  On full-geometry
documents the checkers also hold the reference's ``claim:`` statements
(fused beats gemm_scan; bitmap beats dense at the lowest live fraction;
past the cutoff bitmap is within ``COLLECTIVE_FALLBACK_SLACK``× dense).

Differences from the reference: its GEMM and emit workloads are seeded
with ``hash(name)``, which changes with ``PYTHONHASHSEED``; here the seed
is ``zlib.crc32`` of the name and the data come from a ``torch.Generator``.
The autotune session draws its output-tile masks with the reference's
counter-based generator (threefry-2x32, from the same keys), so that its
decision log is the reference's row for row, and folds the card's
deferred telemetry after every dispatch (``autotune.fold_pending``) where
the trainers fold once a step.  The top-level key ``jax_backend`` is the
schema's name; it holds the device type (``"cuda"`` or ``"cpu"``).  Runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BENCH_NAMES = {"BENCH_7": "BENCH_TORCH_7.json",
               "BENCH_8": "BENCH_TORCH_8.json",
               "BENCH_9": "BENCH_TORCH_9.json"}

SCHEMA_VERSION = 1
SCHEDULES = ("predicated", "compact", "dense")
EMIT_SCHEDULES = ("predicated", "compact")   # the kernels' emit-capable pair
EMIT_VARIANTS = ("plain", "fused", "gemm_scan")
COLLECTIVE_VARIANTS = ("dense_psum", "bitmap")
COLLECTIVE_LIVE_FRACS = (0.05, 0.1, 0.25, 1.0)
# The reference's deliberately tight cutoff (capacity = 1/8 of the
# blocks): compression wins only when capacity + overhead stays well under
# the dense volume.
COLLECTIVE_CUTOFF = 0.125
# Fallback rows (live_frac > cutoff) may not beat dense — they ARE dense
# plus a tiny bitmap all-reduce + branch; allow that overhead, bounded.
COLLECTIVE_FALLBACK_SLACK = 1.25
# The gloo ranks of the collective table (the reference's device count).
COLLECTIVE_RANKS = 4

# The exact per-table row key sets of the documents.  The schema checkers
# fail on ANY deviation — added keys are drift just like missing.
ROW_KEYS = {
    "gemm": ("table", "workload", "schedule", "m", "k", "n", "groups",
             "block", "us_median", "us_iqr", "reps", "warmup"),
    "train_step": ("table", "workload", "schedule", "batch", "params",
                   "us_median", "us_iqr", "reps", "warmup"),
    "emit": ("table", "workload", "schedule", "variant", "m", "k", "n",
             "groups", "block", "emit_gran", "us_median", "us_iqr",
             "reps", "warmup"),
    "collective": ("table", "mesh", "devices", "m", "n", "block",
                   "live_frac", "cutoff", "variant", "us_median", "us_iqr",
                   "reps", "warmup"),
}
AUTOTUNE_LOG_KEYS = ("seq", "event", "key", "shape", "groups", "schedule",
                     "block", "live_frac", "operand_frac", "samples")


# ---------------------------------------------------------------------------
# The one timing primitive
# ---------------------------------------------------------------------------

def _cuda_devices(out) -> Tuple[torch.device, ...]:
    """The CUDA devices the tensors of ``out`` (a tensor or a nest of
    tuples, lists and dicts) lie on."""
    return tuple({leaf.device for leaf in tree.leaves(out)
                  if isinstance(leaf, torch.Tensor)
                  and leaf.device.type == "cuda"})


def _fence(devices: Sequence[torch.device]) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


def _samples(call: Callable[[], object], *, warmup: int, reps: int,
             before: Optional[Callable[[], None]] = None) -> List[float]:
    """``reps`` fenced wall times of ``call`` in µs after ``warmup`` fenced
    calls; ``before`` (a barrier) runs ahead of every call, outside the
    timed window.  The fence's devices are those of the warm-up's output."""
    devices: Tuple[torch.device, ...] = ()
    for _ in range(max(1, warmup)):
        _fence(devices)
        if before is not None:
            before()
        devices = _cuda_devices(call())
        _fence(devices)
    times = []
    for _ in range(max(1, reps)):
        _fence(devices)
        if before is not None:
            before()
        t0 = time.perf_counter()
        call()
        _fence(devices)
        times.append((time.perf_counter() - t0) * 1e6)
    return times


def _summary(times: List[float], *, warmup: int, reps: int
             ) -> Dict[str, float]:
    """Median and IQR in µs (rounded to 0.01) of ``times``, as the
    reference reports them."""
    times = sorted(times)
    q1 = times[len(times) // 4]
    q3 = times[min(len(times) - 1, (3 * len(times)) // 4)]
    return {
        "us_median": round(statistics.median(times), 2),
        "us_iqr": round(q3 - q1, 2),
        "reps": int(reps),
        "warmup": int(warmup),
    }


def measure(call: Callable[[], object], *, warmup: int = 2,
            reps: int = 5) -> Dict[str, float]:
    """Median-of-``reps`` fenced wall time of ``call`` in µs, first-use
    build and warm-up excluded.  ``call`` returns its output (tensors on
    the device it ran on); every call is fenced before and after on that
    output's CUDA devices, so a timed interval never starts while earlier
    work is in flight nor ends before its own work has."""
    return _summary(_samples(call, warmup=warmup, reps=reps),
                    warmup=warmup, reps=reps)


# ---------------------------------------------------------------------------
# Workload synthesis — block-structured sparsity with a KNOWN live fraction
# ---------------------------------------------------------------------------

def _name_seed(name: str) -> int:
    """A seed from a workload's name that is the same in every process."""
    return zlib.crc32(name.encode())


def _expand(bm: torch.Tensor, block2: Tuple[int, int],
            shape: Tuple[int, int]) -> torch.Tensor:
    """A block bitmap expanded to an element mask of ``shape`` (float)."""
    b0, b1 = block2
    return bm.repeat_interleave(b0, 0).repeat_interleave(b1, 1)[
        :shape[0], :shape[1]].to(torch.float32)


def _blocky(gen: torch.Generator, shape: Tuple[int, int],
            block2: Tuple[int, int], live: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data, block bitmap), drawn on the CPU from ``gen``: iid normal data
    gated by a Bernoulli(``live``) BLOCK mask, so that the measured live
    fraction equals the drawn bitmap's mean — the workload's sparsity is
    known, not hoped for."""
    m, n = shape
    b0, b1 = block2
    bm = torch.rand((-(-m // b0), -(-n // b1)), generator=gen) < live
    data = torch.randn(shape, generator=gen) * _expand(bm, block2, shape)
    return data, bm


# The reference's counter-based generator (threefry-2x32, 20 rounds;
# Salmon et al., SC 2011) with its key split and Bernoulli draw, for the
# autotune session's masks: keys are (hi, lo) uint32 pairs.
_TF_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _TF_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _tf_counts(n: int) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _tf_key(seed: int) -> Tuple[int, int]:
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def _tf_split(key: Tuple[int, int], num: int) -> List[Tuple[int, int]]:
    hi, lo = _threefry2x32(key, *_tf_counts(num))
    return [(int(a), int(b)) for a, b in zip(hi, lo)]


def _tf_bernoulli(key: Tuple[int, int], p: float,
                  shape: Tuple[int, ...]) -> np.ndarray:
    """Bernoulli(``p``) booleans of ``shape``: float32 uniforms in [0, 1)
    from the generator's 32-bit words (the top 23 bits as the mantissa)
    compared with ``p`` in float32."""
    hi, lo = _threefry2x32(key, *_tf_counts(int(np.prod(shape))))
    bits = (((hi ^ lo) >> np.uint32(9)) | np.uint32(0x3F800000))
    u = bits.view(np.float32) - np.float32(1.0)
    return (u < np.float32(p)).reshape(shape)


def cnn_gemm_dims(*, image_size: int, width: float, batch: int,
                  layer: str = "conv2", stage: str = "bp_dx",
                  net: str = "vgg16") -> Tuple[str, Tuple[int, int, int]]:
    """One (M, K, N) from the CNN's OWN workload description — the dims a
    real training step hands the dispatcher, not invented round numbers."""
    from repro_torch.models.cnn import build_cnn
    model = build_cnn(net, image_size=image_size, width=width,
                      num_classes=10)
    for row in model.gemm_workload(batch):
        if row["layer"] == layer and row["stage"] == stage:
            return f"cnn:{net}:{layer}:{stage}", (row["m"], row["k"],
                                                  row["n"])
    raise KeyError(f"{layer}/{stage} not in {net} workload")


def _block_name(block: Sequence[int]) -> str:
    return "x".join(map(str, block))


def bench_gemm_rows(*, smoke: bool, device="cuda") -> List[dict]:
    """One measured row per schedule × workload.  All three schedules run
    the SAME operands and masks; predicated (K4) and compact (K2 → K3) go
    through the CUDA kernels, dense is the ``xla_ref`` schedule
    (``torch.matmul`` + masking)."""
    from repro_torch.core import policy as pol
    from repro_torch.kernels import ops
    from repro_torch.kernels.shapes import block_bitmap

    dev = resolve_device(device)
    block = (8, 8, 8)
    timing = dict(warmup=1, reps=3) if smoke else dict(warmup=2, reps=5)
    geo = dict(image_size=8, width=0.125, batch=2) if smoke else \
        dict(image_size=10, width=0.25, batch=2)

    cnn_name, cnn_dims = cnn_gemm_dims(**geo)
    ffn_tokens = 64 if smoke else 128
    workloads = [
        (cnn_name, cnn_dims),
        # the down-projection's backward dX GEMM: dL/dh = g @ W_downᵀ with
        # the hidden ReLU mask killing output tiles (paper's core GEMM)
        ("ffn:relu_bwd_dx", (ffn_tokens, 32, 64)),
    ]
    schedule_policies = {
        "predicated": pol.IN_OUT.with_(kernel_impl="pallas", block=block),
        "compact": pol.IN_OUT_WR.with_(kernel_impl="pallas", block=block),
        "dense": pol.IN_OUT,                       # xla_ref ⇒ "dense"
    }

    rows: List[dict] = []
    for wname, (m, k, n) in workloads:
        gen = torch.Generator().manual_seed(_name_seed(wname))
        a, _ = _blocky(gen, (m, k), (block[0], block[1]), live=0.6)
        b = torch.randn((k, n), generator=gen)
        out_t, _ = _blocky(gen, (m, n), (block[0], block[2]), live=0.5)
        a, b, out_t = (t.to(dev) for t in (a, b, out_t))
        for sched, policy in schedule_policies.items():
            spec = policy.gemm_spec()
            assert spec.schedule == sched, (spec.schedule, sched)
            masks = ops.GemmMasks(
                out=block_bitmap(out_t, spec.block[0], spec.block[2]),
                a=block_bitmap(a, spec.block[0], spec.block[1]),
                b=None)
            rows.append({
                "table": "gemm", "workload": wname, "schedule": sched,
                "m": m, "k": k, "n": n, "groups": spec.groups,
                "block": _block_name(spec.block),
                **measure(functools.partial(ops.sparse_gemm, a, b, masks,
                                            spec), **timing),
            })
    return rows


# ---------------------------------------------------------------------------
# Fused bitmap emission vs GEMM-then-scan
# ---------------------------------------------------------------------------

def _gemm_then_scan(dy, wt, masks, spec, mult, gran):
    """The two-launch pipeline the emit epilogue replaces: the σ′ GEMM,
    then a standalone ``bitmap_scan`` re-reading its output."""
    from repro_torch.kernels import ops
    out = ops.sparse_gemm(dy, wt, masks, spec, epilogue_mult=mult)
    return out, ops.bitmap_scan(out, block=gran, kind="grad")


def bench_emit_rows(*, smoke: bool, device="cuda") -> List[dict]:
    """One measured row per workload × kernel schedule × variant: the
    paper's hot GEMM — backward dX (``dy @ Wᵀ``) with the σ′ mask leaving
    25% of the output tiles live — run three ways on identical operands
    and masks: ``plain`` (σ′ epilogue only), ``fused`` (σ′ + bitmap
    emission in the epilogue, one launch plus its gated NaN fix-up) and
    ``gemm_scan`` (σ′ GEMM, then the standalone ``bitmap_scan``, K5).  The
    workloads are a MobileNet pointwise conv's dX and an FFN
    down-projection's dX, whose outputs are large against the reduction
    axis.  The compact schedule's queue is bounded to the drawn live-tile
    count."""
    from repro_torch.core import policy as pol
    from repro_torch.kernels import ops
    from repro_torch.kernels.shapes import block_bitmap

    dev = resolve_device(device)
    block = (8, 32, 8)
    emit_gran = (block[0], block[2])
    live = 0.25
    timing = dict(warmup=1, reps=3) if smoke else dict(warmup=2, reps=9)
    geo = dict(image_size=32, width=0.5, batch=2 if smoke else 8,
               layer="pw1", net="mobilenet")

    cnn_name, cnn_dims = cnn_gemm_dims(**geo)
    ffn_tokens = 256 if smoke else 1024
    workloads = [
        (cnn_name, cnn_dims),
        ("ffn:relu_bwd_dx", (ffn_tokens, 32, 64)),
    ]
    schedule_policies = {
        "predicated": pol.IN_OUT.with_(kernel_impl="pallas", block=block),
        "compact": pol.IN_OUT_WR.with_(kernel_impl="pallas", block=block),
    }

    rows: List[dict] = []
    for wname, (m, k, n) in workloads:
        gen = torch.Generator().manual_seed(_name_seed(f"emit {wname}"))
        dy = torch.randn((m, k), generator=gen)
        wt = torch.randn((k, n), generator=gen)
        # σ′ footprint: block-structured so the out mask has dead tiles
        _, mult_bm = _blocky(gen, (m, n), (block[0], block[2]), live)
        mult = _expand(mult_bm, emit_gran, (m, n))
        n_live = int(mult_bm.sum())
        dy, wt, mult = (t.to(dev) for t in (dy, wt, mult))
        masks = ops.GemmMasks(out=block_bitmap(mult, block[0], block[2]))
        for sched, policy in schedule_policies.items():
            base = policy.gemm_spec()
            assert base.schedule == sched, (base.schedule, sched)
            if sched == "compact":
                base = base.with_(max_active_blocks=n_live)
            spec_p = base.with_(epilogue=("sigma_prime",))
            spec_f = base.with_(epilogue=("sigma_prime", "bitmap_emit"),
                                emit_gran=emit_gran)

            for variant, fn in (
                    ("plain", functools.partial(
                        ops.sparse_gemm, dy, wt, masks, spec_p,
                        epilogue_mult=mult)),
                    ("fused", functools.partial(
                        ops.sparse_gemm, dy, wt, masks, spec_f,
                        epilogue_mult=mult)),
                    ("gemm_scan", functools.partial(
                        _gemm_then_scan, dy, wt, masks, spec_p, mult,
                        emit_gran))):
                rows.append({
                    "table": "emit", "workload": wname, "schedule": sched,
                    "variant": variant, "m": m, "k": k, "n": n,
                    "groups": base.groups,
                    "block": _block_name(block),
                    "emit_gran": _block_name(emit_gran),
                    **measure(fn, **timing),
                })
    return rows


# ---------------------------------------------------------------------------
# Bitmap-compressed all-reduce vs dense all-reduce
# ---------------------------------------------------------------------------

def _collective_meshes(n_dev: int
                       ) -> List[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """Mesh shapes the collective table sweeps over ``n_dev`` ranks: always
    the flat data mesh, plus a 2-D (data, pod) factoring when the count
    supports it — the compressed reduce must not regress when the
    all-reduce spans more than one mesh axis."""
    meshes = [((n_dev,), ("data",))]
    if n_dev >= 4 and n_dev % 2 == 0:
        meshes.append(((2, n_dev // 2), ("data", "pod")))
    return meshes


def _collective_geometry(smoke: bool) -> dict:
    b0 = 32 if smoke else 128            # row-block height; wire = (b0, N)
    m, n = (512, 256) if smoke else (8192, 2048)
    return dict(b0=b0, m=m, n=n,
                timing=dict(warmup=1, reps=3) if smoke
                else dict(warmup=2, reps=7))


def _collective_cell(device: str, shape: Tuple[int, ...],
                     names: Tuple[str, ...], live: float, smoke: bool
                     ) -> Dict[str, List[float]]:
    """In one rank of the pool: this rank's slice of the (ranks, M, N)
    gradient stack of one (mesh, live) cell, all-reduced by both variants;
    returns each variant's fenced µs per call (timed after a barrier).

    The live row blocks are drawn ONCE per cell (an exact count, a
    permutation draw) and repeated on every rank — data-parallel dW
    gradients share their sparsity structure across ranks, and a ReLU
    that killed a feature across the whole batch zeroes the entire dW
    row; the wire block spans the full row.  ``sparse_psum`` is fed the
    FINE bitmap and told the wire block, so the timed path includes the
    coarsening."""
    import torch.distributed as dist

    from repro_torch.kernels import stats
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.sharding.collectives import dense_psum, sparse_psum

    geo = _collective_geometry(smoke)
    b0, m, n = geo["b0"], geo["m"], geo["n"]
    mt, nt_g = m // b0, n // b0          # fine-bitmap grid; wire nblk = mt
    prev = stats.set_runtime_counting(False)
    try:
        dev = torch.device(device)
        mesh = init_mesh(shape, names, backend=dist.get_backend(),
                         device=dev)
        rng = np.random.default_rng(hash((shape, live)) % (2 ** 31))
        count = max(1, min(mt, round(live * mt)))
        row_live = np.zeros(mt, np.int32)
        row_live[rng.permutation(mt)[:count]] = 1
        expand = np.repeat(row_live, b0).astype(np.float32)[:, None]
        # Rank r's slice of the stack the reference draws in one call:
        # successive draws continue one stream.
        for _ in range(dist.get_rank() + 1):
            data = rng.standard_normal((m, n)).astype(np.float32)
        x = torch.from_numpy(data * expand).to(dev)
        bm = torch.from_numpy(np.repeat(row_live[:, None], nt_g, 1)).to(dev)
        calls = {
            "dense_psum": lambda: dense_psum(x, names, mesh=mesh),
            "bitmap": lambda: sparse_psum(
                x, bm, (b0, b0), mesh=mesh, axis_name=names,
                block=(b0, n), cutoff=COLLECTIVE_CUTOFF),
        }
        return {v: _samples(calls[v], before=mesh.barrier, **geo["timing"])
                for v in COLLECTIVE_VARIANTS}
    finally:
        stats.set_runtime_counting(prev)


def bench_collective_rows(*, smoke: bool, device="cuda") -> List[dict]:
    """One measured row per mesh × live fraction × variant, on
    COLLECTIVE_RANKS gloo ranks on ``device`` (a ``launch.mesh.RankPool``,
    started here and closed after).  Runtime counting is off
    for the rows (the fallback/compressed counters are audit
    instrumentation, not the collective) and restored after, in this
    process and in every rank."""
    from repro_torch.kernels import stats
    from repro_torch.launch.mesh import RankPool

    dev = resolve_device(device)
    prev = stats.set_runtime_counting(False)
    try:
        with RankPool(COLLECTIVE_RANKS, device=str(dev),
                      backend="gloo") as pool:
            return _collective_rows_inner(pool, smoke=smoke, device=dev)
    finally:
        stats.set_runtime_counting(prev)


def _collective_rows_inner(pool, *, smoke: bool, device) -> List[dict]:
    n_dev = pool.world_size
    geo = _collective_geometry(smoke)
    timing = geo["timing"]
    calls = len(COLLECTIVE_VARIANTS) * (timing["warmup"] + timing["reps"])
    # A full-geometry call moves 64 MiB a rank through gloo's host path.
    timeout = 120.0 + calls * (0.5 if smoke else 3.0)
    rows: List[dict] = []
    for shape, names in _collective_meshes(n_dev):
        for live in COLLECTIVE_LIVE_FRACS:
            per_rank = pool.run(_collective_cell, str(device), shape, names,
                                live, smoke, timeout=timeout)
            for variant in COLLECTIVE_VARIANTS:
                slowest = [max(ts) for ts in
                           zip(*(r[variant] for r in per_rank))]
                rows.append({
                    "table": "collective",
                    "mesh": _block_name(shape),
                    "devices": n_dev, "m": geo["m"], "n": geo["n"],
                    "block": f"{geo['b0']}x{geo['n']}",
                    "live_frac": live, "cutoff": COLLECTIVE_CUTOFF,
                    "variant": variant,
                    **_summary(slowest, **timing),
                })
    return rows


# ---------------------------------------------------------------------------
# Whole train steps
# ---------------------------------------------------------------------------

def _sgd_step(loss_fn: Callable[[dict], torch.Tensor], params: dict,
              lr: float = 0.05):
    """(params after one SGD step, loss): forward, backward, update."""
    leaves = tree.leaves(params)
    loss = loss_fn(params)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [w - lr * g for w, g in zip(leaves, grads)]
    return tree.unflatten_like(params, new), loss.detach()


def bench_train_rows(*, smoke: bool, device="cuda") -> List[dict]:
    from repro_torch.core import policy as pol
    from repro_torch.models.cnn import build_cnn
    from repro_torch.models.ffn import FFNConfig, ffn_apply, ffn_init

    dev = resolve_device(device)
    timing = dict(warmup=1, reps=3) if smoke else dict(warmup=2, reps=5)
    rows: List[dict] = []
    policy = pol.IN_OUT                           # xla_ref

    def n_params(params) -> int:
        return sum(int(x.numel()) for x in tree.leaves(params))

    # -- CNN step --------------------------------------------------------
    batch = 2
    model = build_cnn("vgg16", image_size=8, width=0.125, num_classes=10)
    params = model.init(0, device=dev)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((batch, 8, 8, 3), generator=gen).to(dev)
    lbl = torch.randint(0, 10, (batch,), generator=gen).to(dev)
    rows.append({
        "table": "train_step", "workload": "cnn:vgg16",
        "schedule": policy.gemm_spec().schedule, "batch": batch,
        "params": n_params(params),
        **measure(lambda: _sgd_step(
            lambda q: model.loss(q, img, lbl, policy), params), **timing),
    })

    # -- FFN step --------------------------------------------------------
    tokens = 32 if smoke else 64
    cfg = FFNConfig(d_model=16, d_ff=32, activation="relu",
                    sparse_policy=policy)
    fparams = ffn_init(3, cfg, device=dev)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((tokens, cfg.d_model), generator=gen).to(dev)
    y = torch.randn((tokens, cfg.d_model), generator=gen).to(dev)
    rows.append({
        "table": "train_step", "workload": "ffn:relu",
        "schedule": policy.gemm_spec().schedule, "batch": tokens,
        "params": n_params(fparams),
        **measure(lambda: _sgd_step(
            lambda q: torch.mean((ffn_apply(q, x, cfg) - y) ** 2),
            fparams), **timing),
    })
    return rows


# ---------------------------------------------------------------------------
# Scripted autotune session — the traceability evidence
# ---------------------------------------------------------------------------

def autotune_session(*, drift_steps: Tuple[int, int] = (8, 10),
                     shape_steps: int = 6, seed: int = 0, device="cuda"
                     ) -> Tuple[List[dict], List[dict], Dict[str, int]]:
    """Two-part eager session against a FRESH autotune cache; returns
    (per-step selections, decision log, cache counters).

    Part 1 (temporal drift, shapeless key): dispatch at ~25% live output
    tiles — the cache should settle on "compact" — then at 100% live,
    driving a drift retune through "predicated" to "dense" once the
    trailing window is all-dense.

    Part 2 (per-shape keys): two interleaved dims-keyed workloads, one
    staying sparse and one fully dense, must hold DIFFERENT schedules
    simultaneously — the per-(spec, shape) selection the key exists for.

    Every resolution reads the MEASURED live fractions the dispatcher
    recorded: on the card they are folded after each dispatch.  The
    output-tile masks come from the reference's generator and keys (see
    the module docstring); the operands from a ``torch.Generator``."""
    from repro_torch.core import policy as pol
    from repro_torch.kernels import autotune, ops, stats
    from repro_torch.kernels.shapes import block_bitmap

    dev = resolve_device(device)
    stats.reset()
    cache = autotune.reset(window=6, min_samples=3)
    policy = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8),
                                 autotune=True)
    selections: List[dict] = []
    step = 0

    def dispatch(live: float, dims: Optional[Tuple[int, int, int]],
                 phase: str) -> None:
        nonlocal step
        m, k, n = dims or (32, 16, 24)
        _, _, ko = _tf_split(_tf_key(seed * 10_000 + step), 3)
        kb, _ = _tf_split(ko, 2)
        spec = policy.gemm_spec(dims=dims) if dims is not None \
            else policy.gemm_spec()
        gen = torch.Generator().manual_seed(seed * 10_000 + step)
        a = torch.randn((m, k), generator=gen).to(dev)
        b = torch.randn((k, n), generator=gen).to(dev)
        block2 = (spec.block[0], spec.block[2])
        bm = torch.from_numpy(_tf_bernoulli(
            kb, live, (-(-m // block2[0]), -(-n // block2[1]))))
        out_t = (torch.randn((m, n), generator=gen)
                 * _expand(bm, block2, (m, n))).to(dev)
        masks = ops.GemmMasks(out=block_bitmap(out_t, *block2))
        ops.sparse_gemm(a, b, masks, spec)        # eager: concrete masks
        autotune.fold_pending()
        selections.append({"step": step, "phase": phase,
                           "live": live, "dims": dims,
                           "schedule": spec.schedule})
        step += 1

    sparse_steps, dense_steps = drift_steps
    for _ in range(sparse_steps):
        dispatch(0.25, None, "drift:sparse")
    for _ in range(dense_steps):
        dispatch(1.0, None, "drift:dense")
    for _ in range(shape_steps):
        dispatch(0.25, (32, 16, 24), "shape:A")
        dispatch(1.0, (16, 16, 16), "shape:B")

    log = autotune.log_rows()
    counters = {"hits": cache.hits, "misses": cache.misses,
                "retunes": cache.retunes}
    return selections, log, counters


# ---------------------------------------------------------------------------
# Schema (the reference's checks, word for word)
# ---------------------------------------------------------------------------

def check_schema(doc: dict) -> List[str]:
    """Validate a BENCH_7 document; returns a list of problems (empty ⇒
    OK).  Checks the exact per-table key sets, the acceptance coverage
    (every schedule measured for ≥1 CNN and ≥1 FFN GEMM workload; a CNN
    and an FFN train step), positive fenced medians, and that every
    autotune log row carries its traceability fields."""
    errs: List[str] = []
    for top in ("schema_version", "bench", "jax_backend", "geometry",
                "rows", "autotune"):
        if top not in doc:
            errs.append(f"missing top-level key {top!r}")
    if errs:
        return errs
    if doc["schema_version"] != SCHEMA_VERSION:
        errs.append(f"schema_version {doc['schema_version']} != "
                    f"{SCHEMA_VERSION}")

    seen: Dict[str, set] = {"cnn": set(), "ffn": set()}
    train_seen = set()
    for i, row in enumerate(doc["rows"]):
        table = row.get("table")
        if table not in ROW_KEYS:
            errs.append(f"rows[{i}]: unknown table {table!r}")
            continue
        want = set(ROW_KEYS[table])
        got = set(row)
        if got != want:
            errs.append(f"rows[{i}] ({table}): key drift "
                        f"+{sorted(got - want)} -{sorted(want - got)}")
            continue
        if not (isinstance(row["us_median"], (int, float))
                and row["us_median"] > 0):
            errs.append(f"rows[{i}] ({table}): non-positive us_median")
        if table == "gemm":
            if row["schedule"] not in SCHEDULES:
                errs.append(f"rows[{i}]: unknown schedule "
                            f"{row['schedule']!r}")
            fam = row["workload"].split(":", 1)[0]
            if fam in seen:
                seen[fam].add(row["schedule"])
        elif table == "train_step":
            train_seen.add(row["workload"].split(":", 1)[0])

    for fam, scheds in seen.items():
        missing = set(SCHEDULES) - scheds
        if missing:
            errs.append(f"gemm coverage: {fam} workload missing schedules "
                        f"{sorted(missing)}")
    for fam in ("cnn", "ffn"):
        if fam not in train_seen:
            errs.append(f"train_step coverage: no {fam} row")

    at = doc["autotune"]
    for k in ("counters", "selections", "log"):
        if k not in at:
            errs.append(f"autotune: missing {k!r}")
    for i, row in enumerate(at.get("log", [])):
        if set(row) != set(AUTOTUNE_LOG_KEYS):
            errs.append(f"autotune.log[{i}]: key drift {sorted(row)}")
            break
    if not at.get("log"):
        errs.append("autotune.log is empty — selections are not traceable")
    return errs


def check_emit_schema(doc: dict) -> List[str]:
    """Validate a BENCH_8 document; returns a list of problems (empty ⇒
    OK).  Checks the exact ``emit`` row key set, the coverage (every
    variant measured for both kernel schedules on ≥1 CNN and ≥1 FFN
    backward-dX workload), positive fenced medians, AND — on
    full-geometry documents — the headline claim: fused σ′+emit strictly
    beats GEMM-then-scan on every cell.  Smoke documents skip only the
    claim: with reduced reps a strict wall-clock inequality is a
    coin-flip."""
    errs: List[str] = []
    for top in ("schema_version", "bench", "jax_backend", "geometry",
                "rows"):
        if top not in doc:
            errs.append(f"missing top-level key {top!r}")
    if errs:
        return errs
    if doc["schema_version"] != SCHEMA_VERSION:
        errs.append(f"schema_version {doc['schema_version']} != "
                    f"{SCHEMA_VERSION}")
    if doc["bench"] != "BENCH_8":
        errs.append(f"bench {doc['bench']!r} != 'BENCH_8'")

    want = set(ROW_KEYS["emit"])
    cells: Dict[Tuple[str, str], Dict[str, float]] = {}
    seen: Dict[str, set] = {"cnn": set(), "ffn": set()}
    for i, row in enumerate(doc["rows"]):
        if row.get("table") != "emit":
            errs.append(f"rows[{i}]: unknown table {row.get('table')!r}")
            continue
        got = set(row)
        if got != want:
            errs.append(f"rows[{i}] (emit): key drift "
                        f"+{sorted(got - want)} -{sorted(want - got)}")
            continue
        if row["schedule"] not in EMIT_SCHEDULES:
            errs.append(f"rows[{i}]: unknown schedule {row['schedule']!r}")
        if row["variant"] not in EMIT_VARIANTS:
            errs.append(f"rows[{i}]: unknown variant {row['variant']!r}")
            continue
        if not (isinstance(row["us_median"], (int, float))
                and row["us_median"] > 0):
            errs.append(f"rows[{i}] (emit): non-positive us_median")
            continue
        fam = row["workload"].split(":", 1)[0]
        if fam in seen:
            seen[fam].add((row["schedule"], row["variant"]))
        cells.setdefault((row["workload"], row["schedule"]), {})[
            row["variant"]] = row["us_median"]

    full = {(s, v) for s in EMIT_SCHEDULES for v in EMIT_VARIANTS}
    for fam, got in seen.items():
        missing = sorted(full - got)
        if missing:
            errs.append(f"emit coverage: {fam} workload missing cells "
                        f"{missing}")

    if doc.get("geometry") != "full":
        return errs                       # claim gated on full runs
    for (wname, sched), by_variant in sorted(cells.items()):
        if set(by_variant) != set(EMIT_VARIANTS):
            continue                      # coverage error already reported
        if not by_variant["fused"] < by_variant["gemm_scan"]:
            errs.append(
                f"claim: fused ({by_variant['fused']}us) not faster than "
                f"gemm_scan ({by_variant['gemm_scan']}us) on "
                f"{wname}/{sched} — the emit epilogue must beat the "
                f"two-launch pipeline")
    return errs


def check_collective_schema(doc: dict) -> List[str]:
    """Validate a BENCH_9 document; returns a list of problems (empty ⇒
    OK).  Checks the exact ``collective`` row key set, the coverage (both
    variants measured for every live fraction on ≥1 mesh, and every mesh
    covering the full live-fraction sweep), positive fenced medians, AND
    — on full-geometry documents — the headline claim: the
    bitmap-compressed reduce strictly beats the dense all-reduce at the
    LOWEST live fraction on every mesh, and on past-cutoff rows (where
    ``sparse_psum`` falls back to dense at run time) costs at most
    ``COLLECTIVE_FALLBACK_SLACK``× dense.  Smoke documents skip only the
    claim."""
    errs: List[str] = []
    for top in ("schema_version", "bench", "jax_backend", "geometry",
                "rows"):
        if top not in doc:
            errs.append(f"missing top-level key {top!r}")
    if errs:
        return errs
    if doc["schema_version"] != SCHEMA_VERSION:
        errs.append(f"schema_version {doc['schema_version']} != "
                    f"{SCHEMA_VERSION}")
    if doc["bench"] != "BENCH_9":
        errs.append(f"bench {doc['bench']!r} != 'BENCH_9'")

    want = set(ROW_KEYS["collective"])
    cells: Dict[Tuple[str, float], Dict[str, float]] = {}
    cutoffs: Dict[str, float] = {}
    for i, row in enumerate(doc["rows"]):
        if row.get("table") != "collective":
            errs.append(f"rows[{i}]: unknown table {row.get('table')!r}")
            continue
        got = set(row)
        if got != want:
            errs.append(f"rows[{i}] (collective): key drift "
                        f"+{sorted(got - want)} -{sorted(want - got)}")
            continue
        if row["variant"] not in COLLECTIVE_VARIANTS:
            errs.append(f"rows[{i}]: unknown variant {row['variant']!r}")
            continue
        if not (isinstance(row["us_median"], (int, float))
                and row["us_median"] > 0):
            errs.append(f"rows[{i}] (collective): non-positive us_median")
            continue
        cells.setdefault((row["mesh"], row["live_frac"]), {})[
            row["variant"]] = row["us_median"]
        cutoffs[row["mesh"]] = row["cutoff"]

    if not cells:
        errs.append("collective coverage: no rows")
        return errs
    by_mesh: Dict[str, set] = {}
    for (mesh_name, live), by_variant in cells.items():
        by_mesh.setdefault(mesh_name, set()).add(live)
        missing = sorted(set(COLLECTIVE_VARIANTS) - set(by_variant))
        if missing:
            errs.append(f"collective coverage: {mesh_name}@{live} missing "
                        f"variants {missing}")
    for mesh_name, lives in by_mesh.items():
        missing = sorted(set(COLLECTIVE_LIVE_FRACS) - lives)
        if missing:
            errs.append(f"collective coverage: {mesh_name} missing live "
                        f"fractions {missing}")

    if doc.get("geometry") != "full":
        return errs                       # claim gated on full runs
    for mesh_name, lives in sorted(by_mesh.items()):
        cutoff = cutoffs[mesh_name]
        lowest = min(lives)
        for live in sorted(lives):
            by_variant = cells[(mesh_name, live)]
            if set(by_variant) != set(COLLECTIVE_VARIANTS):
                continue                  # coverage error already reported
            bm, dn = by_variant["bitmap"], by_variant["dense_psum"]
            if live == lowest and not bm < dn:
                errs.append(
                    f"claim: bitmap ({bm}us) not faster than dense_psum "
                    f"({dn}us) on {mesh_name}@{live} — the compressed "
                    f"reduce must win where the union is sparse")
            if live > cutoff and not bm <= dn * COLLECTIVE_FALLBACK_SLACK:
                errs.append(
                    f"claim: bitmap ({bm}us) > {COLLECTIVE_FALLBACK_SLACK}x "
                    f"dense_psum ({dn}us) on {mesh_name}@{live} — past the "
                    f"cutoff the runtime fallback must keep the compressed "
                    f"path from losing")
    return errs


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _doc(bench: str, device, smoke: bool, rows: List[dict]) -> dict:
    return {
        "schema_version": SCHEMA_VERSION,
        "bench": bench,
        "jax_backend": resolve_device(device).type,
        "geometry": "smoke" if smoke else "full",
        "rows": rows,
    }


def run_bench(*, smoke: bool = False, device="cuda") -> dict:
    rows = bench_gemm_rows(smoke=smoke, device=device) \
        + bench_train_rows(smoke=smoke, device=device)
    selections, log, counters = autotune_session(device=device)
    return {**_doc("BENCH_7", device, smoke, rows),
            "autotune": {"counters": counters, "selections": selections,
                         "log": log}}


def run_emit_bench(*, smoke: bool = False, device="cuda") -> dict:
    return _doc("BENCH_8", device, smoke,
                bench_emit_rows(smoke=smoke, device=device))


def run_collective_bench(*, smoke: bool = False, device="cuda") -> dict:
    return _doc("BENCH_9", device, smoke,
                bench_collective_rows(smoke=smoke, device=device))


def write_outputs(doc: dict, out_path: str) -> None:
    """The document as JSON at ``out_path`` and each of its tables (and the
    autotune log) as ``wallclock_<table>.csv`` beside it."""
    from .run import write_rows
    out_dir = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    by_table: Dict[str, List[dict]] = {}
    for row in doc["rows"]:
        by_table.setdefault(row["table"], []).append(row)
    for table, rows in by_table.items():
        write_rows(os.path.join(out_dir, f"wallclock_{table}.csv"), rows)
    if doc.get("autotune", {}).get("log"):
        write_rows(os.path.join(out_dir, "wallclock_autotune.csv"),
                   doc["autotune"]["log"])


def _checker_for(doc: dict):
    return {"BENCH_8": check_emit_schema,
            "BENCH_9": check_collective_schema}.get(
                doc.get("bench"), check_schema)


def main(argv=None) -> int:
    from .run import RESULTS_DIR
    default = {b: os.path.join(RESULTS_DIR, f)
               for b, f in BENCH_NAMES.items()}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced geometry + fewer reps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=default["BENCH_7"],
                    help="BENCH_7 (gemm, train_step, autotune) JSON path")
    ap.add_argument("--emit-out", default=default["BENCH_8"],
                    help="BENCH_8 (emit table) JSON path")
    ap.add_argument("--collective-out", nargs="?",
                    const=default["BENCH_9"], default=None, metavar="PATH",
                    help="ALSO generate the BENCH_9 (collective table) "
                         "document at PATH (default when the flag is bare: "
                         f"{default['BENCH_9']}); it starts "
                         f"{COLLECTIVE_RANKS} gloo ranks")
    ap.add_argument("--collective-only", action="store_true",
                    help="generate ONLY the BENCH_9 document")
    ap.add_argument("--check", metavar="PATH",
                    help="validate an existing document and exit (the "
                         "checker is picked by its 'bench' key)")
    args = ap.parse_args(argv)

    if args.check:
        with open(args.check) as f:
            doc = json.load(f)
        errs = _checker_for(doc)(doc)
        for e in errs:
            print(f"SCHEMA: {e}", file=sys.stderr)
        print(f"{args.check}: {'DRIFT' if errs else 'ok'}")
        return 1 if errs else 0

    collective_out = args.collective_out
    if args.collective_only and collective_out is None:
        collective_out = default["BENCH_9"]
    paths = ([] if args.collective_only else [args.out, args.emit_out]) \
        + ([] if collective_out is None else [collective_out])
    for path in paths:
        if os.path.dirname(os.path.abspath(path)) == _ROOT:
            ap.error(f"{path}: the harness writes nothing at the "
                     f"repository root")
    resolve_device(args.device)           # no CUDA device: raise, no fallback

    outputs: List[Tuple[dict, str]] = []
    if not args.collective_only:
        outputs.append((run_bench(smoke=args.smoke, device=args.device),
                        args.out))
        outputs.append((run_emit_bench(smoke=args.smoke,
                                       device=args.device), args.emit_out))
    if collective_out is not None:
        outputs.append((run_collective_bench(smoke=args.smoke,
                                             device=args.device),
                        collective_out))

    errs = [e for doc, _ in outputs for e in _checker_for(doc)(doc)]
    if errs:
        for e in errs:
            print(f"SCHEMA: {e}", file=sys.stderr)
        return 1
    for doc, path in outputs:
        write_outputs(doc, path)
    for doc, _ in outputs:
        for row in doc["rows"]:
            if row["table"] == "collective":
                print(f"collective,{row['mesh']},live={row['live_frac']},"
                      f"{row['variant']},{row['us_median']:.0f}us "
                      f"±{row['us_iqr']:.0f}")
            else:
                tag = f":{row['variant']}" if row["table"] == "emit" else ""
                print(f"{row['table']},{row['workload']},"
                      f"{row['schedule']}{tag},"
                      f"{row['us_median']:.0f}us ±{row['us_iqr']:.0f}")
        if "autotune" in doc:
            c = doc["autotune"]["counters"]
            print(f"autotune: hits={c['hits']} misses={c['misses']} "
                  f"retunes={c['retunes']} "
                  f"log_rows={len(doc['autotune']['log'])}")
    print("wrote " + " and ".join(path for _, path in outputs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
