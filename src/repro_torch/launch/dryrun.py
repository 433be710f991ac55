"""Multi-pod dry run on meta tensors: size every (arch × shape × mesh) cell
— the port of ``repro.launch.dryrun``.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun [--smoke]
      [--arch a,b] [--shape s,t] [--mesh single|multi|both] [--out FILE]

No card is needed and none is used: every tensor is a meta tensor.  For
the 16×16 single-pod mesh and the 2×16×16 multi-pod mesh
(``launch.mesh.make_production_mesh``, abstract), each cell records:

  * ``memory`` (``"memory_source": "specs"``): the per-device bytes of the
    step's arguments — params, optimizer state and batch, and the caches
    for decode — from the partition specs of ``sharding.partition`` on the
    abstract mesh, against the H100's 80 GB (``fits_hbm``).  Without a
    compiler there are no temporaries: the record says so and estimates
    none;
  * ``counted_flops`` (``"meta trace"``): the cell's step run once at its
    full shapes on meta tensors under ``MetaFlopCounter``, which counts as
    ``torch.utils.flop_counter.FlopCounterMode`` does (held equal to it in
    the tests) — forward, backward and update for train, the forward for
    prefill, one tick for decode.  It counts matmul-like ops only
    (mm/bmm/addmm/conv/attention).  A train
    step with microbatches is traced at one sequence and its count scaled
    by the batch (``counted_at``).  This is also the counterpart of "it
    lowers and compiles": a cell whose step cannot run on meta records
    ``count_error`` and keeps its other parts;
  * ``analytic`` and ``roofline`` (``launch.flops``, ``launch.hlo_analysis``
    on the H100's peaks), ``model_flops``, ``params_b``,
    ``active_params_b``, ``fsdp`` and ``microbatches``, as the reference
    records them.

The layout is specs only: the meta tensors are sized by the local shapes
``partition.to_shardings`` gives them (what ``train_loop(mesh=...)``
places on each rank) and no activation rule is installed.
Results go to ``build/dryrun/`` in the checkout; the process exits 1 on
any failed cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, Iterable, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as _tree
from repro_torch.configs import ALL_SHAPES, ARCHS, SMOKE_ARCHS, runs_cell
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import (decode_input_specs,
                                          train_input_specs)
from repro_torch.launch import flops as aflops
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.sharding import partition

HBM_PER_CHIP = ha.HBM_BYTES
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")
LAYOUT = ("partition specs on the abstract mesh, each leaf at the local "
          "shape its NamedSharding places; no activation rules installed")
NO_TEMPS = "no compiler: temporaries and outputs are not counted"


def pick_microbatches(cfg, shape: ShapeConfig, mesh) -> int:
    """Grad-accum splits so per-shard live tokens stay ~8k (activation
    footprint control for the ≥100B configs)."""
    if shape.kind != "train":
        return 1
    dp = partition.axis_size(mesh, partition.dp_axis_names(mesh))
    local_seqs = max(1, shape.global_batch // dp)
    tokens_per_seq = shape.seq_len
    target = 8192
    mb = max(1, (local_seqs * tokens_per_seq) // target)
    while local_seqs % mb != 0:
        mb -= 1
    return max(1, mb)


# ---------------------------------------------------------------------------
# Per-device argument bytes from the partition specs
# ---------------------------------------------------------------------------

def spec_bytes(tree: Any, specs: Any, mesh) -> int:
    """Per-device bytes of ``tree`` laid out by ``specs`` on ``mesh``: each
    leaf at the local shape of its ``partition.NamedSharding`` (every
    sharded dim divides: the rules are divisibility-guarded), the bytes a
    rank of ``train_loop(mesh=...)`` holds."""
    leaves = _tree.leaves(tree)
    shardings = partition.leaves_of_shardings(
        partition.to_shardings(specs, mesh))
    if len(leaves) != len(shardings):
        raise ValueError(f"{len(leaves)} leaves, {len(shardings)} specs")
    return sum(math.prod(s.local_shape(t.shape)) * t.element_size()
               for t, s in zip(leaves, shardings))


def _replicated(tree: Any) -> Any:
    return _tree.tree_map(lambda t: partition.P(*([None] * t.dim())), tree)


def _all_axes_batch(tree: Any, mesh) -> Any:
    """Pure data parallelism: the batch dim over every mesh axis."""
    axes = tuple(mesh.axis_names)
    n = partition.axis_size(mesh, axes)

    def one(t):
        spec = [None] * t.dim()
        if t.dim() and t.shape[0] % n == 0:
            spec[0] = axes
        return partition.P(*spec)

    return _tree.tree_map(one, tree)


# ---------------------------------------------------------------------------
# The step on meta tensors, under the flop counter
# ---------------------------------------------------------------------------

def _meta_of(t: torch.Tensor):
    return tuple(t.shape), t.stride(), t.dtype, t.device.type


# Queries that FlopCounterMode leaves to the tensor (it returns
# NotImplemented for them).
_QUERIES = frozenset((
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default))


class MetaFlopCounter(TorchDispatchMode):
    """``FlopCounterMode``'s count over a run on meta tensors, made cheap
    enough for full-size cells.

    It counts as ``torch.utils.flop_counter.FlopCounterMode`` does — each
    op not decomposed further, by the formula ``flop_registry`` holds for
    it (matmul-like ops; every other op 0), a composite op decomposed
    first — and it remembers the outputs' shapes, strides and dtypes of
    every op that neither mutates nor aliases: a repeat of such an op on
    inputs of the same metadata (shape, strides, dtype and device) gets
    fresh meta outputs of the remembered metadata (and the remembered
    count) without running the op's meta kernel again.  The eager models repeat a few shapes many times (every
    attention tile, every sLSTM time step), and a meta kernel of an
    elementwise op runs in Python, so this is what makes a 32k-token cell
    traceable in minutes.  tests/test_torch_dryrun.py holds its totals to
    ``FlopCounterMode``'s."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._seen: Dict[Any, Any] = {}
        self._pure: Dict[Any, bool] = {}
        self._composite: Dict[Any, bool] = {}

    def _is_pure(self, func) -> bool:
        pure = self._pure.get(func)
        if pure is None:
            sch = func._schema
            pure = not (sch.is_mutable
                        or any(a.alias_info is not None
                               for a in sch.arguments)
                        or any(r.alias_info is not None
                               for r in sch.returns))
            self._pure[func] = pure
        return pure

    def get_total_flops(self) -> int:
        return self.flops

    def _count(self, func, out, args, kwargs) -> int:
        formula = flop_registry.get(func._overloadpacket)
        return 0 if formula is None \
            else formula(*args, **kwargs, out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        composite = self._composite.get(func)
        if composite is None:
            composite = func is not torch.ops.prim.device.default and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd")
            self._composite[func] = composite
        if composite:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if not self._is_pure(func):
            out = func(*args, **kwargs)
            self.flops += self._count(func, out, args, kwargs)
            return out
        key = [func]
        for a in args:
            if isinstance(a, torch.Tensor):
                key.append(_meta_of(a))
            elif isinstance(a, (list, tuple)):
                key.append(tuple(_meta_of(x) if isinstance(x, torch.Tensor)
                                 else x for x in a))
            else:
                key.append(a)
        for k, a in kwargs.items():
            key += [k, _meta_of(a) if isinstance(a, torch.Tensor) else a]
        try:
            key = tuple(key)
            hit = self._seen.get(key)
        except TypeError:                # an argument that does not hash
            key = hit = None
        if hit is not None:
            seq, metas, n = hit
            self.flops += n
            outs = [torch.empty_strided(s, st, dtype=d, device="meta")
                    for s, st, d, _ in metas]
            return seq(outs) if seq else outs[0]
        out = func(*args, **kwargs)
        n = self._count(func, out, args, kwargs)
        self.flops += n
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if key is not None and all(isinstance(o, torch.Tensor) and
                                   o.device.type == "meta" for o in outs):
            self._seen[key] = (type(out) if isinstance(out, (list, tuple))
                               else None, [_meta_of(o) for o in outs], n)
        return out


def count_step_flops(cfg, shape: ShapeConfig, params, *, microbatches: int,
                     moment_dtype=torch.float32, counter=None):
    """(FLOPs of the cell's step, ``counted_at``): the step run once on
    meta tensors under ``counter`` (default ``MetaFlopCounter``; a
    ``FlopCounterMode`` will do).
    A train step with microbatches runs one sequence as one microbatch and
    its count is scaled by the batch; every other step runs its full
    batch."""
    counter = MetaFlopCounter() if counter is None else counter
    scale, counted_at = 1, "full batch"
    with counter:
        if shape.kind == "train":
            batch = train_input_specs(cfg, shape)
            mb = microbatches
            if mb > 1:
                batch, mb = {k: v[:1] for k, v in batch.items()}, 1
                scale, counted_at = shape.global_batch, "1 sequence × B"
            opt = adamw_init(params, moment_dtype=moment_dtype)
            make_train_step(cfg, OptConfig(), microbatches=mb)(
                params, opt, batch)
        elif shape.kind == "prefill":
            make_prefill_step(cfg)(params, train_input_specs(cfg, shape))
        else:
            specs = decode_input_specs(cfg, shape)
            make_decode_step(cfg)(params, specs["token"], specs["caches"],
                                  shape.seq_len - 1, specs.get("memory"))
    return float(counter.get_total_flops() * scale), counted_at


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, cfg, shape: ShapeConfig, *, multi_pod: bool,
               smoke: bool = False, microbatches: Optional[int] = None,
               fsdp: Optional[bool] = None, donate: bool = True,
               pure_dp: bool = False, unroll_decode: bool = False,
               opt_dtype: str = "float32", shard_stash: bool = False,
               tag: str = "baseline", counts: Optional[dict] = None
               ) -> Dict[str, Any]:
    """The record of one cell.  ``counts`` (a dict the caller keeps)
    shares one meta trace between the meshes of a cell: the port's step is
    the same program on every mesh."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(mesh.shape.values())

    params_shapes = aflops.param_shapes(cfg)
    n_params = float(sum(math.prod(t.shape)
                         for t in _tree.leaves(params_shapes)))
    n_active = ha.active_param_count(params_shapes, cfg)
    if fsdp is None:
        fsdp = n_params > 8e9
    if pure_dp:
        fsdp = False
    # the reference's defaults for ≥8B train cells: bf16 Adam moments and
    # the model-sharded remat stash (an activation rule: recorded only)
    if n_params > 8e9 and shape.kind == "train":
        if opt_dtype == "float32":
            opt_dtype = "bfloat16"
        shard_stash = True

    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "params_b": n_params / 1e9,
        "active_params_b": n_active / 1e9, "fsdp": bool(fsdp),
        "tag": tag, "pure_dp": pure_dp,
        "schedule": cfg.attn_schedule,
        "opt_dtype": opt_dtype, "shard_stash": shard_stash,
        "donate": donate, "unroll_decode": unroll_decode,
        "layout": LAYOUT,
        "sources": {"memory": "specs", "analytic": "analytic",
                    "roofline": "analytic",
                    "counted_flops": "meta trace"},
    }
    if unroll_decode and shape.kind == "decode":
        rec["unroll_decode_note"] = "eager decode: no layer scan to unroll"

    def p_specs(tree):
        return _replicated(tree) if pure_dp \
            else partition.params_pspecs(tree, mesh, fsdp=fsdp)

    def b_specs(tree):
        return _all_axes_batch(tree, mesh) if pure_dp \
            else partition.batch_pspecs(tree, mesh)

    mem = {"params_bytes": spec_bytes(params_shapes, p_specs(params_shapes),
                                      mesh)}
    mdt = torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32
    mb = 1
    if shape.kind == "train":
        mb = microbatches or pick_microbatches(cfg, shape, mesh)
        rec["microbatches"] = mb
        opt_shapes = adamw_init(params_shapes, moment_dtype=mdt)
        o_specs = _replicated(opt_shapes) if pure_dp \
            else partition.opt_state_pspecs(opt_shapes, params_shapes, mesh,
                                            fsdp=fsdp)
        mem["opt_state_bytes"] = spec_bytes(opt_shapes, o_specs, mesh)
    if shape.kind != "decode":
        batch = train_input_specs(cfg, shape)
        mem["batch_bytes"] = spec_bytes(batch, b_specs(batch), mesh)
    else:
        specs = decode_input_specs(cfg, shape)
        mem["cache_bytes"] = spec_bytes(
            specs["caches"], partition.cache_pspecs(specs["caches"], mesh),
            mesh)
        batch = {"token": specs["token"], "index": specs["index"]}
        b_sp = {"token": partition.batch_pspecs(specs["token"], mesh),
                "index": partition.P()}
        if "memory" in specs:
            batch["memory"] = specs["memory"]
            b_sp["memory"] = partition.batch_pspecs(specs["memory"], mesh)
        mem["batch_bytes"] = spec_bytes(batch, b_sp, mesh)
    args = sum(v for k, v in mem.items() if k.endswith("_bytes"))
    mem["argument_size_in_bytes"] = int(args)
    mem["temp_size_in_bytes"] = None
    mem["live_bytes"] = int(args)
    mem["fits_hbm"] = bool(args < HBM_PER_CHIP)
    mem["note"] = NO_TEMPS
    rec["memory"] = mem
    rec["memory_source"] = "specs"

    # ---- the step on meta under the flop counter ----
    # the program traced: a train step with microbatches is traced as one
    # sequence in one microbatch, whatever the mesh's split
    key = (cfg, shape, min(mb, 2), opt_dtype)
    hit = None if counts is None else counts.get(key)
    if hit is None:
        t1 = time.time()
        try:
            flops, counted_at = count_step_flops(
                cfg, shape, params_shapes, microbatches=mb,
                moment_dtype=mdt)
            hit = {"counted_flops": flops, "counted_at": counted_at,
                   "count_s": round(time.time() - t1, 1),
                   "counted_on": rec["mesh"]}
        except Exception as e:           # the cell keeps its other parts
            hit = {"count_error": repr(e),
                   "count_traceback": traceback.format_exc()[-2000:],
                   "count_s": round(time.time() - t1, 1),
                   "counted_on": rec["mesh"]}
        if counts is not None:
            counts[key] = hit
    rec.update(hit)
    if "counted_flops" in rec:
        rec["counted_flops_per_device"] = rec["counted_flops"] / n_chips

    # ---- analytic executed cost ----
    if pure_dp:
        dp_n, model_n = n_chips, 1
    else:
        dp_n = partition.axis_size(mesh, partition.dp_axis_names(mesh))
        model_n = partition.axis_size(mesh, "model")
    ac = aflops.analytic_cost(
        cfg, shape, dp_n=dp_n, model_n=model_n,
        microbatches=rec.get("microbatches", 1), fsdp=fsdp)
    rec["analytic"] = {
        "flops_per_device": ac.flops_per_device,
        "hbm_bytes_per_device": ac.hbm_bytes_per_device,
        "coll_bytes_per_device": ac.coll_bytes_per_device,
        "detail": {k: float(v) for k, v in ac.detail.items()},
    }
    mf = ha.model_flops(cfg, shape, n_active)
    rec["model_flops"] = mf
    rl = ha.roofline_terms(
        hlo_flops=ac.flops_per_device, hlo_bytes=ac.hbm_bytes_per_device,
        coll_bytes=ac.coll_bytes_per_device, model_flops=mf,
        dtype=cfg.dtype)
    rec["roofline"] = {
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s, "dominant": rl.dominant,
        "useful_flop_fraction": rl.useful_flop_fraction(n_chips),
        "roofline_fraction": rl.roofline_fraction(n_chips),
        "peak_flops": rl.peak_flops, "hbm_bw": ha.HBM_BW,
        "link_bw": ha.NVLINK_BW,
    }
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _cell_line(tag: str, rec: dict) -> str:
    if rec.get("skipped"):
        return f"[skip] {tag}: {rec['reason']}"
    if not rec.get("ok"):
        return f"[FAIL] {tag}: {rec['error']}"
    r = rec["roofline"]
    live_gib = rec["memory"]["live_bytes"] / 2**30
    rf = r["roofline_fraction"]
    if "count_error" in rec:
        what = f"count_error={rec['count_error']}"
    else:
        what = (f"counted={rec['counted_flops']:.3e} ({rec['counted_at']}, "
                f"{rec['count_s']}s)")
    return (f"[ok]   {tag}: {what} args={live_gib:.2f}GiB "
            f"dominant={r['dominant']} rf={rf and round(rf, 3)}")


def _in_order(order: List[int], results: Iterable) -> Iterator:
    """The results of jobs run in ``order``, given back in job order, each
    as soon as every job before it has finished."""
    done, nxt = {}, 0
    for i, r in zip(order, results):
        done[i] = r
        while nxt in done:
            yield done.pop(nxt)
            nxt += 1


def run_cell(job) -> list:
    """(tag, record) for each mesh of one (arch, shape) cell; the meshes
    share one meta trace.  A job is (arch, cfg, full cfg, shape, meshes,
    lower_cell keywords)."""
    arch, cfg, full_cfg, shape, meshes, kw = job
    ok, why = runs_cell(full_cfg, shape)   # applicability uses real arch
    out, counts = [], {}
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        tag = f"{arch} × {shape.name} × {mesh_name}"
        if not ok:
            rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                   "skipped": True, "reason": why}
        else:
            try:
                rec = lower_cell(arch, cfg, shape, multi_pod=multi_pod,
                                 counts=counts, **kw)
            except Exception as e:
                rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                       "ok": False, "error": repr(e),
                       "traceback": traceback.format_exc()[-2000:]}
        out.append((tag, rec))
    return out


def _trace_tokens(shape: ShapeConfig) -> int:
    """Tokens a cell's meta trace runs through (one sequence; a train step
    forward and backward): the order in which a pool takes the cells, the
    longest traces first, so that none starts last."""
    if shape.kind == "decode":
        return 1
    return shape.seq_len * (3 if shape.kind == "train" else 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (machinery validation)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--shard-stash", action="store_true",
                    help="model-shard the period-boundary remat stash "
                         "(recorded; an activation rule, none installed)")
    ap.add_argument("--tag", default="baseline",
                    help="label recorded per cell (perf-iteration log)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="replicate params; all mesh axes as DP (small archs)")
    ap.add_argument("--unroll-decode", action="store_true",
                    help="recorded only: the eager decode has no layer "
                         "scan to unroll")
    ap.add_argument("--schedule", default=None, choices=[None, "rect", "tri"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--device-limited", type=int, default=0,
                    help="top-M expert device groups per token (deepseek-v2)")
    ap.add_argument("--sparse-ffn", action="store_true",
                    help="relu2 FFN through the paper's sparse-bwd units")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, one (arch, shape) cell each, "
                         "the longest traces first (a meta trace runs on "
                         "one core); the output keeps the cells' order")
    args = ap.parse_args()

    table = SMOKE_ARCHS if args.smoke else ARCHS
    archs = list(table) if args.arch == "all" else args.arch.split(",")
    shapes = {s.name: s for s in ALL_SHAPES}
    sel_shapes = list(shapes.values()) if args.shape == "all" \
        else [shapes[s] for s in args.shape.split(",")]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    out_path = args.out or os.path.join(
        RESULTS_DIR, f"dryrun{'_smoke' if args.smoke else ''}.jsonl")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    kw = dict(smoke=args.smoke, microbatches=args.microbatches, fsdp=fsdp,
              pure_dp=args.pure_dp, unroll_decode=args.unroll_decode,
              opt_dtype=args.opt_dtype, shard_stash=args.shard_stash,
              tag=args.tag)
    jobs = []
    for arch in archs:
        cfg = table[arch]
        if args.schedule:
            cfg = cfg.with_(attn_schedule=args.schedule)
        if args.capacity_factor is not None and cfg.moe is not None:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=args.capacity_factor))
        if args.device_limited and cfg.moe is not None:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, device_groups=16, top_groups=args.device_limited))
        if args.sparse_ffn:
            cfg = cfg.with_(ffn_activation="relu2",
                            sparse_ffn_scenario="IN_OUT")
        jobs += [(arch, cfg, ARCHS[arch], shape, meshes, kw)
                 for shape in sel_shapes]

    n_ok = n_fail = n_skip = n_count_err = 0
    t_all = time.time()
    with contextlib.ExitStack() as stack:
        if args.jobs > 1:
            order = sorted(range(len(jobs)),
                           key=lambda i: -_trace_tokens(jobs[i][3]))
            pool = stack.enter_context(
                multiprocessing.get_context("spawn").Pool(args.jobs))
            results = _in_order(order, pool.imap(
                run_cell, [jobs[i] for i in order]))
        else:
            results = map(run_cell, jobs)
        f = stack.enter_context(open(out_path, "a"))
        for cell in results:
            for tag, rec in cell:
                print(_cell_line(tag, rec), flush=True)
                if rec.get("skipped"):
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                    n_count_err += "count_error" in rec
                else:
                    n_fail += 1
                f.write(json.dumps(rec) + "\n")
                f.flush()
    print(f"\ndone: {n_ok} ok ({n_count_err} with count_error), {n_fail} "
          f"failed, {n_skip} skipped in {time.time() - t_all:.1f} s → "
          f"{out_path}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
