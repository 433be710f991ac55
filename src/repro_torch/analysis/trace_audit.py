"""Lifecycle audit: prove the bitmap contract on one executed step — the
port of ``repro.analysis.jaxpr_audit``.

The reference walks a jaxpr, the whole dataflow of a step, without running
it.  Eager PyTorch has no graph until it runs, so this audit RUNS the step
once under a ``TorchDispatchMode`` that logs every op of the forward and
the backward (on the card the autograd engine's device thread inherits the
mode) with:

  * the open lifecycle tags (``kernels.stats.lifecycle_scope``, the
    reference's ``repro:<kind>[:<detail>]:<seq>`` grammar) and the
    innermost ``layer:<name>``;
  * the storages each op read and wrote.  A storage is keyed by (data
    pointer, generation): the generation of an address moves on whenever a
    storage the trace has not seen turns up there (a weak reference to the
    storage object tells), so the caching allocator's reuse of an address
    never joins two tensors, and the log holds no strong reference to any
    tensor.

The CUDA kernels launch through ctypes, which the dispatcher never sees;
each wrapper notes its operands and results (``stats.note_kernel``), and
the note enters the log as an op named ``kernel:<name>``, so the dataflow
passes through a kernel on the card as it passes through the plain
version's aten ops on the CPU.

The checks are the reference's, each on the log:

  RESCAN           the same tensor is scanned/encoded for a bitmap more
                   than once per step (ONE fused encode per activation;
                   every later mask is derived).  Under ``cfg.remat`` the
                   backward recomputes each checkpointed region, its
                   encodes included, inside a ``repro:remat`` tag: an
                   encode so tagged, of a tensor the first forward
                   encoded in the same layer, is that activation's
                   recomputation, not a rescan.
  UNDERIVED_MASK   an integer mask enters a GEMM dispatch without being
                   reachable from an encode/scan/derive/queue/collective
                   region through pure bitmap arithmetic.
  DENSE_GEMM       an ``aten`` mm/bmm/addmm/baddbmm/matmul/linear/einsum
                   outside any ``sparse_gemm`` dispatch region.
  DENSE_SCHEDULE   a dispatch region resolved to ``schedule="dense"`` while
                   the audit expects the kernels.
  CONV_FALLBACK    an ``aten`` convolution inside the counted fallback
                   region (a layer escaped the engine); DENSE_CONV one
                   outside any region (an uncounted dense conv).
  SPEC_UNRESOLVED  a ``sparse_gemm`` dispatch whose ``GemmSpec`` was not
                   resolved by ``SparsityPolicy.gemm_spec``
                   (``kernels.ops.collect_gemm_events``).
  COLLECTIVE_UNTAGGED  a ``c10d`` collective outside any
                   ``repro:collective:*`` region.

The mode only observes: the audited step computes what an unaudited one
does, bit for bit.  What the audit sees is the branch the step took (one
side of the overflow decision, one side of the compressed all-reduce's
choice), where the reference's jaxpr holds both sides of a ``lax.cond``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import shutil
import tempfile
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, stats

from .report import Violation

# Ops that forward bitmap/array content without computing anything new
# from it: a mask may flow through these on its way from a producer region
# to a consumer without breaking derivation provenance (the reference's
# convert_element_type, reshape, transpose, squeeze, expand_dims,
# broadcast_in_dim, slice, dynamic_slice, pad, concatenate, copy,
# stop_gradient and rev, as aten names them).
TRIVIAL_OPS = {
    "_to_copy", "to", "view", "_unsafe_view", "reshape", "_reshape_alias",
    "transpose", "t", "permute", "squeeze", "unsqueeze", "expand",
    "slice", "select", "as_strided", "narrow", "constant_pad_nd", "pad",
    "cat", "stack", "clone", "contiguous", "copy", "copy_", "detach",
    "alias", "lift_fresh", "lift_fresh_copy", "flip",
}
# The subset the RESCAN check looks through when it asks whether two scans
# read the same tensor: one input, its content unchanged.
CONTENT_PRESERVING_OPS = {
    "_to_copy", "to", "view", "_unsafe_view", "reshape", "_reshape_alias",
    "transpose", "t", "permute", "squeeze", "unsqueeze", "clone",
    "contiguous", "copy", "detach", "alias",
}

# "collective" grounds masks too: the union bitmap of a bitmap all-reduce
# is derived metadata (an OR across ranks of already-grounded bitmaps).
GROUNDING_KINDS = {"encode", "scan", "derive", "queue", "collective"}

# Dense products: what ``dot_general`` is in the reference.  matmul,
# linear and einsum decompose before the dispatcher; they are listed so a
# mode that sees them undecomposed reads them too.
DENSE_GEMM_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear", "einsum",
    "dot", "vdot", "mv", "addmv", "_addmm_activation",
}

# Cross-rank ops that move tensor data (the reference's psum, all_gather,
# all_to_all, reduce_scatter, ppermute, pmax, pmin), in the namespaces of
# ``torch.distributed`` and its functional collectives.
COLLECTIVE_NAMESPACES = {"c10d", "_c10d_functional", "c10d_functional"}
NON_DATA_COLLECTIVES = {"barrier", "monitored_barrier", "wait_tensor"}


@dataclasses.dataclass
class ParsedTag:
    kind: str          # encode | scan | derive | queue | gemm | fallback | ...
    detail: str        # e.g. "act", "grad", "compact:1"
    tag: str           # the full unique tag (region identity)


def parse_tag(tag: str) -> ParsedTag:
    parts = tag.split(":")
    # repro:<kind>[:<detail>...]:<seq>
    return ParsedTag(kind=parts[1], detail=":".join(parts[2:-1]), tag=tag)


class Arg(NamedTuple):
    """One tensor an op read or wrote: its storage key (data pointer,
    generation), dtype class ("f" float, "i" integer, "b" bool, "c"
    complex), element count and storage offset."""
    key: Tuple[int, int]
    kind: str
    numel: int
    offset: int


@dataclasses.dataclass
class OpRecord:
    index: int
    name: str                     # aten base name, or "kernel:<name>"
    full_name: str                # e.g. "aten.mm.default"
    namespace: str
    tag: Optional[ParsedTag]      # innermost lifecycle region, if any
    layer: str                    # innermost layer:<name>, or ""
    remat: bool                   # inside a recomputation (repro:remat)
    ins: Tuple[Arg, ...]
    outs: Tuple[Arg, ...]         # fresh results and written inputs


def _kind(t: torch.Tensor) -> str:
    if t.dtype == torch.bool:
        return "b"
    if t.dtype.is_floating_point:
        return "f"
    if t.dtype.is_complex:
        return "c"
    return "i"


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _ptr(t: torch.Tensor) -> int:
    s = _storage(t)
    return 0 if s is None else s.data_ptr()


class Trace:
    """The log of one audited run: ops in execution order, the writers of
    every storage, and the specs ``sparse_gemm`` was dispatched with."""

    def __init__(self):
        self.ops: List[OpRecord] = []
        self.writers: Dict[Tuple[int, int], List[int]] = \
            collections.defaultdict(list)
        self.gemm_specs: List[Any] = []
        self._gen: Dict[int, int] = {}
        self._live: Dict[int, "weakref.ref"] = {}

    # -- logging --
    def _arg(self, t: torch.Tensor) -> Optional[Arg]:
        s = _storage(t)
        p = 0 if s is None else s.data_ptr()
        if p == 0:
            return None
        ref = self._live.get(p)
        if ref is None or ref() is not s:
            # A storage this trace has not seen at p: a new generation.
            self._gen[p] = self._gen.get(p, 0) + 1
            self._live[p] = weakref.ref(s)
        return Arg((p, self._gen[p]), _kind(t), t.numel(), t.storage_offset())

    def args(self, tensors) -> List[Arg]:
        """The ``Arg`` of each tensor as it stands now (before the op)."""
        return [a for a in (self._arg(t) for t in tensors) if a is not None]

    def record(self, full_name: str, namespace: str, name: str,
               ins: List[Arg], fresh, written) -> None:
        """Log one op: ``ins`` read (taken before it ran); ``fresh``
        results in new storages and ``written`` inputs it wrote, both
        written by it."""
        tags = stats.open_tags()
        layer = stats.current_layer() or ""
        outs = self.args(list(fresh) + list(written))
        idx = len(self.ops)
        self.ops.append(OpRecord(
            idx, name, full_name, namespace,
            parse_tag(tags[-1]) if tags else None, layer,
            any(t.startswith("repro:remat:") for t in tags), tuple(ins),
            tuple(outs)))
        for a in outs:
            self.writers[a.key].append(idx)

    # -- reading --
    def regions(self) -> Dict[str, List[OpRecord]]:
        out: Dict[str, List[OpRecord]] = {}
        for op in self.ops:
            if op.tag is not None:
                out.setdefault(op.tag.tag, []).append(op)
        return out

    def region_counts(self, detail: bool = False) -> Dict[str, int]:
        """Regions by kind (or by kind:detail) that ran at least one op."""
        c: "collections.Counter[str]" = collections.Counter()
        for ops_ in self.regions().values():
            t = ops_[0].tag
            c[f"{t.kind}:{t.detail}" if detail and t.detail else t.kind] += 1
        return dict(c)

    def writers_before(self, key, index: int) -> List[OpRecord]:
        return [self.ops[w] for w in self.writers.get(key, ()) if w < index]


def _is_write(arg_schema) -> bool:
    info = arg_schema.alias_info
    return info is not None and info.is_write


class _Recorder(TorchDispatchMode):
    """Logs every op run under it into a ``Trace`` (and runs it as is)."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "profiler":
            return func(*args, **kwargs)
        inputs = [t for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        in_ptrs = {_ptr(t) for t in inputs}
        ins = self.trace.args(inputs)
        out = func(*args, **kwargs)
        written = []
        for i, a in enumerate(func._schema.arguments):
            if not _is_write(a):
                continue
            v = args[i] if i < len(args) and not a.kwarg_only \
                else kwargs.get(a.name)
            written += [t for t in tree_leaves(v)
                        if isinstance(t, torch.Tensor)]
        # A written input whose storage moved (a resize) is a fresh one.
        fresh = [t for t in tree_leaves(out) + written
                 if isinstance(t, torch.Tensor) and _ptr(t) not in in_ptrs]
        written = [t for t in written if _ptr(t) in in_ptrs]
        name = func.__name__.split(".")[0]
        self.trace.record(str(func), ns, name, ins, fresh, written)
        return out


def trace_fn(fn: Callable, *args) -> Tuple[Any, Trace]:
    """Run ``fn(*args)`` once under the audit's dispatch mode and kernel
    hook; returns its result and the ``Trace`` they filled."""
    trace = Trace()

    def on_kernel(name, inputs, outputs):
        ins = trace.args(t for t in inputs if t is not None)
        outs = [t for t in outputs if t is not None]
        trace.record(f"kernel:{name}", "kernel", f"kernel:{name}", ins, (),
                     outs)

    prev = stats.set_kernel_hook(on_kernel)
    try:
        with ops.collect_gemm_events() as events, _Recorder(trace):
            out = fn(*args)
        trace.gemm_specs = list(events)
    finally:
        stats.set_kernel_hook(prev)
    return out, trace


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def _region_layer(region: List[OpRecord]) -> str:
    for op in region:
        if op.layer:
            return op.layer
    return ""


def _outside_inputs(trace: Trace, region: List[OpRecord]):
    """(op, arg) pairs: inputs of the region's ops that no earlier op of
    the region wrote."""
    ids = {op.index for op in region}
    for op in region:
        for a in op.ins:
            ws = trace.writers_before(a.key, op.index)
            if ws and ws[-1].index in ids:
                continue
            yield op, a


def _principal_input(trace: Trace, region: List[OpRecord]):
    """The largest floating-point tensor a scan/encode region consumes from
    outside itself — the tensor being scanned — as (arg, reading op)."""
    best, best_op = None, None
    for op, a in _outside_inputs(trace, region):
        if a.kind != "f":
            continue
        if best is None or a.numel > best.numel:
            best, best_op = a, op
    return best, best_op


def _canonical_tensor(trace: Trace, a: Arg, index: int):
    """Walk back through content-preserving copies and casts so the 'same
    tensor scanned twice' check does not see a re-layout as a new tensor
    (a view shares its storage already)."""
    seen = set()
    while (a.key, a.offset) not in seen:
        seen.add((a.key, a.offset))
        ws = trace.writers_before(a.key, index)
        if len(ws) != 1:
            return a.key, a.offset
        w = ws[0]
        if w.name in CONTENT_PRESERVING_OPS and w.tag is None:
            ins = [x for x in w.ins if x.key != a.key]
            if len(ins) == 1:
                a, index = ins[0], w.index
                continue
        return a.key, a.offset
    return a.key, a.offset


def _check_rescan(trace: Trace, regions, workload) -> List[Violation]:
    out = []
    seen: Dict[Any, Tuple[str, str]] = {}
    for tag, region in regions.items():
        parsed = region[0].tag
        if parsed.kind not in ("scan", "encode"):
            continue
        src, op = _principal_input(trace, region)
        if src is None:
            continue
        ident = _canonical_tensor(trace, src, op.index)
        layer = _region_layer(region)
        if ident in seen:
            first_tag, first_layer = seen[ident]
            if region[0].remat and layer == first_layer:
                continue          # the recomputation of a remat region
            out.append(Violation(
                "trace", "RESCAN", layer or first_layer,
                f"tensor scanned twice: {parsed.kind} region {tag} re-scans "
                f"the input of region {first_tag} — derive the mask instead",
                workload))
        else:
            seen[ident] = (tag, layer)
    return out


def _trace_mask_origin(trace: Trace, arg: Arg, index: int,
                       consumer_ids) -> Optional[OpRecord]:
    """None if every path to ``arg`` (as op ``index`` read it) grounds in
    a sanctioned producer region / a creation op / a step input; else the
    offending op."""
    stack, seen = [(arg, index)], set()
    while stack:
        a, at = stack.pop()
        if (a.key, at) in seen:
            continue
        seen.add((a.key, at))
        for w in trace.writers_before(a.key, at):
            if w.index in consumer_ids:
                stack += [(x, w.index) for x in w.ins]   # dispatcher plumbing
                continue
            if w.tag is not None and w.tag.kind in GROUNDING_KINDS:
                continue                                 # grounded
            if w.tag is not None and w.tag.kind == "gemm":
                continue  # another dispatch's (checked) output
            if not w.ins:
                continue  # zeros/arange etc: index arithmetic, not data
            if w.name in TRIVIAL_OPS or all(x.kind in "ib" for x in w.ins):
                stack += [(x, w.index) for x in w.ins]   # bitmap arithmetic
                continue
            return w   # computes int data from float tensors, untagged
    return None


def _check_masks_derived(trace: Trace, regions, workload) -> List[Violation]:
    out = []
    for tag, region in regions.items():
        parsed = region[0].tag
        if parsed.kind != "gemm":
            continue
        layer = _region_layer(region)
        ids = {op.index for op in region}
        inputs = {}
        for op, a in _outside_inputs(trace, region):
            if a.kind in "ib":
                inputs.setdefault(a.key, (a, op.index))
        for a, index in inputs.values():
            bad = _trace_mask_origin(trace, a, index, ids)
            if bad is not None:
                out.append(Violation(
                    "trace", "UNDERIVED_MASK", layer,
                    f"mask entering dispatch {tag} originates in untagged "
                    f"op '{bad.full_name}' — sparsity metadata must come "
                    f"from encode/scan/derive/queue", workload))
                break  # one report per dispatch is enough
    return out


def _check_dense_ops(trace: Trace, workload,
                     expect_kernels: bool) -> List[Violation]:
    out = []
    for op in trace.ops:
        kind = op.tag.kind if op.tag else None
        scope = op.tag.tag if op.tag else "<none>"
        if op.namespace == "aten" and op.name in DENSE_GEMM_OPS \
                and kind != "gemm":
            out.append(Violation(
                "trace", "DENSE_GEMM", op.layer,
                f"{op.full_name} outside any sparse_gemm dispatch region "
                f"(scope: {scope})", workload))
        if op.namespace == "aten" and "convolution" in op.name:
            if kind == "fallback":
                out.append(Violation(
                    "trace", "CONV_FALLBACK", op.layer,
                    "layer escaped the conv engine onto the counted dense "
                    "fallback", workload))
            else:
                out.append(Violation(
                    "trace", "DENSE_CONV", op.layer,
                    f"uncounted {op.full_name} on the audited path",
                    workload))
        if expect_kernels and kind == "gemm" \
                and op.tag.detail.startswith("dense"):
            out.append(Violation(
                "trace", "DENSE_SCHEDULE", op.layer,
                f"dispatch {op.tag.tag} resolved to schedule='dense' "
                f"under a kernel-audited workload", workload))
    # One region spans many ops: dedupe by message.
    deduped, seen = [], set()
    for v in out:
        key = (v.code, v.message)
        if key not in seen:
            seen.add(key)
            deduped.append(v)
    return deduped


def _check_collectives(trace: Trace, workload) -> List[Violation]:
    """Every cross-rank data movement must sit in a collective region: an
    untagged all-reduce is gradient traffic that bypassed the bitmap-aware
    all-reduce (its compression, its counts and its fault tap)."""
    out, seen = [], set()
    for op in trace.ops:
        if op.namespace not in COLLECTIVE_NAMESPACES \
                or op.name.rstrip("_") in NON_DATA_COLLECTIVES:
            continue
        if op.tag is not None and op.tag.kind == "collective":
            continue
        scope = op.tag.tag if op.tag else ""
        key = (op.layer, op.full_name, scope)
        if key in seen:
            continue
        seen.add(key)
        out.append(Violation(
            "trace", "COLLECTIVE_UNTAGGED", op.layer,
            f"'{op.full_name}' outside any repro:collective region (scope: "
            f"{scope or '<none>'}) — cross-rank traffic must go through "
            f"sharding/collectives", workload))
    return out


def _check_specs(trace: Trace, workload) -> List[Violation]:
    out = []
    for spec in trace.gemm_specs:
        if spec.origin != "policy":
            out.append(Violation(
                "trace", "SPEC_UNRESOLVED", "",
                f"sparse_gemm dispatched with an ad-hoc GemmSpec "
                f"(origin={spec.origin!r}, schedule={spec.schedule!r}); "
                f"resolve specs through SparsityPolicy.gemm_spec",
                workload))
    return out


def audit_trace(trace: Trace, *, workload: str = "",
                expect_kernels: bool = True) -> List[Violation]:
    """Run every check on an already-recorded ``Trace``."""
    regions = trace.regions()
    out: List[Violation] = []
    out += _check_rescan(trace, regions, workload)
    out += _check_masks_derived(trace, regions, workload)
    out += _check_dense_ops(trace, workload, expect_kernels)
    out += _check_collectives(trace, workload)
    out += _check_specs(trace, workload)
    return out


def audit_fn(fn: Callable, *args, workload: str = "",
             expect_kernels: bool = True) -> List[Violation]:
    """Run ``fn(*args)`` once under the recorder and audit the log,
    including the GemmSpec provenance check."""
    _, trace = trace_fn(fn, *args)
    return audit_trace(trace, workload=workload,
                       expect_kernels=expect_kernels)


# ---------------------------------------------------------------------------
# Standard audited workloads — the zero-violation gate
# ---------------------------------------------------------------------------

def audit_policy():
    """IN_OUT_WR on the kernels at an (8, 8, 8) block, as the reference's
    ``_audit_policy``."""
    from repro_torch.core import policy as pol
    return pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))


def cnn_batch(image_size: int, batch: int, num_classes: int, seed: int = 0):
    """(images NHWC float32, labels int32) numpy arrays from ``seed``."""
    r = np.random.RandomState(seed)
    images = r.randn(batch, image_size, image_size, 3).astype(np.float32)
    labels = r.randint(0, num_classes, size=(batch,)).astype(np.int32)
    return images, labels


def grad_step(loss_fn: Callable, params: Dict[str, Any]) -> Callable:
    """A thunk returning ``(loss, grads)`` of ``loss_fn(params)`` with the
    gradients in the order of ``params``' leaves."""
    from repro_torch import tree as _tree

    def step():
        leaves = _tree.leaves(params)
        loss = loss_fn(params)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    return step


def cnn_step(name: str, *, image_size: int, width: float, batch: int = 2,
             num_classes: int = 10, device=None, params=None, images=None,
             labels=None) -> Callable:
    """One CNN training step's ``(loss, grads)`` thunk: the model's params
    from seed 0 (or ``params``), a numpy batch from seed 0 (or
    ``images``/``labels``), on ``device``."""
    from repro_torch.models.cnn import build_cnn
    dev = resolve_device(device)
    model = build_cnn(name, image_size=image_size, width=width,
                      num_classes=num_classes)
    if params is None:
        params = model.init(0, device=dev)
    if images is None:
        images, labels = cnn_batch(image_size, batch, num_classes)
    x = torch.as_tensor(images, device=dev)
    y = torch.as_tensor(labels, device=dev)
    pol = audit_policy()
    return grad_step(lambda p: model.loss(p, x, y, pol), params)


def ffn_config():
    from repro_torch.models.ffn import FFNConfig
    return FFNConfig(d_model=16, d_ff=32, activation="relu",
                     sparse_policy=audit_policy())


def ffn_step(*, batch: int = 4, device=None, params=None,
             x=None) -> Callable:
    """The ReLU FFN's ``(loss, grads)`` thunk, loss = Σ ffn(x)²."""
    from repro_torch.models.ffn import ffn_apply, ffn_init
    dev = resolve_device(device)
    cfg = ffn_config()
    if params is None:
        params = ffn_init(0, cfg, device=dev)
    if x is None:
        x = np.random.RandomState(0).randn(batch, cfg.d_model) \
            .astype(np.float32)
    xt = torch.as_tensor(x, device=dev)
    return grad_step(lambda p: (ffn_apply(p, xt, cfg) ** 2).sum(), params)


@contextlib.contextmanager
def world_of_one(device):
    """A ``("data",)`` mesh over a gloo process group of one rank, joined
    here (by a file under a temporary directory) and left on exit; a
    process that already joined a gloo world of one keeps its group.  As
    the reference's one-device mesh, every collective then runs, on one
    rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_mesh, init_mesh
    if dist.is_initialized():
        yield init_mesh((1,), ("data",), backend="gloo", device=device)
        return
    tmp = tempfile.mkdtemp(prefix="repro_audit_")
    try:
        yield init_mesh((1,), ("data",), backend="gloo", device=device,
                        rank=0, world_size=1,
                        init_method="file://" + os.path.join(tmp, "rdv"))
    finally:
        close_mesh()
        shutil.rmtree(tmp, ignore_errors=True)


def ffn_spmd_step(mesh, *, batch: int = 4, device=None, params=None,
                  x=None) -> Callable:
    """The ReLU FFN's data-parallel ``(loss, grads)`` thunk through
    ``sharding.spmd_step.make_spmd_grad_fn`` over ``mesh``."""
    from repro_torch.models.ffn import ffn_apply, ffn_init
    from repro_torch.sharding import spmd_step
    dev = resolve_device(device)
    cfg = ffn_config()
    if params is None:
        params = ffn_init(0, cfg, device=dev)
    if x is None:
        x = np.random.RandomState(0).randn(batch, cfg.d_model) \
            .astype(np.float32)
    xt = torch.as_tensor(x, device=dev)
    f = spmd_step.make_spmd_grad_fn(
        lambda p, xb: (ffn_apply(p, xb, cfg) ** 2).sum(), mesh)
    return lambda: f(params, xt)


def cnn_spmd_step(mesh, name: str, *, image_size: int, width: float,
                  batch: int = 2, num_classes: int = 10, device=None,
                  params=None, images=None, labels=None) -> Callable:
    """One CNN step's data-parallel ``(loss, grads)`` thunk over ``mesh``."""
    from repro_torch.models.cnn import build_cnn
    from repro_torch.sharding import spmd_step
    dev = resolve_device(device)
    model = build_cnn(name, image_size=image_size, width=width,
                      num_classes=num_classes)
    if params is None:
        params = model.init(0, device=dev)
    if images is None:
        images, labels = cnn_batch(image_size, batch, num_classes)
    b = {"images": torch.as_tensor(images, device=dev),
         "labels": torch.as_tensor(labels, device=dev)}
    pol = audit_policy()
    f = spmd_step.make_spmd_grad_fn(
        lambda p, bb: model.loss(p, bb["images"], bb["labels"], pol), mesh)
    return lambda: f(params, b)


@contextlib.contextmanager
def _local(step):
    yield step


@contextlib.contextmanager
def _spmd(build, device, **kw):
    with world_of_one(device) as mesh:
        yield build(mesh, device=device, **kw)


# name -> (device -> context manager yielding the step thunk), at the
# reference's sizes (``repro.analysis.jaxpr_audit.WORKLOADS``).
WORKLOADS: Dict[str, Callable[[torch.device], Any]] = {
    # VGG16: the deep sequential CNN (dense convs at every depth).
    "vgg16": lambda dev: _local(cnn_step("vgg16", image_size=16,
                                         width=0.125, device=dev)),
    # MobileNet: the depthwise/pointwise stack — the grouped engine with
    # degenerate K = R·S tiles end to end.
    "mobilenet": lambda dev: _local(cnn_step("mobilenet", image_size=16,
                                             width=0.25, device=dev)),
    # ReLU-FFN: the linear-layer fused unit (act_matmul/matmul path).
    "ffn_relu": lambda dev: _local(ffn_step(device=dev)),
    # SPMD variants: the same units through the data-parallel step with
    # the bitmap-compressed gradient all-reduce, on a gloo world of one.
    "ffn_relu_spmd": lambda dev: _spmd(ffn_spmd_step, dev),
    "vgg16_spmd": lambda dev: _spmd(
        lambda mesh, **kw: cnn_spmd_step(mesh, "vgg16", image_size=16,
                                         width=0.125, **kw), dev),
}


def audit_workloads(names=None, device=None) -> List[Violation]:
    """Run and audit the standard workloads on ``device`` (default the
    card; ``"cpu"`` for the plain versions); [] is the contract."""
    dev = resolve_device(device)
    out: List[Violation] = []
    for name in (names or sorted(WORKLOADS)):
        with WORKLOADS[name](dev) as step:
            out += audit_fn(step, workload=name)
    return out
