"""Parameter / activation / cache partitioning rules (DP, TP, EP, SP, FSDP)
— the port of ``repro.sharding.partition``.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model")
multi-pod.  ``pod`` + ``data`` together form the data-parallel (and FSDP)
domain; ``model`` carries tensor/expert parallelism.

Every rule is divisibility-guarded: a dimension is sharded only if the axis
size divides it, otherwise the rule degrades (next candidate dim, or
replication), so one rule table serves every architecture.  ``fsdp``
also spreads the largest replicated dim of every large param over the data
domain.

The functions take any tree whose leaves have ``.shape`` (meta tensors
will do) and return the same structure with ``PartitionSpec`` leaves,
equal entry for entry to the reference's.  The data-parallel path reads
``dp_axis_names``, ``axis_size`` and ``bitmap_pspec``; placing params by
these specs (``params_shardings``, ``to_shardings``) is the jit
partitioner's half, ROADMAP A18b.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Tuple

from repro_torch import tree as _tree

A18B = ("placing tensors by partition specs (tensor parallelism, FSDP) is "
        "ROADMAP A18b; the data-parallel path replicates every param")


class PartitionSpec(tuple):
    """A tuple of per-dim entries: None, an axis name, or a tuple of names
    (a one-name tuple is stored as the name, as JAX's spec does)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1
            else (tuple(e) if isinstance(e, (tuple, list)) else e)
            for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(tuple(self)).replace(
            ",)", ")")


P = PartitionSpec


def spec_leaves(tree: Any, prefix: str = "") -> list:
    """(keystr path, spec) pairs of a tree whose leaves are
    ``PartitionSpec``s (which ``repro_torch.tree`` would take for nodes),
    in the reference's flatten order."""
    if isinstance(tree, PartitionSpec):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in spec_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in spec_leaves(v, f"{prefix}[{i}]")]
    return []


def normalize_path(keystr_path: str) -> str:
    """keystr "['layers']['b0']['attn']['wq']" → "layers/b0/attn/wq"."""
    return keystr_path.replace("']['", "/").replace("['", "") \
        .replace("']", "").replace("[", "/").replace("]", "")


def dp_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    s = 1
    for n in names:
        s *= mesh.shape[n]
    return s


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# (path regex, per-dim logical role) — roles: "model" (TP/EP candidate),
# "fsdp" (FSDP candidate), None.  First match wins; dims listed from 0.
_PARAM_RULES = [
    (r"embed$",                ("model", "fsdp")),       # (V, d) vocab-TP
    (r"lm_head$",              ("fsdp", "model")),       # (d, V)
    (r"frontend_proj$",        (None, "model")),
    (r"(norm|scale|bias|b_i$|b_f$|dt_bias|d_skip|conv_b)", None),
    # attention
    (r"attn.*w[qkv]$",         ("fsdp", "model")),       # (d, H·Dh)
    (r"attn.*wo$",             ("model", "fsdp")),       # (H·Dh, d)
    (r"attn.*wdkv$",           ("fsdp", None)),          # (d, r) small
    (r"attn.*wkr$",            (None, None)),
    (r"attn.*wu[kv]$",         (None, "model")),         # (r, H·dim)
    (r"cross.*w[qkv]$",        ("fsdp", "model")),
    (r"cross.*wo$",            ("model", "fsdp")),
    # dense FFN
    (r"ffn.*w_(gate|up)$",     ("fsdp", "model")),       # (d, ff)
    (r"ffn.*w_down$",          ("model", "fsdp")),       # (ff, d)
    (r"shared.*w_(gate|up)$",  ("fsdp", "model")),
    (r"shared.*w_down$",       ("model", "fsdp")),
    # MoE experts (E, d, f) / (E, f, d): EP on E, fallback TP on f
    (r"moe.*router$",          (None, None)),
    (r"moe.*w_(gate|up)$",     ("model", "fsdp", "model_alt")),
    (r"moe.*w_down$",          ("model", "model_alt", "fsdp")),
    # Mamba
    (r"ssm.*w_in$",            ("fsdp", "model")),       # (d, 2di)
    (r"ssm.*conv_w$",          (None, "model")),
    (r"ssm.*w_x$",             ("model", None)),         # (di, r+2ds)
    (r"ssm.*w_dt$",            (None, "model")),         # (r, di)
    (r"ssm.*a_log$",           ("model", None)),
    (r"ssm.*w_out$",           ("model", "fsdp")),       # (di, d)
    # xLSTM
    (r"mlstm.*w_up$",          ("fsdp", "model")),
    (r"mlstm.*w_[qkv]$",       (None, "model")),
    (r"mlstm.*w_[if]$",        (None, None)),
    (r"mlstm.*w_down$",        ("model", "fsdp")),
    (r"slstm.*w_ifzo$",        ("fsdp", "model")),
    (r"slstm.*r_[ifzo]$",      None),                    # small recurrent mats
    (r"slstm.*w_ff1$",         ("fsdp", "model")),
    (r"slstm.*w_ff2$",         ("model", "fsdp")),
    # CNN / generic heads
    (r"head",                  (None, None)),
    (r"\bw$",                  None),
]

_FSDP_MIN_SIZE = 1 << 22      # only FSDP-shard params ≥ 4M elements


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               *, fsdp: bool = False, scan_outer: bool = False) -> P:
    """PartitionSpec for one param.  ``scan_outer``: leading period axis
    (stacked layers) — never sharded, prepended as None."""
    dims = list(shape[1:]) if scan_outer else list(shape)
    rule = None
    for pat, r in _PARAM_RULES:
        if re.search(pat, path):
            rule = r
            break
    model_n = axis_size(mesh, "model")
    dp = dp_axis_names(mesh)
    dp_n = axis_size(mesh, dp)
    spec: list = [None] * len(dims)
    if rule is not None:
        model_used = False
        for i, role in enumerate(rule[:len(dims)]):
            if role == "model" and not model_used \
                    and _divisible(dims[i], model_n):
                spec[i] = "model"
                model_used = True
        if not model_used:          # fallback: model_alt slots
            for i, role in enumerate(rule[:len(dims)]):
                if role == "model_alt" and _divisible(dims[i], model_n):
                    spec[i] = "model"
                    model_used = True
                    break
        if fsdp and math.prod(shape) >= _FSDP_MIN_SIZE:
            for i, role in enumerate(rule[:len(dims)]):
                if role == "fsdp" and spec[i] is None \
                        and _divisible(dims[i], dp_n):
                    spec[i] = dp
                    break
    if scan_outer:
        spec = [None] + spec
    return P(*spec)


def _is_scanned(path: str) -> bool:
    return "layers/" in path


def params_pspecs(params_shapes: Any, mesh, *, fsdp: bool = False) -> Any:
    """Tree of PartitionSpec matching a params(-shaped) tree."""
    out = []
    for kp, leaf in _tree.leaves_with_paths(params_shapes):
        path = normalize_path(kp)
        out.append(param_spec(path, tuple(leaf.shape), mesh, fsdp=fsdp,
                              scan_outer=_is_scanned(path)))
    return _tree.unflatten_like(params_shapes, out)


def params_shardings(params_shapes: Any, mesh, *, fsdp: bool = False):
    raise NotImplementedError(f"params_shardings: {A18B}")


def opt_state_pspecs(opt_shapes: Any, params_shapes: Any, mesh,
                     *, fsdp: bool = False) -> Any:
    """mu/nu/master mirror the param specs; scalars replicated."""
    pspecs = params_pspecs(params_shapes, mesh, fsdp=fsdp)
    return {"step": P(), "mu": pspecs, "nu": pspecs, "master": pspecs}


# ---------------------------------------------------------------------------
# Batch / cache / activation rules
# ---------------------------------------------------------------------------

def batch_pspecs(batch_shapes: Any, mesh) -> Any:
    dp = dp_axis_names(mesh)
    dp_n = axis_size(mesh, dp)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and _divisible(shape[0], dp_n):
            return P(dp, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _tree.tree_map(one, batch_shapes)


def cache_pspecs(cache_shapes: Any, mesh, *, scanned: bool = True) -> Any:
    """Generic chooser for decode caches of any rank.

    Greedy: batch dim → dp domain if divisible, else the longest dim → dp
    (sequence parallelism for batch=1 long-context); then ``model`` on the
    first remaining divisible dim (kv-heads, latent rank, d_inner, …),
    preferring later dims.  The leading period axis of a scanned stack is
    never sharded."""
    dp = dp_axis_names(mesh)
    dp_n = axis_size(mesh, dp)
    model_n = axis_size(mesh, "model")

    def one_path(kp, leaf):
        shape = list(leaf.shape)
        skip = 1 if (scanned and "layers/" in normalize_path(kp)) else 0
        spec: list = [None] * len(shape)
        body = list(range(skip, len(shape)))
        dp_dim = None
        if body and _divisible(shape[body[0]], dp_n):
            dp_dim = body[0]
        else:
            cands = [d for d in body[1:] if _divisible(shape[d], dp_n)]
            if cands:
                dp_dim = max(cands, key=lambda d: shape[d])
        if dp_dim is not None:
            spec[dp_dim] = dp
        for d in reversed(body):
            if d != dp_dim and _divisible(shape[d], model_n) \
                    and shape[d] >= model_n:
                spec[d] = "model"
                break
        return P(*spec)

    return _tree.unflatten_like(
        cache_shapes, [one_path(kp, leaf) for kp, leaf
                       in _tree.leaves_with_paths(cache_shapes)])


def activation_rules(mesh) -> Dict[str, P]:
    dp = dp_axis_names(mesh)
    return {"act_btd": P(dp, None, None), "head_dv": P(None, "model")}


def to_shardings(pspec_tree: Any, mesh):
    raise NotImplementedError(f"to_shardings: {A18B}")


# ---------------------------------------------------------------------------
# SparseTensor bitmap rules
# ---------------------------------------------------------------------------

def _spec_axes(entry) -> Tuple[str, ...]:
    """One PartitionSpec entry → the tuple of mesh axes it names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def bitmap_pspec(data_shape: Tuple[int, int], data_spec: P,
                 gran: Tuple[int, int], mesh) -> P:
    """PartitionSpec for a ``SparseTensor``'s fine bitmap, given the spec
    of its (2-D view) data: the bitmap shards along the same mesh axes as
    the data only when every shard holds a whole number of granularity
    cells (``dim % (axis_size · gran) == 0``); otherwise the bitmap dim
    replicates — conservative, never wrong."""
    spec = []
    for dim, entry, g in zip(data_shape, data_spec, gran):
        axes = _spec_axes(entry)
        n = axis_size(mesh, axes)
        spec.append(entry if axes and dim % (n * g) == 0 else None)
    return P(*spec)


def sparse_tensor_pspecs(st, data_spec: P, data_shape: Tuple[int, int],
                         mesh):
    """``(data_spec, bitmap_spec)`` for a ``SparseTensor`` whose 2-D data
    view has ``data_shape`` (the port's carrier holds no payload, so the
    shape is the caller's); the bitmap spec is None without a bitmap."""
    if getattr(st, "bitmap", None) is None:
        return data_spec, None
    return data_spec, bitmap_pspec(tuple(data_shape), data_spec, st.gran,
                                   mesh)
