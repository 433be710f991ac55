"""Activation-sharding context — the port of ``repro.sharding.context``.

Model code annotates tensors by logical name (``constraint(x, "act_btd")``)
and stays mesh-agnostic; a launcher installs a rules table mapping logical
names to ``PartitionSpec``s (or ``partition.NamedSharding``s), and the mesh
they refer to under ``"__mesh__"``, the counterpart of JAX's ``with
mesh:``.  With no rule for a name, ``constraint`` is the identity.  Under a
rule a DTensor is redistributed to the rule's placements, as
``with_sharding_constraint`` reshards; a plain tensor passes only where
the rule places nothing on its mesh, and is refused where it would shard.

``reshape`` is the reshape of model code that may see a DTensor: where a
sharded dim is split into axes its shard cannot follow (15 heads of 64 on
a 2-way model axis), it first replicates the dims that change, as GSPMD
reshards at such a split.  ``rows_local`` runs a function that DTensor
cannot propagate through (a recurrence, a chunk scan) on each rank's rows:
the batch dim over the data axes, everything else replicated, as the
reference's rules leave a recurrence's inner dims.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from .partition import DP_AXES, NamedSharding, PartitionSpec, is_placed

_state = threading.local()


def current_rules() -> Optional[Dict[str, PartitionSpec]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, PartitionSpec]]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constraint(x, name: str):
    """``x`` laid out by the installed rule ``name`` (``x`` when no rule
    names it)."""
    rules = current_rules()
    if rules is None or name not in rules:
        return x
    return with_sharding_constraint(x, rules[name], name=name,
                                    mesh=rules.get("__mesh__"))


def with_sharding_constraint(x, rule, *, name: str = "", mesh=None):
    """``x`` laid out by ``rule`` (a ``PartitionSpec`` over ``mesh`` or the
    DTensor's own mesh, or a ``NamedSharding``)."""
    spec = rule.spec if isinstance(rule, NamedSharding) else rule
    if is_placed(x):
        from .partition import placements_of
        target = placements_of(spec, x.device_mesh.mesh_dim_names)
        if tuple(x.placements) == target:
            return x
        return x.redistribute(placements=target)
    if isinstance(rule, NamedSharding):
        mesh = rule.mesh
    if mesh is None:
        names = [e for e in spec if e is not None]
        if not names:
            return x
        raise TypeError(f"constraint({name!r}): rule {spec!r} names mesh "
                        f"axes, and no mesh is installed to size them")
    if NamedSharding(mesh, spec).places_nothing():
        return x
    raise TypeError(f"constraint({name!r}): rule {spec!r} shards this "
                    f"tensor on {mesh.shape}, and it is a plain tensor, not "
                    f"a DTensor placed on that mesh")


def settle(x):
    """``x`` with every pending reduction of a DTensor done (``Partial``
    placements made ``Replicate``); anything else is returned as is."""
    if not is_placed(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in x.placements])


def data_dims(device_mesh) -> list:
    """For each dim of a ``DeviceMesh``, whether it is a data axis
    (``partition.DP_AXES``)."""
    return [n in DP_AXES for n in device_mesh.mesh_dim_names]


def by_axis(device_mesh, data, other) -> list:
    """One placement per dim of ``device_mesh``: ``data`` on the data
    axes, ``other`` on the rest (``Shard(0)``/``Replicate()`` for rows,
    ``Partial()``/``Replicate()`` for a gradient summed over the rows)."""
    return [data if d else other for d in data_dims(device_mesh)]


def rows_local(fn, rows: tuple, shared: tuple = ()):
    """``fn(*rows, *shared)`` → one tensor of rows.  When any argument is a
    DTensor, ``fn`` runs under ``local_map`` on plain local blocks: each
    of ``rows`` (batch-major) and the result with dim 0 split over the
    mesh's data axes and replicated over the others, each of ``shared``
    replicated.  A shared argument's gradient from a rank's rows is that
    rank's part of a sum over the data axes (``Partial``)."""
    args = tuple(rows) + tuple(shared)
    placed = [a for a in args if is_placed(a)]
    if not placed:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = placed[0].device_mesh
    row_pl = by_axis(mesh, Shard(0), Replicate())
    rep = [Replicate()] * mesh.ndim
    rep_grad = by_axis(mesh, Partial(), Replicate())
    return local_map(fn, out_placements=row_pl,
                     in_placements=tuple([row_pl] * len(rows)
                                         + [rep] * len(shared)),
                     in_grad_placements=tuple([row_pl] * len(rows)
                                              + [rep_grad] * len(shared)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor whose shard cannot follow the new
    shape has the placements on the dims after the unchanged leading ones
    replicated first, in the forward pass and in the backward pass."""
    if not is_placed(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, shape)


def _reshard_reshape(x, shape):
    try:
        return x.reshape(shape)
    except RuntimeError:
        pass
    from torch.distributed.tensor import Replicate, Shard
    keep = 0
    for a, b in zip(x.shape, shape):
        if a != b:
            break
        keep += 1
    target = [Replicate() if isinstance(p, Shard) and p.dim >= keep else p
              for p in x.placements]
    return x.redistribute(placements=target).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshard_reshape(x, tuple(shape))

    @staticmethod
    def backward(ctx, g):
        return _reshard_reshape(g, ctx.in_shape), None
