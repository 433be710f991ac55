"""DTensor's collectives for ranks that share one CUDA card.

NCCL refuses two ranks on one GPU, so ranks that share a card join a gloo
group, which moves CUDA tensors through host memory.  gloo runs every
collective DTensor issues when it is called through ``torch.distributed``
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``: ``chip_smoke.py``'s phase 13 probe), but DTensor
calls them as functional collectives (``torch.distributed.
_functional_collectives``), and there a gloo all-gather of CUDA tensors
never returns (torch 2.11.0+cu128, NVIDIA H100).  A ``DeviceMesh`` on the
host instead is no way round it: ``DTensor.from_local`` then moves every
local tensor to the CPU.

``install()`` points the functional collectives DTensor calls at
``torch.distributed``'s synchronous ones on the same groups: each
completes before it returns, moves what the functional one would, and
counts its payload in ``collectives.wire_bytes()``.  ``launch.mesh``
installs it in every process that joins gloo, on the CPU as on a card,
before any DTensor is made, so every gloo rank runs the same collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
_INSTALLED = {"done": False}


def _group(group, tag: str = ""):
    from torch.distributed import _functional_collectives as funcol
    return dist.distributed_c10d._resolve_process_group(
        funcol._resolve_group_name(group, tag))


def _count(t: torch.Tensor) -> None:
    from repro_torch.sharding import collectives
    collectives._WIRE["bytes"] += t.numel() * t.element_size()


def _op(reduceOp):
    """(gloo's reduce op, whether to divide by the group's size): gloo has
    no average."""
    op = str(reduceOp).lower()
    return _OPS["sum" if op == "avg" else op], op == "avg"


def all_reduce(self, reduceOp, group, tag=""):
    pg = _group(group, tag)
    out = self.clone(memory_format=torch.contiguous_format)
    _count(out)
    op, avg = _op(reduceOp)
    dist.all_reduce(out, op=op, group=pg)
    if avg:
        out /= dist.get_world_size(pg)
    return out


def all_gather(self, gather_dim, group, tag=""):
    pg = _group(group, tag)
    n = dist.get_world_size(pg)
    x = self.contiguous()
    _count(x)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
    pg = _group(group, tag)
    n = dist.get_world_size(pg)
    x = self
    if scatter_dim != 0:
        x = torch.cat(torch.chunk(x, n, dim=scatter_dim), dim=0)
    x = x.contiguous()
    _count(x)
    op, avg = _op(reduceOp)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=op, group=pg)
    if avg:
        out /= n
    return out


def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(a) → Shard(b) on one mesh dim: the gather over that
    dim, then this rank's chunk (gloo's own fallback for a host mesh)."""
    n = mesh.size(mesh_dim)
    whole = all_gather(input, gather_dim, (mesh, mesh_dim))
    return torch.chunk(whole, n, dim=shard_dim)[
        mesh.get_local_rank(mesh_dim)].contiguous()


def install() -> None:
    """Point DTensor's functional collectives at the synchronous ones
    (once a process)."""
    if _INSTALLED["done"]:
        return
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types
    for name, fn in (("all_reduce", all_reduce),
                     ("all_gather_tensor", all_gather),
                     ("all_gather_single", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("reduce_scatter_single", reduce_scatter)):
        if hasattr(funcol, name):
            setattr(funcol, name, fn)
    for mod in (_collective_utils, placement_types):
        if hasattr(mod, "shard_dim_alltoall"):
            mod.shard_dim_alltoall = shard_dim_alltoall
    _INSTALLED["done"] = True


def needed(backend) -> bool:
    """Whether a rank joined to ``backend`` needs ``install()``: gloo."""
    return backend == "gloo"
