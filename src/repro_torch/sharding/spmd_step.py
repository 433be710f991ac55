"""The explicit data-parallel training step — the port of
``repro.sharding.spmd_step``.

The reference runs the step under ``shard_map``: params and optimizer state
replicated, the batch split on its leading dim over the data-parallel axes,
the body traced once for all shards.  Here every rank is a process that
runs the same eager step on its own rows:

  * each function takes the GLOBAL batch and keeps this rank's rows, as
    ``P(axes)`` splits it: rank r of n (r its row-major index over the data
    axes) takes rows r·B/n … (r+1)·B/n.  Each rank's forward runs the same
    fused encode on its rows, so its bitmaps are row slices of the global
    forward's bitmaps, and every GEMM resolves its own spec at the rank's
    shapes;
  * the gradient all-reduce goes through ``collectives.psum_grads``: WG
    bitmaps registered by the backward pass compress the wire traffic,
    everything else takes the dense reduce;
  * the loss and gradients come back as the GLOBAL means, the same on every
    rank.

Each rank counts its own trace-time events (``encode:act``, ``gemm:*``,
``collective:bitmap_psum`` …), which equal the reference's single trace;
the runtime collective keys, summed over ranks, equal the reference's
(ROADMAP Queue C).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats
from repro_torch.sharding import collectives, partition

# Compressed-collective capacity as a fraction of the block count; above
# this union live fraction the all-reduce falls back to the dense reduce.
DEFAULT_CUTOFF = 0.5


def data_axes(mesh) -> Tuple[str, ...]:
    axes = partition.dp_axis_names(mesh)
    if not axes:
        raise ValueError(
            f"mesh {mesh.axis_names} has no data-parallel axis "
            "('data'/'pod') to shard the batch over")
    return axes


def local_rows(batch: Any, mesh, axes) -> Any:
    """This rank's rows of every leaf of the global ``batch``."""
    n = partition.axis_size(mesh, axes)
    r = mesh.axis_index(axes)

    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"over {n} ranks")
        k = x.shape[0] // n
        return x[r * k:(r + 1) * k]

    return _tree.tree_map(one, batch)


def _value_and_grad(loss_fn, params, *, scale: float = 0.0):
    """(loss, grads tree) of ``loss_fn(params)``; the gradients are the very
    tensors ``torch.autograd.grad`` returned, so the registry's identity
    lookups find their bitmaps."""
    leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    with stats.layer_scope("forward"):
        loss = loss_fn(_tree.unflatten_like(params, leaves))
    grads = torch.autograd.grad(loss * scale if scale > 0 else loss, leaves)
    return loss.detach(), _tree.unflatten_like(params, list(grads))


def _global_mean(loss, grads, mesh, axes, cutoff, block):
    inv = 1.0 / partition.axis_size(mesh, axes)
    grads = collectives.psum_grads(grads, mesh=mesh, axis_name=axes,
                                   cutoff=cutoff, block=block)
    loss = collectives.psum_scalar(loss, axes, mesh=mesh)
    return loss * inv, _tree.tree_map(lambda g: g * inv, grads)


def make_spmd_grad_fn(loss_fn: Callable[[Any, Any], Any], mesh, *,
                      cutoff: float = DEFAULT_CUTOFF,
                      block: Optional[Tuple[int, int]] = None):
    """``f(params, batch) -> (loss, grads)`` for ``loss_fn(params, batch) ->
    scalar mean loss``: ``batch`` is the global batch, the outputs the
    global mean loss and mean gradients — numerically the single-process
    gradient of the same loss over the whole batch, to the all-reduce's
    summation order."""
    axes = data_axes(mesh)

    def grad_fn(params, batch):
        local = local_rows(batch, mesh, axes)
        loss, grads = _value_and_grad(lambda p: loss_fn(p, local), params)
        return _global_mean(loss, grads, mesh, axes, cutoff, block)

    return grad_fn


def make_spmd_train_step(cfg, opt_cfg, mesh, *,
                         cutoff: float = DEFAULT_CUTOFF,
                         block: Optional[Tuple[int, int]] = None):
    """The LM step of ``launch.steps.make_train_step`` made data-parallel:
    ``(params, opt_state, batch) -> (params, opt_state, metrics)`` with the
    params and state replicated (updated in place by ``adamw_update``), the
    global batch split over the data axes and the gradient all-reduce
    bitmap-compressed.  Microbatching is the single-process step's
    feature: here the mesh is the batch split."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.optim.optimizer import adamw_update
    axes = data_axes(mesh)

    def train_step(params, opt_state, batch):
        local = local_rows(batch, mesh, axes)
        loss, grads = _value_and_grad(lambda p: lm_loss(p, local, cfg),
                                      params, scale=opt_cfg.loss_scale)
        loss, grads = _global_mean(loss, grads, mesh, axes, cutoff, block)
        with stats.layer_scope("adamw"):
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
