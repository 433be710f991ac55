"""The training step factory — the port of ``repro.launch.steps``'s
``make_train_step``.  Prefill and decode wait for ROADMAP A17.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.optimizer import OptConfig, adamw_update


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int):
    """Every entry of ``batch`` (tokens, and a frontend model's
    ``frontend_embeds``) split along the batch axis into ``k``."""
    def r(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} does not split into {k} "
                             f"microbatches")
        return x.reshape(k, b // k, *x.shape[1:])
    return {name: r(x) for name, x in batch.items()}


def make_train_step(cfg, opt_cfg: OptConfig, *, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradients are accumulated over ``microbatches`` in f32 and averaged, as
    the reference's ``lax.scan`` does; with ``opt_cfg.loss_scale`` the loss
    is scaled before the backward pass and the optimizer unscales.  The
    forward pass and the optimizer run in profiler ranges ``layer:forward``
    and ``layer:adamw`` (``profile_step --arch``)."""
    leaves_of = _tree.leaves

    def value_and_grad(params, mb):
        leaves = [p.detach().requires_grad_(True) for p in leaves_of(params)]
        with stats.layer_scope("forward"):
            loss = lm_loss(_tree.unflatten_like(params, leaves), mb, cfg)
        scaled = loss * opt_cfg.loss_scale if opt_cfg.loss_scale > 0 \
            else loss
        grads = torch.autograd.grad(scaled, leaves)
        return loss.detach(), _tree.unflatten_like(params, list(grads))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            mbs = _split_microbatches(batch, microbatches)
            gsum, lsum = None, None
            for j in range(microbatches):
                loss_j, g = value_and_grad(
                    params, {k: v[j] for k, v in mbs.items()})
                g32 = _tree.tree_map(lambda x: x.to(torch.float32), g)
                gsum = g32 if gsum is None else _tree.tree_map(
                    torch.add, gsum, g32)
                lsum = loss_j if lsum is None else lsum + loss_j
            grads = _tree.tree_map(lambda x: x / microbatches, gsum)
            loss = lsum / microbatches
        with stats.layer_scope("adamw"):
            params, opt_state, metrics = adamw_update(grads, opt_state,
                                                      params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
