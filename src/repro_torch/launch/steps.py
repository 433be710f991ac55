"""Step-function factories: train / prefill / decode — the port of
``repro.launch.steps``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats
from repro_torch.models.transformer import decode_step as _decode_step
from repro_torch.models.transformer import (decode_head, encode,
                                            lm_head_weight, lm_hidden,
                                            lm_loss)
from repro_torch.optim.optimizer import OptConfig, adamw_update
from repro_torch.sharding import partition
from repro_torch.sharding.context import with_sharding_constraint


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


def make_train_step(cfg, opt_cfg: OptConfig, *, microbatches: int = 1,
                    grad_pspecs=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradients are accumulated over ``microbatches`` in f32 and averaged, as
    the reference's ``lax.scan`` does; with ``opt_cfg.loss_scale`` the loss
    is scaled before the backward pass and the optimizer unscales.  The
    forward pass and the optimizer run in profiler ranges ``layer:forward``
    and ``layer:adamw`` (``profile_step --arch``).

    On params placed as DTensors (``sharding.partition.place``) the step
    runs on them unchanged.  ``grad_pspecs``, a tree of
    ``PartitionSpec``/``NamedSharding`` matching the params, pins each
    microbatch's gradient and the f32 accumulator to the param layout:
    the redistribution from the backward pass's partial sums is the
    gradient's all-reduce over the data axes (a reduce-scatter where FSDP
    splits the param).  The metrics come back as whole tensors."""
    leaves_of = _tree.leaves

    def _pin(g):
        if grad_pspecs is None:
            return g
        rules = partition.leaves_of_shardings(grad_pspecs)
        return _tree.unflatten_like(g, [
            with_sharding_constraint(x, r) for x, r in
            zip(leaves_of(g), rules)])

    def value_and_grad(params, mb):
        leaves = [p.detach().requires_grad_(True) for p in leaves_of(params)]
        with stats.layer_scope("forward"):
            loss = lm_loss(_tree.unflatten_like(params, leaves), mb, cfg)
        scaled = loss * opt_cfg.loss_scale if opt_cfg.loss_scale > 0 \
            else loss
        grads = torch.autograd.grad(scaled, leaves)
        return loss.detach(), _pin(_tree.unflatten_like(params,
                                                        list(grads)))

    def train_step(params, opt_state, batch):
        with partition.placed_scope(params):
            if microbatches == 1:
                loss, grads = value_and_grad(params, batch)
            else:
                mbs = _split_microbatches(batch, microbatches)
                gsum, lsum = None, None
                for j in range(microbatches):
                    loss_j, g = value_and_grad(
                        params, {k: v[j] for k, v in mbs.items()})
                    g32 = _tree.tree_map(lambda x: x.to(torch.float32), g)
                    gsum = g32 if gsum is None else _pin(_tree.tree_map(
                        torch.add, gsum, g32))
                    lsum = loss_j if lsum is None else lsum + loss_j
                grads = _tree.tree_map(lambda x: x / microbatches, gsum)
                loss = lsum / microbatches
            with stats.layer_scope("adamw"):
                params, opt_state, metrics = adamw_update(grads, opt_state,
                                                          params, opt_cfg)
            metrics["loss"] = loss
            metrics = {k: partition.full(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    """(params, batch) -> last-position f32 logits (B, V) of the trunk
    over ``batch["tokens"][:, :-1]`` (an enc-dec model encodes
    ``frontend_embeds`` into the memory first, a frontend model prepends
    them).  Runs without autograd; writing the caches out is the decode
    path's concern, as in the reference."""

    @torch.no_grad()
    def prefill_step(params, batch):
        memory = None
        fe = batch.get("frontend_embeds")
        if cfg.enc_dec:
            memory = encode(params, fe, cfg)
            fe = None
        h, _ = lm_hidden(params, batch["tokens"][:, :-1], cfg,
                         frontend_embeds=fe, memory=memory)
        up = torch.float32
        return h[:, -1].to(up) @ lm_head_weight(params, cfg).to(up)

    return prefill_step


def make_decode_step(cfg):
    """(params, token, caches, index[, memory]) -> (logits, caches), the
    caches updated in place; the f32 head is made on every call, as the
    reference's step upcasts it (the serving engine makes it once)."""

    @torch.inference_mode()
    def decode(params, token, caches, index, memory=None):
        return _decode_step(params, token, caches, index, cfg,
                            memory=memory, head=decode_head(params, cfg))

    return decode
