"""AdamW with f32 master weights, cosine schedule with warmup, global-norm
clipping and static loss scaling — the port of ``repro.optim.optimizer``.

The state is a tree of tensors, as in the reference; ``adamw_update``
writes the new values into it and into the params in place.  The leaves
may be DTensors placed by ``sharding.partition`` (tensor parallelism,
FSDP): every op runs on them as on plain tensors, and the gradient norm
sums each leaf's partial sums over the mesh, so it is the single-process
step's norm.  The non-finite skip is decided on the
device; with ``emit_guard_stats`` it is counted under
``guard:nonfinite_skip`` through ``stats.record_at_runtime`` (a device
counter folded in when the counts are read — no host read here).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats
from repro_torch.sharding import partition

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    loss_scale: float = 0.0          # 0 → disabled
    emit_guard_stats: bool = False   # count non-finite skips under
                                     # guard:nonfinite_skip (the train loop
                                     # turns this on with a StepGuard)


def cosine_lr(step, cfg: OptConfig) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int or an integer tensor):
    linear warmup, then cosine decay to ``min_lr_frac``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.learning_rate * warm * frac


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in _tree.leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_init(params: Params, *, moment_dtype=torch.float32
               ) -> Dict[str, Any]:
    """Zero moments and f32 master weights, COPIED (never aliasing an f32
    param), and a step counter."""
    leaves = _tree.leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": _tree.tree_map(zeros, params),
        "nu": _tree.tree_map(zeros, params),
        "master": _tree.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


@torch.no_grad()
def adamw_update(grads: Params, state: Dict[str, Any], params: Params,
                 cfg: OptConfig
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, state, metrics), the reference's update written
    into ``state`` and ``params`` IN PLACE, leaf by leaf (the reference
    returns new trees): at 2.35 B params (gemma3-12b cut to one period) a
    second copy of the f32 state, which the functional form holds while
    the caller still holds the first, does not fit on an 80 GB card.  A
    step whose gradient norm is not finite changes nothing (moments,
    master weights and the step counter keep their values; the params are
    reset from the master weights); ``metrics["skipped"]`` says so."""
    def g32_of(g):
        g = g.to(torch.float32)
        return g / cfg.loss_scale if cfg.loss_scale > 0 else g

    gnorm = None
    for g in _tree.leaves(grads):
        sq = torch.sum(torch.square(g32_of(g)))
        gnorm = sq if gnorm is None else gnorm + sq
    gnorm = torch.sqrt(gnorm)
    finite = torch.isfinite(gnorm)
    if cfg.emit_guard_stats:
        stats.record_at_runtime("guard:nonfinite_skip",
                                partition.full(~finite))
    clip = torch.where(gnorm > cfg.grad_clip,
                       cfg.grad_clip / (gnorm + 1e-9),
                       torch.ones_like(gnorm))

    step = state["step"] + 1
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)

    for m, v, g, w, p in zip(
            _tree.leaves(state["mu"]), _tree.leaves(state["nu"]),
            _tree.leaves(grads), _tree.leaves(state["master"]),
            _tree.leaves(params)):
        g = g32_of(g) * clip
        m32 = m.to(torch.float32)
        v32 = v.to(torch.float32)
        m1 = b1 * m32 + (1 - b1) * g
        v1 = b2 * v32 + (1 - b2) * g * g
        delta = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps) \
            + cfg.weight_decay * w
        w1 = w - lr * delta
        del delta
        m.copy_(torch.where(finite, m1, m32))
        v.copy_(torch.where(finite, v1, v32))
        w.copy_(torch.where(finite, w1, w))
        p.copy_(w)
    state["step"].copy_(torch.where(finite, step, state["step"]))
    metrics = {"grad_norm": gnorm, "lr": lr,
               "skipped": (~finite).to(torch.float32)}
    return params, state, metrics
