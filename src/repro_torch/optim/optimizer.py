"""AdamW with f32 master weights, cosine schedule with warmup, global-norm
clipping and static loss scaling — the port of ``repro.optim.optimizer``.

Functional as in the reference: the state is a tree of tensors and
``adamw_update`` returns new trees.  The non-finite skip is decided on the
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
    """Returns (new_params, new_state, metrics).  A step whose gradient
    norm is not finite changes nothing (moments, master weights and the
    step counter keep their values); ``metrics["skipped"]`` says so."""
    g32 = _tree.tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.loss_scale > 0:
        g32 = _tree.tree_map(lambda g: g / cfg.loss_scale, g32)
    gnorm = global_norm(g32)
    finite = torch.isfinite(gnorm)
    if cfg.emit_guard_stats:
        stats.record_at_runtime("guard:nonfinite_skip", ~finite)
    clip = torch.where(gnorm > cfg.grad_clip,
                       cfg.grad_clip / (gnorm + 1e-9),
                       torch.ones_like(gnorm))
    g32 = _tree.tree_map(lambda g: g * clip, g32)

    step = state["step"] + 1
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)

    def upd(m, v, g, w):
        m32 = m.to(torch.float32)
        v32 = v.to(torch.float32)
        m1 = b1 * m32 + (1 - b1) * g
        v1 = b2 * v32 + (1 - b2) * g * g
        mhat = m1 / bc1
        vhat = v1 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * w
        w1 = w - lr * delta
        m1 = torch.where(finite, m1, m32).to(m.dtype)
        v1 = torch.where(finite, v1, v32).to(v.dtype)
        w1 = torch.where(finite, w1, w)
        return m1, v1, w1

    out = [upd(m, v, g, w) for m, v, g, w in zip(
        _tree.leaves(state["mu"]), _tree.leaves(state["nu"]),
        _tree.leaves(g32), _tree.leaves(state["master"]))]
    new_mu = _tree.unflatten_like(state["mu"], [o[0] for o in out])
    new_nu = _tree.unflatten_like(state["nu"], [o[1] for o in out])
    new_master = _tree.unflatten_like(state["master"], [o[2] for o in out])
    new_params = _tree.tree_map(lambda w, p: w.to(p.dtype), new_master,
                                params)
    new_state = {"step": torch.where(finite, step, state["step"]),
                 "mu": new_mu, "nu": new_nu, "master": new_master}
    metrics = {"grad_norm": gnorm, "lr": lr,
               "skipped": (~finite).to(torch.float32)}
    return new_params, new_state, metrics
