"""Feed-forward blocks: GLU (silu/gelu) and plain (relu/gelu/relu²) — the
port of ``repro.models.ffn``.

For ReLU-family activations under a sparse policy the down-projection runs
through ``core.act_matmul`` — the paper's fused unit — so the backward pass
gets OUTPUT sparsity (tiles the activation mask kills are skipped) and the
up-projection's backward gets INPUT sparsity from the now-sparse hidden
gradient.  GLU activations are dense by construction (paper §2.1 scopes
them out); they use plain products.

``set_relu_mask_hook`` is a test seam: a float64 check of a whole step
records each ReLU FFN's σ′ mask in an f32 step and replays it in the
float64 step (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import SparsityPolicy
from repro_torch.core.sparse_linear import act_matmul
from repro_torch.core.sparse_linear import matmul as sparse_matmul
from repro_torch.device import resolve_device
from repro_torch.kernels import stats

from .common import activation_fn, dense_init

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    activation: str = "silu_glu"      # silu_glu|gelu_glu|relu|gelu|relu2
    sparse_policy: Optional[SparsityPolicy] = None  # only for relu/relu2

    @property
    def is_glu(self) -> bool:
        return self.activation.endswith("_glu")

    @property
    def relu_family(self) -> bool:
        return self.activation in ("relu", "relu2")


# Called as ``hook(h_pre)`` on each ReLU-family FFN's hidden
# pre-activation; a returned boolean mask m replaces σ′: the hidden
# activation becomes h_pre·m (relu) or (h_pre·m)² (relu2).  Returning None
# changes nothing.
_RELU_MASK_HOOK = None


def set_relu_mask_hook(fn):
    """Install (or, with None, remove) the ReLU mask hook; returns the
    previous one."""
    global _RELU_MASK_HOOK
    prev, _RELU_MASK_HOOK = _RELU_MASK_HOOK, fn
    return prev


def ffn_params(gen: torch.Generator, cfg: FFNConfig,
               dtype=torch.float32) -> Params:
    """w_gate (GLU only), w_up, w_down drawn from ``gen`` on its device."""
    names = ("w_gate", "w_up", "w_down") if cfg.is_glu else ("w_up", "w_down")
    params = {}
    for name in names:
        d_in, d_out = (cfg.d_ff, cfg.d_model) if name == "w_down" \
            else (cfg.d_model, cfg.d_ff)
        params[name] = dense_init(gen, d_in, d_out, dtype)
    return params


def ffn_init(seed: int, cfg: FFNConfig, *, device="cuda",
             dtype=torch.float32) -> Params:
    """Weights drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed``, then moved to ``device`` (default CUDA; raises without one
    unless ``device="cpu"``).  Leaves require grad."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {name: w.to(dev).requires_grad_(True)
            for name, w in ffn_params(gen, cfg, dtype).items()}


def ffn_apply(params: Params, x: torch.Tensor, cfg: FFNConfig
              ) -> torch.Tensor:
    """x: (..., d_model)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if cfg.is_glu:
        act = activation_fn(cfg.activation.split("_")[0])
        h = act(x2 @ params["w_gate"]) * (x2 @ params["w_up"])
        y = h @ params["w_down"]
    elif cfg.relu_family and cfg.sparse_policy is not None \
            and cfg.sparse_policy.any_sparsity:
        pol = cfg.sparse_policy
        # up-projection: plain sparse matmul (its backward consumes the
        # sparse hidden gradient → INPUT sparsity), then the fused unit.
        with stats.layer_scope("ffn_up"):
            h_pre = sparse_matmul(x2, params["w_up"], pol)
        if _RELU_MASK_HOOK is not None and \
                _RELU_MASK_HOOK(h_pre.detach()) is not None:
            raise ValueError("a replaced ReLU mask needs the dense FFN "
                             "(sparse_policy None)")
        with stats.layer_scope("ffn_down"):
            y = act_matmul(h_pre, params["w_down"], pol, cfg.activation)
    else:
        h_pre = x2 @ params["w_up"]
        mask = None
        if cfg.relu_family and _RELU_MASK_HOOK is not None:
            mask = _RELU_MASK_HOOK(h_pre.detach())
        if mask is None:
            h = activation_fn(cfg.activation)(h_pre)
        else:
            h = h_pre * mask.to(h_pre.dtype)
            h = h * h if cfg.activation == "relu2" else h
        y = h @ params["w_down"]
    return y.reshape(*shape[:-1], -1)
