"""Feed-forward blocks: GLU (silu/gelu) and plain (relu/gelu/relu²) — the
port of ``repro.models.ffn``.

For ReLU-family activations under a sparse policy the down-projection runs
through ``core.act_matmul`` — the paper's fused unit — so the backward pass
gets OUTPUT sparsity (tiles the activation mask kills are skipped) and the
up-projection's backward gets INPUT sparsity from the now-sparse hidden
gradient.  GLU activations are dense by construction (paper §2.1 scopes
them out); they use plain products.

On DTensor weights (tensor parallelism) the sparse FFN runs on each
rank's blocks of the ff dim (``_sparse_ffn_tp``): the ReLU is
elementwise, so each rank's bitmap is its slice of the single-process
bitmap.

``set_relu_mask_hook`` is a test seam: a float64 check of a whole step
records each ReLU FFN's σ′ mask in an f32 step and replays it in the
float64 step (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import SparsityPolicy
from repro_torch.core.sparse_linear import act_matmul
from repro_torch.core.sparse_linear import matmul as sparse_matmul
from repro_torch.device import resolve_device
from repro_torch.kernels import stats
from repro_torch.sharding.context import by_axis
from repro_torch.sharding.partition import is_placed

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


def _sparse_ffn(x2, w_up, w_down, *, pol: SparsityPolicy,
                activation: str) -> torch.Tensor:
    """The sparse ReLU-family FFN on plain tensors: the up-projection a
    plain sparse matmul (its backward consumes the sparse hidden gradient
    → INPUT sparsity), then the fused unit."""
    with stats.layer_scope("ffn_up"):
        h_pre = sparse_matmul(x2, w_up, pol)
    # called once a step: a recomputed forward takes the first's result
    if _RELU_MASK_HOOK is not None and stats.replayed_call(
            lambda: _RELU_MASK_HOOK(h_pre.detach())) is not None:
        raise ValueError("a replaced ReLU mask needs the dense FFN "
                         "(sparse_policy None)")
    with stats.layer_scope("ffn_down"):
        return act_matmul(h_pre, w_down, pol, activation)


def _sparse_ffn_tp(fn, x2, w_up, w_down) -> torch.Tensor:
    """``fn`` (``_sparse_ffn``) on DTensors, run on each rank's blocks
    under ``local_map`` with the Megatron pair the partition rules give:
    x's rows over the data axes and replicated over ``model``, ``w_up``
    split on its ff columns and ``w_down`` on its ff rows over ``model``
    (both gathered over the data axes first, where FSDP splits them), so
    each rank's K1 encodes the bitmap of its own ff columns and K2/K3 skip
    on it.  The output is each model rank's part of the sum (``Partial``);
    so are x's gradient over ``model`` and the weights' over the data
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w_up.device_mesh
    rows = by_axis(mesh, Shard(0), Replicate())
    out = by_axis(mesh, Shard(0), Partial())      # also x's gradient
    up = by_axis(mesh, Replicate(), Shard(1))
    down = by_axis(mesh, Replicate(), Shard(0))
    return local_map(
        fn, out_placements=out, in_placements=(rows, up, down),
        in_grad_placements=(out, by_axis(mesh, Partial(), Shard(1)),
                            by_axis(mesh, Partial(), Shard(0))),
        device_mesh=mesh, redistribute_inputs=True)(x2, w_up, w_down)


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
        fn = functools.partial(_sparse_ffn, pol=cfg.sparse_policy,
                               activation=cfg.activation)
        if is_placed(params["w_up"]):
            y = _sparse_ffn_tp(fn, x2, params["w_up"], params["w_down"])
        else:
            y = fn(x2, params["w_up"], params["w_down"])
    else:
        h_pre = x2 @ params["w_up"]
        mask = None
        if cfg.relu_family and _RELU_MASK_HOOK is not None:
            # a recomputed forward takes the first forward's mask
            mask = stats.replayed_call(
                lambda: _RELU_MASK_HOOK(h_pre.detach()))
        if mask is None:
            h = activation_fn(cfg.activation)(h_pre)
        else:
            h = h_pre * mask.to(h_pre.dtype)
            h = h * h if cfg.activation == "relu2" else h
        y = h @ params["w_down"]
    return y.reshape(*shape[:-1], -1)
