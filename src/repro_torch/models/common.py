"""Shared building blocks: norms, rotary embeddings, initializers,
activations — the port of ``repro.models.common``.

A "module" is an ``init`` / ``apply`` pair over plain dicts of tensors, as
in the reference.  Initializers draw from a ``torch.Generator`` on its own
device; PyTorch cannot reproduce ``jax.random``'s bits, so cross-checks
carry the reference's weights across instead.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    std = scale / (d_in ** 0.5)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * std
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones(d, dtype=dtype)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32) -> Params:
    return {"scale": torch.ones(d, dtype=dtype),
            "bias": torch.zeros(d, dtype=dtype)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(dt)


def make_norm(kind: str):
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)           # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., T, 1, ·)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _relu2(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {
        "relu": torch.relu,
        "relu2": _relu2,
        "gelu": _gelu_tanh,
        "silu": F.silu,
    }[name]
