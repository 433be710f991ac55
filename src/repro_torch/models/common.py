"""Shared building blocks: norms, rotary embeddings, initializers,
activations — the port of ``repro.models.common``.

A "module" is an ``init`` / ``apply`` pair over plain dicts of tensors, as
in the reference.  Initializers draw from a ``torch.Generator`` on its own
device; PyTorch cannot reproduce ``jax.random``'s bits, so cross-checks
carry the reference's weights across instead.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# The dtype norms, RoPE, attention scores and the LM loss compute in:
# float32, as in the reference.  ``upcast(torch.float64)`` lifts them for a
# float64 check of a whole step.
_UPCAST = torch.float32


@contextlib.contextmanager
def upcast(dtype: torch.dtype):
    """Compute the upcast parts of the models in ``dtype`` inside the
    block (float32 outside it)."""
    global _UPCAST
    prev, _UPCAST = _UPCAST, dtype
    try:
        yield
    finally:
        _UPCAST = prev


def upcast_dtype() -> torch.dtype:
    return _UPCAST


class MetaGenerator(torch.Generator):
    """What the initializers draw from on the ``meta`` device, where
    PyTorch has no generator: a CPU generator that reports ``meta`` as its
    device, so ``torch.randn(..., generator=gen, device=gen.device)``
    allocates a meta leaf of the same shape and dtype and draws nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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
    x32 = x.to(_UPCAST)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(_UPCAST)).to(dt)


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
               device="cpu", dtype=torch.float32) -> torch.Tensor:
    if head_dim % 2:
        raise ValueError(f"head_dim must be even, got {head_dim}")
    exps = torch.arange(0, head_dim, 2, dtype=dtype,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device, dtype=_UPCAST)
    ang = positions[..., None].to(_UPCAST) * freqs           # (..., T, Dh/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., T, 1, ·)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(_UPCAST), 2, dim=-1)
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


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

def remat(fn, *args):
    """``fn(*args)`` as a checkpointed region: the reference's
    ``jax.checkpoint(fn, prevent_cse=False)`` as
    ``torch.utils.checkpoint`` (non-reentrant) gives it.  The forward keeps
    only the region's inputs; the backward pass recomputes the whole
    region once (no early stop, so the recomputed forward is the forward)
    under ``stats.remat_scopes``, with the sharding rules and the upcast
    dtype of the first forward restored (the recomputation may run on the
    autograd engine's thread, where the rules, kept per thread, are not
    installed).  Without gradients it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from repro_torch.kernels import stats
    from repro_torch.sharding.context import current_rules, sharding_rules
    rules, up = current_rules(), _UPCAST

    @contextlib.contextmanager
    def restore():
        with sharding_rules(rules), upcast(up):
            yield

    def region(*a):
        # checkpoints nested inside (attention's q chunks, Mamba's chunks)
        # keep their own early stop, as without remat
        with set_checkpoint_early_stop(True):
            return fn(*stats.recompute_inputs(a))

    scopes = stats.remat_scopes(restore)
    with set_checkpoint_early_stop(False):
        return checkpoint(region, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: scopes)
