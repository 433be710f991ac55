"""Mamba-style selective SSM block (jamba's hybrid layers) — the port of
``repro.models.ssm``.

Training path: a chunked selective scan.  A loop over chunks carries the
(B, d_inner, d_state) f32 state; inside a chunk the discretized
(B, ch, d_inner, d_state) tensors are built, scanned and contracted over
``d_state`` before leaving it, so only (B, ch, d_inner) is kept per
chunk.  The chunk body always runs under ``torch.utils.checkpoint`` when
gradients are taken (the reference's ``jax.checkpoint``, whatever
``remat`` says): at jamba's width each (1, 256, 16,384, 16) f32 tensor is
268 MB, and without recomputation the backward would keep every chunk's.
Under ``cfg.remat`` these checkpoints nest inside the period's
(``models.common.remat``): the period's recomputation runs each chunk's
forward again keeping only its inputs, and each chunk is then recomputed
once for its own backward, as with ``remat=False``.

PyTorch has no stable associative scan: the chunk's scan follows
``jax.lax.associative_scan``'s recursion in eager ops (``_assoc_scan``),
so its products associate as the reference's; XLA's fusions may still
round differently, so it is held to a tolerance, not bit for bit.

Decode path: a single-step recurrence over (conv window, SSM state),
updated in place.  The window's dtype is the cache's: an f32 window (the
serving engine's default, as the reference's) runs the conv and the
``w_x`` product of bf16 params in f32, as the reference's promotion does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import rows_local

from .common import dense_init, upcast_dtype

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0         # 0 → ceil(d_model / 16)
    chunk: int = 256
    unroll: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def ssm_init(gen: torch.Generator, cfg: SSMConfig,
             dtype=torch.float32) -> Params:
    """The block's weights drawn from ``gen`` on its device; ``dt_bias``,
    ``a_log`` (A = -1..-d_state per channel) and ``d_skip`` in f32."""
    di, ds, r = cfg.d_inner, cfg.d_state, cfg.rank
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None].repeat(di, 1)
    conv_w = torch.randn((cfg.d_conv, di), generator=gen, device=dev) \
        * cfg.d_conv ** -0.5
    return {
        "w_in": dense_init(gen, cfg.d_model, 2 * di, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "w_x": dense_init(gen, di, r + 2 * ds, dtype),
        "w_dt": dense_init(gen, r, di, dtype),
        "dt_bias": torch.zeros(di, dtype=torch.float32, device=dev),
        "a_log": torch.log(a),
        "d_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, di, cfg.d_model, dtype),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prefix: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  u: (B,T,di); prefix: (B,d_conv-1,di)."""
    dc = w.shape[0]
    t = u.shape[1]
    up = torch.cat([prefix, u], dim=1)
    out = up[:, 0:t] * w[0]
    for i in range(1, dc):
        out = out + up[:, i:i + t] * w[i]
    return out + b


def _interleave(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x0, y0, x1, y1, ... along dim 1 (x as long as y or one longer)."""
    m = y.shape[1]
    out = torch.stack([x[:, :m], y], dim=2).flatten(1, 2)
    return out if x.shape[1] == m else torch.cat([out, x[:, m:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the affine maps h ↦ a·h + b, composed
    as (a1, b1) then (a2, b2) → (a1·a2, a2·b1 + b2): returns (a_1···a_t,
    the state at t from a zero start).  The recursion of
    ``jax.lax.associative_scan`` (pairs combined, the half-length scan
    recursed, the even positions filled in), so the products associate as
    the reference's do: 2·log2(ch) rounds on halving lengths."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a0, b0, a1, b1 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    oa, ob = _assoc_scan(a0 * a1, a1 * b0 + b1)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    pa, pb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    ea = torch.cat([a[:, :1], pa * a2], dim=1)
    eb = torch.cat([b[:, :1], a2 * pb + b2], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _chunk_body(h0, dt_c, b_c, c_c, u_c, a):
    """One chunk: (state at its end (B,di,ds), y (B,ch,di))."""
    up = dt_c.dtype
    a_bar = torch.exp(dt_c[..., None] * a)                     # (B,ch,di,ds)
    bx = dt_c[..., None] * b_c.to(up)[:, :, None, :] \
        * u_c.to(up)[..., None]
    a_cum, b_cum = _assoc_scan(a_bar, bx)
    h = a_cum * h0[:, None] + b_cum
    y = torch.einsum("bcds,bcs->bcd", h, c_c.to(up))
    return h[:, -1], y


def _selective_scan_chunked(dt, b_in, c_in, u, a, cfg: SSMConfig):
    """y_t = C_tᵀ h_t with h_t = exp(dt_t·a) ⊙ h_{t-1} + dt_t·B_t·u_t.
    dt: (B,T,di) upcast; b_in/c_in: (B,T,ds); u: (B,T,di); a: (di,ds)."""
    b, t, di = dt.shape
    ch = min(cfg.chunk, t)
    if t % ch:
        raise ValueError(f"sequence {t} is not a multiple of the SSM "
                         f"chunk {ch}")
    h = torch.zeros((b, di, a.shape[1]), dtype=dt.dtype, device=dt.device)
    ys = []
    for chunk in zip(*(x.split(ch, dim=1) for x in (dt, b_in, c_in, u))):
        if torch.is_grad_enabled():
            h, y = checkpoint(_chunk_body, h, *chunk, a, use_reentrant=False)
        else:
            h, y = _chunk_body(h, *chunk, a)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _dt(params: Params, dt_r: torch.Tensor) -> torch.Tensor:
    up = upcast_dtype()
    return F.softplus(dt_r.to(up) @ params["w_dt"].to(up)
                      + params["dt_bias"].to(up))


def ssm_apply(params: Params, x: torch.Tensor, cfg: SSMConfig
              ) -> torch.Tensor:
    """Training/prefill path.  x: (B, T, d_model)."""
    bsz = x.shape[0]
    di, ds = cfg.d_inner, cfg.d_state
    up = upcast_dtype()
    u, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    prefix = torch.zeros((bsz, cfg.d_conv - 1, di), dtype=u.dtype,
                         device=u.device)
    u = F.silu(_causal_conv(u, params["conv_w"], params["conv_b"], prefix))
    dt_r, b_in, c_in = torch.split(u @ params["w_x"], [cfg.rank, ds, ds],
                                   dim=-1)
    dt = _dt(params, dt_r)                                  # (B,T,di)
    a = -torch.exp(params["a_log"].to(up))                  # (di, ds)
    y = rows_local(functools.partial(_selective_scan_chunked, cfg=cfg),
                   (dt, b_in, c_in, u), (a,))
    y = y + params["d_skip"].to(up) * u.to(up)
    y = (y * F.silu(z.to(up))).to(x.dtype)
    return y @ params["w_out"]


def ssm_init_cache(cfg: SSMConfig, batch: int, dtype, device) -> Params:
    """The conv window (B, d_conv-1, d_inner) and the f32 state (B,
    d_inner, d_state), zeroed."""
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def ssm_decode(params: Params, x: torch.Tensor, cache: Params,
               cfg: SSMConfig) -> Tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d_model).  Updates ``cache`` in place."""
    ds = cfg.d_state
    up = upcast_dtype()
    u, z = torch.chunk(x @ params["w_in"], 2, dim=-1)       # (B,1,di)
    # an f32 window promotes the conv and the w_x product to f32, as in
    # the reference
    window = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    u1 = F.silu((window * params["conv_w"]).sum(dim=1, keepdim=True)
                + params["conv_b"])
    dt_r, b_in, c_in = torch.split(u1 @ params["w_x"].to(u1.dtype),
                                   [cfg.rank, ds, ds], dim=-1)
    dt = _dt(params, dt_r)                                  # (B,1,di)
    a = -torch.exp(params["a_log"].to(up))
    a_bar = torch.exp(dt[..., None] * a)[:, 0]              # (B,di,ds)
    bx = (dt[..., None] * b_in.to(up)[:, :, None, :]
          * u1.to(up)[..., None])[:, 0]
    h = a_bar * cache["h"].to(up) + bx
    y = torch.einsum("bds,bs->bd", h, c_in[:, 0].to(up))[:, None]
    y = y + params["d_skip"].to(up) * u1.to(up)
    y = (y * F.silu(z.to(up))).to(x.dtype)
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return y @ params["w_out"], cache
