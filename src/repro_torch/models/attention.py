"""Attention: GQA with RoPE, MLA (DeepSeek-V2) and cross-attention over
blockwise (flash-style) attention — the port of the training paths of
``repro.models.attention``.

Plain PyTorch, in the reference's chunk order: each q chunk runs an online
softmax over the kv chunks, so the (T × T) score matrix is never
materialized at once.  It is XLA code in the JAX package, not a Pallas
kernel.  Sliding windows wait for ROADMAP A16c and raise
``NotImplementedError``; the cached decode paths (``attn_decode``,
``_mla_decode``) wait for A17.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .common import apply_rope, dense_init, upcast_dtype

Params = Dict[str, Any]
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window size (None = full)
    # MLA
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # blockwise schedule
    q_chunk: int = 512
    kv_chunk: int = 512
    schedule: str = "rect"                # "rect" | "tri"
    unroll: int = 1                       # kv-chunk scan unrolling (JAX)


def _unported(cfg: AttnConfig) -> None:
    if cfg.window is not None:
        raise NotImplementedError("sliding-window attention: ROADMAP A16c")


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              dtype=torch.float32) -> Params:
    """wq, wk, wv, wo (MLA: wq, wdkv, wkr, wuk, wuv, wo) drawn from ``gen``
    on its device."""
    _unported(cfg)
    if cfg.use_mla:
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        h = cfg.n_heads
        return {
            "wq": dense_init(gen, cfg.d_model, h * qd, dtype),
            "wdkv": dense_init(gen, cfg.d_model, cfg.kv_lora_rank, dtype),
            "wkr": dense_init(gen, cfg.d_model, cfg.qk_rope_dim, dtype),
            "wuk": dense_init(gen, cfg.kv_lora_rank, h * cfg.qk_nope_dim,
                              dtype),
            "wuv": dense_init(gen, cfg.kv_lora_rank, h * cfg.v_head_dim,
                              dtype),
            "wo": dense_init(gen, h * cfg.v_head_dim, cfg.d_model, dtype),
        }
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }


def _chunk_attn_step(q, k, v, qpos, kpos, *, causal, window, scale):
    """One (q-chunk × kv-chunk) tile: (max, sum of exp, partial output).

    q: (B, Tq, Hk, G, D); k/v: (B, Tk, Hk, D)."""
    up = upcast_dtype()
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(up), k.to(up)) * scale
    # padded keys carry kpos = 2**30 and never attend
    mask = (kpos < 2 ** 29)[None, :].expand(q.shape[1], k.shape[1])
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                   # (B,H,G,Tq)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(up))
    return m, l, o


def blockwise_attention(
    q: torch.Tensor,               # (B, T, Hq, D)
    k: torch.Tensor,               # (B, S, Hk, D)
    v: torch.Tensor,               # (B, S, Hk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    schedule: str = "rect",
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention over q/kv chunks (the reference's order:
    for each q chunk, kv chunks in order, ``rect`` scanning all of them,
    ``tri`` only the causal prefix).  Returns (B, T, Hq, Dv) in v's
    dtype."""
    b, t, hq, d = q.shape
    _, s, hk, dv = v.shape
    g = hq // hk
    scale = d ** -0.5
    q = q.reshape(b, t, hk, g, d)
    q_chunk = min(q_chunk, t)
    kv_chunk = min(kv_chunk, s)
    nq = -(-t // q_chunk)
    nk = -(-s // kv_chunk)
    tp, sp = nq * q_chunk, nk * kv_chunk
    if tp != t:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, tp - t))
    if sp != s:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sp - s))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sp - s))
    dev = q.device
    qpos_all = q_offset + torch.arange(tp, device=dev)
    kpos_all = torch.arange(sp, device=dev)
    kpos_all = torch.where(kpos_all < s, kpos_all,
                           torch.full_like(kpos_all, 2 ** 30))

    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpos = qpos_all[i * q_chunk:(i + 1) * q_chunk]
        if schedule == "tri" and causal and q_offset == 0:
            n_kv = min(nk, -(-((i + 1) * q_chunk) // kv_chunk))
        else:
            n_kv = nk
        up = upcast_dtype()
        m_acc = torch.full((b, hk, g, q_chunk), NEG_INF, dtype=up,
                           device=dev)
        l_acc = torch.zeros((b, hk, g, q_chunk), dtype=up, device=dev)
        o_acc = torch.zeros((b, hk, g, q_chunk, dv), dtype=up, device=dev)
        for j in range(n_kv):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            m, l, o = _chunk_attn_step(qi, k[:, sl], v[:, sl], qpos,
                                       kpos_all[sl], causal=causal,
                                       window=window, scale=scale)
            m_new = torch.maximum(m_acc, m)
            c1 = torch.exp(m_acc - m_new)
            c2 = torch.exp(m - m_new)
            l_acc = l_acc * c1 + l * c2
            o_acc = o_acc * c1[..., None] + o * c2[..., None]
            m_acc = m_new
        outs.append(o_acc / torch.clamp(l_acc[..., None], min=1e-30))
    out = torch.cat(outs, dim=3)                          # (B,Hk,G,Tp,Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tp, hq, dv)
    return out[:, :t].to(v.dtype)


def attn_apply(params: Params, x: torch.Tensor, cfg: AttnConfig,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA (or MLA) self-attention with RoPE, causal (the training
    path)."""
    _unported(cfg)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if cfg.use_mla:
        return _mla_apply(params, x, cfg, positions)
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, window=cfg.window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            schedule=cfg.schedule)
    return o.reshape(b, t, -1) @ params["wo"]


def _mla_apply(params: Params, x: torch.Tensor, cfg: AttnConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """Multi-head latent attention: keys and values expanded from the
    ``kv_lora_rank`` latent, one RoPE key shared by every head; q/k head
    dim ``qk_nope + qk_rope`` against ``v_head_dim``."""
    b, t, _ = x.shape
    h = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = (x @ params["wq"]).reshape(b, t, h, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ params["wdkv"]                              # (B,T,r)
    k_rope = apply_rope((x @ params["wkr"])[:, :, None, :],
                        positions, cfg.rope_theta)         # (B,T,1,dr)
    k_nope = (c_kv @ params["wuk"]).reshape(b, t, h, cfg.qk_nope_dim)
    vv = (c_kv @ params["wuv"]).reshape(b, t, h, cfg.v_head_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, t, h, cfg.qk_rope_dim)],
                   dim=-1)
    o = blockwise_attention(qf, kf, vv, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            schedule=cfg.schedule)
    return o.reshape(b, t, -1) @ params["wo"]


def cross_attn_init(gen: torch.Generator, cfg: AttnConfig, d_memory: int,
                    dtype=torch.float32) -> Params:
    """wq from the decoder's width, wk/wv from the memory's, wo."""
    hd = cfg.head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d_memory, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d_memory, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }


def cross_attn_apply(params: Params, x: torch.Tensor, memory: torch.Tensor,
                     cfg: AttnConfig) -> torch.Tensor:
    """Decoder queries over the encoder's memory (B, S, d_memory): no
    RoPE, no causal mask; S need not equal T."""
    b, t, _ = x.shape
    s = memory.shape[1]
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (memory @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (memory @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    o = blockwise_attention(q, k, v, causal=False,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return o.reshape(b, t, -1) @ params["wo"]
