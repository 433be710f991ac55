"""Attention: GQA with RoPE and sliding windows, MLA (DeepSeek-V2) and
cross-attention — the port of ``repro.models.attention``, training and
cached-decode paths.

Training attention is plain PyTorch in the reference's chunk order: each q
chunk runs an online softmax over the kv chunks, so the (T × T) score
matrix is never materialized at once.  A window masks keys more than
``window - 1`` positions back; ``rect`` still scans every kv chunk, as the
reference does.  It is XLA code in the JAX package, not a Pallas kernel.

Decode updates its cache IN PLACE (the reference's is functional): one
token's keys and values are written at their slot, with no copy of the
cache per tick.  A windowed layer's cache is a ring buffer of
``min(max_len, window)`` slots.  MLA caches the ``kv_lora_rank`` latent
and the shared RoPE key, and decodes in the absorbed-projection form (q
projected into the latent space), so a tick costs O(S·(r + d_rope)) per
head.  Scores and values are f32 products of the cache's values, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import data_dims, reshape, rows_local
from repro_torch.sharding.partition import is_placed

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


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              dtype=torch.float32) -> Params:
    """wq, wk, wv, wo (MLA: wq, wdkv, wkr, wuk, wuv, wo) drawn from ``gen``
    on its device."""
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


def _chunk_attn_step(q, k, v, qpos, kpos, *, causal, window, scale, up):
    """One (q-chunk × kv-chunk) tile: (max, sum of exp, partial output),
    computed in ``up``.

    q: (B, Tq, Hk, G, D); k/v: (B, Tk, Hk, D)."""
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


def _one_q_chunk(qi, k, v, qpos, kpos_all, n_kv, kv_chunk, causal, window,
                 scale, up):
    """Online softmax of one q chunk over the first ``n_kv`` kv chunks:
    (B, Hk, G, Tq, Dv) in ``up`` (passed in, not read from
    ``upcast_dtype()``, so that a recomputation in the backward pass runs
    in the forward's dtype)."""
    b, tq, hk, g, _ = qi.shape
    dv = v.shape[-1]
    dev = qi.device
    m_acc = torch.full((b, hk, g, tq), NEG_INF, dtype=up, device=dev)
    l_acc = torch.zeros((b, hk, g, tq), dtype=up, device=dev)
    o_acc = torch.zeros((b, hk, g, tq, dv), dtype=up, device=dev)
    for j in range(n_kv):
        sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
        m, l, o = _chunk_attn_step(qi, k[:, sl], v[:, sl], qpos,
                                   kpos_all[sl], causal=causal,
                                   window=window, scale=scale, up=up)
        m_new = torch.maximum(m_acc, m)
        c1 = torch.exp(m_acc - m_new)
        c2 = torch.exp(m - m_new)
        l_acc = l_acc * c1 + l * c2
        o_acc = o_acc * c1[..., None] + o * c2[..., None]
        m_acc = m_new
    return o_acc / torch.clamp(l_acc[..., None], min=1e-30)


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
    ``tri`` only the causal prefix).  Each q chunk is recomputed in the
    backward pass (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``): otherwise every (q, kv) tile's scores stay alive,
    ~5 GB a layer for gemma3-12b at 4,096 positions.  Returns (B, T, Hq,
    Dv) in v's dtype.

    On DTensors it runs under ``local_map`` on each rank's rows (the
    batch over the data axes), as DTensor has no strategy for the score
    products (torch 2.11).  Where q, k and v arrive with their heads split
    on a model axis that divides both head counts, each rank keeps its own
    heads (GQA's groups stay whole: query head ``i`` reads kv head ``i //
    g`` on the same rank); otherwise every head runs on every rank of
    that axis (SmolLM's 15/5 heads on 2 ranks: ROADMAP Queue C)."""
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk, schedule=schedule, q_offset=q_offset)
    if is_placed(q):
        return _blockwise_local(q, k, v, kw)
    return _blockwise(q, k, v, **kw)


def _head_split(q, k, v) -> Optional[list]:
    """The placements that keep q, k and v's heads (dim 2) split where
    they are split alike on a non-data axis dividing both head counts
    (rows over the data axes), or None where no axis splits them so."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    out, split = [], False
    for i, data in enumerate(data_dims(mesh)):
        pls = [getattr(a, "placements", (Replicate(),) * mesh.ndim)[i]
               for a in (q, k, v)]
        n = mesh.size(i)
        if data:
            out.append(Shard(0))
        elif all(p == Shard(2) for p in pls) and \
                q.shape[2] % n == 0 and k.shape[2] % n == 0:
            out.append(Shard(2))
            split = True
        else:
            out.append(Replicate())
    return out if split else None


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a DTensor built on
    a strided local gradient claims a contiguous layout, and the views of
    the projections' backward then fail on it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _blockwise_split_heads(q, k, v, **kw):
    return _blockwise(*(_DenseGrad.apply(a) for a in (q, k, v)), **kw)


def _blockwise_local(q, k, v, kw):
    heads = _head_split(q, k, v)
    if heads is None:
        return rows_local(functools.partial(_blockwise, **kw), (q, k, v))
    from torch.distributed.tensor.experimental import local_map
    return local_map(functools.partial(_blockwise_split_heads, **kw),
                     out_placements=heads, in_placements=(heads,) * 3,
                     in_grad_placements=(heads,) * 3,
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _blockwise(q, k, v, *, causal, window, q_chunk, kv_chunk, schedule,
               q_offset):
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
        args = (qi, k, v, qpos, kpos_all, n_kv, kv_chunk, causal, window,
                scale, upcast_dtype())
        if torch.is_grad_enabled():
            outs.append(checkpoint(_one_q_chunk, *args, use_reentrant=False))
        else:
            outs.append(_one_q_chunk(*args))
    out = torch.cat(outs, dim=3)                          # (B,Hk,G,Tp,Dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tp, hq, dv)
    return out[:, :t].to(v.dtype)


def attn_apply(params: Params, x: torch.Tensor, cfg: AttnConfig,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA (or MLA) self-attention with RoPE, causal (the training
    path)."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if cfg.use_mla:
        return _mla_apply(params, x, cfg, positions)
    q = reshape(x @ params["wq"], b, t, cfg.n_heads, cfg.head_dim)
    k = reshape(x @ params["wk"], b, t, cfg.n_kv_heads, cfg.head_dim)
    v = reshape(x @ params["wv"], b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True, window=cfg.window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            schedule=cfg.schedule)
    return reshape(o, b, t, -1) @ params["wo"]


def _mla_apply(params: Params, x: torch.Tensor, cfg: AttnConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """Multi-head latent attention: keys and values expanded from the
    ``kv_lora_rank`` latent, one RoPE key shared by every head; q/k head
    dim ``qk_nope + qk_rope`` against ``v_head_dim``."""
    b, t, _ = x.shape
    h = cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = reshape(x @ params["wq"], b, t, h, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ params["wdkv"]                              # (B,T,r)
    k_rope = apply_rope((x @ params["wkr"])[:, :, None, :],
                        positions, cfg.rope_theta)         # (B,T,1,dr)
    k_nope = reshape(c_kv @ params["wuk"], b, t, h, cfg.qk_nope_dim)
    vv = reshape(c_kv @ params["wuv"], b, t, h, cfg.v_head_dim)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, t, h, cfg.qk_rope_dim)],
                   dim=-1)
    o = blockwise_attention(qf, kf, vv, causal=True,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                            schedule=cfg.schedule)
    return reshape(o, b, t, -1) @ params["wo"]


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
    q = reshape(x @ params["wq"], b, t, cfg.n_heads, cfg.head_dim)
    k = reshape(memory @ params["wk"], b, s, cfg.n_kv_heads, cfg.head_dim)
    v = reshape(memory @ params["wv"], b, s, cfg.n_kv_heads, cfg.head_dim)
    o = blockwise_attention(q, k, v, causal=False,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return reshape(o, b, t, -1) @ params["wo"]


def init_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
               device) -> Params:
    """Zeroed decode cache: MLA's latent ``c_kv`` and ``k_rope``
    (B, max_len, ·); else ``k``/``v`` (B, S, Hk, D) with S = ``max_len``,
    or ``min(max_len, window)`` for a windowed layer's ring buffer."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if cfg.use_mla:
        return {"c_kv": z(batch, max_len, cfg.kv_lora_rank),
                "k_rope": z(batch, max_len, cfg.qk_rope_dim)}
    length = min(max_len, cfg.window) if cfg.window else max_len
    return {"k": z(batch, length, cfg.n_kv_heads, cfg.head_dim),
            "v": z(batch, length, cfg.n_kv_heads, cfg.head_dim)}


def ring_positions(index: int, s_len: int, window: Optional[int],
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, valid) at decode position ``index``: the slot the token is
    written to, and which of the ``s_len`` cache slots it may attend to.
    A windowed cache is a ring buffer: slot ``j`` holds the newest
    position ≡ j (mod s_len) that is ≤ index, and a key more than
    ``window - 1`` positions back is masked."""
    kpos = torch.arange(s_len, device=device)
    if not window:
        return index, kpos <= index
    wrap = (index // s_len) * s_len
    kpos = torch.where(kpos <= index % s_len, wrap + kpos,
                       wrap - s_len + kpos)
    valid = (kpos <= index) & (kpos >= 0) & (index - kpos < window)
    return index % s_len, valid


def attn_decode(params: Params, x: torch.Tensor, cache: Params, index: int,
                cfg: AttnConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode at position ``index`` (a Python int shared by the
    batch).  x: (B, 1, d).  Writes the token's key and value into
    ``cache`` in place and returns (output (B, 1, d), cache)."""
    if cfg.use_mla:
        return _mla_decode(params, x, cache, index, cfg)
    b = x.shape[0]
    pos = torch.full((1,), index, device=x.device)
    q = (x @ params["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot, valid = ring_positions(index, ck.shape[1], cfg.window, x.device)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    up = upcast_dtype()
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, 1, cfg.n_kv_heads, g, cfg.head_dim)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(up),
                     ck.to(up)) * cfg.head_dim ** -0.5
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.to(up))
    o = o.reshape(b, 1, -1).to(x.dtype)
    return o @ params["wo"], cache


def _mla_decode(params: Params, x: torch.Tensor, cache: Params, index: int,
                cfg: AttnConfig) -> Tuple[torch.Tensor, Params]:
    """Absorbed-projection MLA decode: W_uk folded into the query and W_uv
    applied after the softmax, so scores and values stay in the latent
    space of the cache."""
    b = x.shape[0]
    h = cfg.n_heads
    pos = torch.full((1,), index, device=x.device)
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = (x @ params["wq"]).reshape(b, 1, h, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    c_new = x @ params["wdkv"]                             # (B,1,r)
    kr_new = apply_rope((x @ params["wkr"])[:, :, None, :], pos,
                        cfg.rope_theta)[:, :, 0, :]        # (B,1,dr)
    ckv, ckr = cache["c_kv"], cache["k_rope"]
    ckv[:, index] = c_new[:, 0].to(ckv.dtype)
    ckr[:, index] = kr_new[:, 0].to(ckr.dtype)
    up = upcast_dtype()
    wuk = params["wuk"].reshape(cfg.kv_lora_rank, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(up), wuk.to(up))
    valid = torch.arange(ckv.shape[1], device=x.device) <= index
    ckv_up = ckv.to(up)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_up)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(up), ckr.to(up))
              ) * (qd ** -0.5)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", p, ckv_up)
    wuv = params["wuv"].reshape(cfg.kv_lora_rank, h, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, wuv.to(up))
    o = o.reshape(b, 1, -1).to(x.dtype)
    return o @ params["wo"], cache
