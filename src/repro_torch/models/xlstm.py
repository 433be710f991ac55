"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory), used by the xlstm-350m architecture in an alternating stack — the
port of ``repro.models.xlstm``.

mLSTM: per-head matrix state C ∈ R^{Dh×Dh} with exponential input/forget
gating and max-stabilizer m; a loop over chunks carries (C, n, m) and each
chunk uses the decay-weighted intra-chunk attention-like form.

sLSTM: per-unit scalar state with recurrent (block-diagonal per head)
hidden feedback — inherently sequential.  The reference scans over time
with ``lax.scan``; the port loops over T in Python, one small step of
eager ops per position (host-bound on the card; ROADMAP B15).

The reference's simplifications are kept: default-valued skip/gate
initializations, no causal conv on the mLSTM query/key path, and per-head
RMS normalization of the readout in place of group norm.  Compute that the
reference does in f32 runs at ``common.upcast_dtype()``.  Decode updates
its state in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import reshape, rows_local

from .common import dense_init, upcast_dtype

Params = Dict[str, Any]
NEG_INIT = -1e30           # the stabilizer m before any input


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor_m: float = 2.0      # mLSTM up-projection
    proj_factor_s: float = 4.0 / 3  # sLSTM FFN factor
    chunk: int = 64
    unroll: int = 1

    @property
    def d_inner_m(self) -> int:
        return int(self.d_model * self.proj_factor_m)

    @property
    def head_dim_m(self) -> int:
        return self.d_inner_m // self.n_heads

    @property
    def head_dim_s(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.float32) -> Params:
    """Projections in ``dtype``; the gate projections and biases in f32
    (the forget bias at 3, open)."""
    di, h = cfg.d_inner_m, cfg.n_heads
    dev = gen.device
    return {
        "w_up": dense_init(gen, cfg.d_model, 2 * di, dtype),
        "w_q": dense_init(gen, di, di, dtype),
        "w_k": dense_init(gen, di, di, dtype),
        "w_v": dense_init(gen, di, di, dtype),
        "w_i": dense_init(gen, di, h, torch.float32),
        "w_f": dense_init(gen, di, h, torch.float32),
        "b_i": torch.zeros(h, dtype=torch.float32, device=dev),
        "b_f": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, di, cfg.d_model, dtype),
    }


def _mlstm_chunk(carry, q, k, v, ig, fg):
    """Chunkwise-parallel mLSTM (decay-matrix form) for one chunk.

    carry: (C (B,H,D,D), n (B,H,D), m (B,H)); q, k, v: (B,ch,H,D);
    ig, fg: (B,ch,H).  Returns (carry at the chunk's end, h (B,ch,H,D))."""
    C0, n0, m0 = carry
    ch, d = q.shape[1], q.shape[3]
    up = C0.dtype
    logf = F.logsigmoid(fg)                              # (B,ch,H)
    cum_f = torch.cumsum(logf, dim=1)                    # Σ_{s<=t} log f_s
    a_val = ig + (cum_f[:, -1:, :] - cum_f)              # key decay to end
    m_inter = m0 + cum_f[:, -1, :]                       # carry decay to end
    m_new = torch.maximum(m_inter, a_val.amax(dim=1))    # (B,H)

    # D[t,s] = exp(cumf_t - cumf_s + i_s - m_t*), causal, with the
    # per-step stabilizer m_t* = max(m0 + cumf_t, max_{s<=t} ...)
    dec_ts = cum_f[:, :, None, :] - cum_f[:, None, :, :] + ig[:, None, :, :]
    causal = torch.ones((ch, ch), dtype=torch.bool, device=q.device).tril()
    dec_ts = torch.where(causal[None, :, :, None], dec_ts,
                         torch.full_like(dec_ts, float("-inf")))
    m_step = torch.maximum(m0[:, None] + cum_f, dec_ts.amax(dim=2))
    d_mat = torch.exp(dec_ts - m_step[:, :, None, :])    # (B,ch,ch,H)
    carry_dec = torch.exp(m0[:, None] + cum_f - m_step)  # (B,ch,H)

    qf = q.to(up) * d ** -0.5
    kf, vf = k.to(up), v.to(up)
    s_intra = torch.einsum("bthd,bshd->btsh", qf, kf) * d_mat
    num = torch.einsum("btsh,bshd->bthd", s_intra, vf) \
        + torch.einsum("bthd,bhde->bthe", qf, C0) * carry_dec[..., None]
    den = torch.abs(s_intra.sum(dim=2)
                    + torch.einsum("bthd,bhd->bth", qf, n0) * carry_dec)
    hy = num / torch.maximum(den, torch.exp(-m_step))[..., None]

    k_dec = torch.exp(a_val - m_new[:, None])            # (B,ch,H)
    keep = torch.exp(m_inter - m_new)
    C1 = C0 * keep[..., None, None] \
        + torch.einsum("bshd,bshe->bhde", kf * k_dec[..., None], vf)
    n1 = n0 * keep[..., None] + torch.einsum("bshd,bsh->bhd", kf, k_dec)
    return (C1, n1, m_new), hy


def _mlstm_gates(params: Params, up_x: torch.Tensor):
    up = upcast_dtype()
    u = up_x.to(up)
    ig = u @ params["w_i"].to(up) + params["b_i"].to(up)
    fg = u @ params["w_f"].to(up) + params["b_f"].to(up)
    return ig, fg


def _readout(hy: torch.Tensor, gate: torch.Tensor, dtype) -> torch.Tensor:
    """RMS-normalized readout (over all heads, as the reference) times the
    SiLU output gate."""
    hy = hy / torch.clamp(torch.sqrt(torch.mean(hy * hy, dim=-1,
                                                keepdim=True)), min=1e-6)
    return (hy * F.silu(gate.to(hy.dtype))).to(dtype)


def mlstm_apply(params: Params, x: torch.Tensor, cfg: XLSTMConfig
                ) -> torch.Tensor:
    """Training path.  x: (B, T, d_model), T a multiple of the chunk."""
    b, t, _ = x.shape
    h, d = cfg.n_heads, cfg.head_dim_m
    up_x, gate = torch.chunk(x @ params["w_up"], 2, dim=-1)
    q = reshape(up_x @ params["w_q"], b, t, h, d)
    k = reshape(up_x @ params["w_k"], b, t, h, d)
    v = reshape(up_x @ params["w_v"], b, t, h, d)
    ig, fg = _mlstm_gates(params, up_x)
    hy = rows_local(functools.partial(_mlstm_scan, cfg=cfg),
                    (q, k, v, ig, fg))
    return _readout(hy, gate, x.dtype) @ params["w_down"]


def _mlstm_scan(q, k, v, ig, fg, *, cfg: XLSTMConfig) -> torch.Tensor:
    """The chunkwise recurrence over (B, T, H, d) q/k/v and (B, T, H)
    gates → (B, T, H·d)."""
    b, t, h, d = q.shape
    ch = min(cfg.chunk, t)
    if t % ch:
        raise ValueError(f"sequence {t} is not a multiple of the mLSTM "
                         f"chunk {ch}")
    cache = mlstm_init_cache(cfg, b, device=q.device)
    carry = tuple(cache[n].to(ig.dtype) for n in ("C", "n", "m"))
    hys = []
    for chunk in zip(*(a.split(ch, dim=1) for a in (q, k, v, ig, fg))):
        carry, hy = _mlstm_chunk(carry, *chunk)
        hys.append(hy)
    return torch.cat(hys, dim=1).reshape(b, t, h * d)


def mlstm_init_cache(cfg: XLSTMConfig, batch: int, device) -> Params:
    """(C, n, m) in f32: zeros, and m at ``NEG_INIT``."""
    h, d = cfg.n_heads, cfg.head_dim_m
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, d, d), dtype=f32, device=device),
            "n": torch.zeros((batch, h, d), dtype=f32, device=device),
            "m": torch.full((batch, h), NEG_INIT, dtype=f32, device=device)}


def mlstm_decode(params: Params, x: torch.Tensor, cache: Params,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d_model).  Updates ``cache`` in place."""
    b = x.shape[0]
    h, d = cfg.n_heads, cfg.head_dim_m
    up = upcast_dtype()
    up_x, gate = torch.chunk(x @ params["w_up"], 2, dim=-1)   # (B,1,di)
    q = (up_x @ params["w_q"]).reshape(b, h, d).to(up)
    k = (up_x @ params["w_k"]).reshape(b, h, d).to(up)
    v = (up_x @ params["w_v"]).reshape(b, h, d).to(up)
    ig, fg = (g[:, 0] for g in _mlstm_gates(params, up_x))
    m0 = cache["m"].to(up)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m0, ig)
    fd = torch.exp(logf + m0 - m_new)
    idec = torch.exp(ig - m_new)
    C1 = cache["C"].to(up) * fd[..., None, None] \
        + torch.einsum("bhd,bhe->bhde", k * idec[..., None], v)
    n1 = cache["n"].to(up) * fd[..., None] + k * idec[..., None]
    qf = q * d ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qf, C1)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n1))
    hy = (num / torch.maximum(den, torch.exp(-m_new))[..., None]) \
        .reshape(b, 1, h * d)
    for name, val in (("C", C1), ("n", n1), ("m", m_new)):
        cache[name].copy_(val)
    return _readout(hy, gate, x.dtype) @ params["w_down"], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: XLSTMConfig,
               dtype=torch.float32) -> Params:
    """Input projection and post-FFN in ``dtype``; the recurrent
    block-diagonal matrices ``r_*`` (H, hd, hd) and the gate bias in f32."""
    d = cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim_s
    dff = int(d * cfg.proj_factor_s)
    dev = gen.device

    def rec():
        return torch.randn((h, hd, hd), generator=gen, device=dev) \
            * hd ** -0.5
    p = {"w_ifzo": dense_init(gen, d, 4 * d, dtype)}
    for name in ("r_i", "r_f", "r_z", "r_o"):
        p[name] = rec()
    p["b_ifzo"] = torch.zeros(4 * d, dtype=torch.float32, device=dev)
    p["w_ff1"] = dense_init(gen, d, dff, dtype)
    p["w_ff2"] = dense_init(gen, dff, d, dtype)
    return p


def _recurrent(params: Params) -> torch.Tensor:
    """r_i, r_f, r_z, r_o as one (H, hd, 4, hd) tensor: one product per
    step gives all four gates' recurrent terms."""
    up = upcast_dtype()
    return torch.stack([params[n].to(up) for n in ("r_i", "r_f", "r_z",
                                                   "r_o")], dim=2)


def _slstm_step(r_all, cfg: XLSTMConfig, carry, xt):
    """xt: (B, 4d) input projections with the gate bias added (upcast).
    carry: (c, n, m) (B,H,hd) and h (B, d).  Returns (carry, h_t)."""
    c0, n0, m0, h0 = carry
    b = xt.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim_s
    rec = torch.einsum("bhd,hdge->bghe", h0.reshape(b, h, hd), r_all)
    pre = xt.reshape(b, 4, h, hd) + rec
    it, ft = pre[:, 0], pre[:, 1]
    zt = torch.tanh(pre[:, 2])
    ot = torch.sigmoid(pre[:, 3])
    logf = F.logsigmoid(ft)
    m1 = torch.maximum(logf + m0, it)
    fdec = torch.exp(logf + m0 - m1)
    idec = torch.exp(it - m1)
    c1 = c0 * fdec + idec * zt
    n1 = n0 * fdec + idec
    h1 = (ot * c1 / torch.clamp(n1, min=1e-6)).reshape(b, h * hd)
    return (c1, n1, m1, h1), h1


def _slstm_ffn(params: Params, hy: torch.Tensor) -> torch.Tensor:
    """Post-FFN (proj factor 4/3, tanh-approximate GELU)."""
    y = F.gelu((hy @ params["w_ff1"]).to(upcast_dtype()), approximate="tanh")
    return y.to(hy.dtype) @ params["w_ff2"]


def slstm_apply(params: Params, x: torch.Tensor, cfg: XLSTMConfig
                ) -> torch.Tensor:
    """Training path.  x: (B, T, d_model); a Python loop over T."""
    up = upcast_dtype()
    xt = (x @ params["w_ifzo"]).to(up) + params["b_ifzo"].to(up)
    hy = rows_local(functools.partial(_slstm_scan, cfg=cfg), (xt,),
                    (_recurrent(params),)).to(x.dtype)        # (B,T,d)
    return _slstm_ffn(params, hy)


def _slstm_scan(xt, r_all, *, cfg: XLSTMConfig) -> torch.Tensor:
    """The recurrence over (B, T, 4d) upcast input projections → (B, T,
    d) hidden states."""
    cache = slstm_init_cache(cfg, xt.shape[0], device=xt.device)
    carry = tuple(cache[n].to(xt.dtype) for n in ("c", "n", "m", "h"))
    hs = []
    # unbind, not xt[:, i]: each index's backward would add a full-size
    # zero gradient of xt per step
    for x_i in xt.unbind(1):
        carry, h1 = _slstm_step(r_all, cfg, carry, x_i)
        hs.append(h1)
    return torch.stack(hs, dim=1)


def slstm_init_cache(cfg: XLSTMConfig, batch: int, device) -> Params:
    """(c, n, m) (B, H, hd) and h (B, d) in f32; m at ``NEG_INIT``."""
    h, hd = cfg.n_heads, cfg.head_dim_s
    f32 = torch.float32
    return {"c": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.full((batch, h, hd), NEG_INIT, dtype=f32,
                            device=device),
            "h": torch.zeros((batch, h * hd), dtype=f32, device=device)}


def slstm_decode(params: Params, x: torch.Tensor, cache: Params,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Params]:
    """One step.  x: (B, 1, d_model).  Updates ``cache`` in place."""
    up = upcast_dtype()
    xt = (x @ params["w_ifzo"])[:, 0].to(up) + params["b_ifzo"].to(up)
    names = ("c", "n", "m", "h")
    carry = tuple(cache[n].to(up) for n in names)
    carry, h1 = _slstm_step(_recurrent(params), cfg, carry, xt)
    for name, val in zip(names, carry):
        cache[name].copy_(val)
    return _slstm_ffn(params, h1[:, None].to(x.dtype)), cache
