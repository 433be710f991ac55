"""Decoder LM / encoder-decoder assembly — the port of the training paths
of ``repro.models.transformer``.

The param tree is the reference's: the decoder stack is grouped into
repeating periods (``cfg.pattern``) and each position's params are stacked
over the periods under ``layers/b{pos}``; an unrolled dense prefix
(``n_dense_layers``, DeepSeek's layer 0) is a list under ``prefix``, the
encoder of an enc-dec model a list under ``encoder/layers``, and a
modality frontend's stub embeddings are projected by ``frontend_proj``.
So checkpoints map leaf for leaf between the packages.  Where the
reference scans over periods, the port loops over the leading axis in
Python (each stacked leaf is unbound once, so its gradient is one stack in
the backward pass).

``remat`` is not applied, to the periods or to the encoder's layers: at
the sizes the port trains recomputing the forward would only cost time,
and a recomputed sparse FFN would count ``encode:act`` twice (ROADMAP
Queue C).  The sharding ``constraint`` calls are no-ops on one device and
are left out.

Not ported, and raising ``NotImplementedError`` naming ROADMAP A16c:
sliding-window layers (kind ``L``), Mamba (``M``), xLSTM (``m``/``s``) and
the LM's bf16 paths; decode and prefill wait for A17.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.device import resolve_device

from .attention import (attn_apply, attn_init, blockwise_attention,
                        cross_attn_apply, cross_attn_init)
from .common import (apply_rope, dense_init, dtype_of, embed_init, make_norm,
                     upcast_dtype)
from .ffn import ffn_apply, ffn_params
from .moe import moe_apply, moe_init

Params = Dict[str, Any]


def _check_supported(cfg) -> None:
    kinds = set(cfg.pattern) | (set(cfg.enc_pattern) if cfg.enc_dec
                                else set())
    bad = sorted(kinds - set("AG"))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} not ported (ROADMAP A16c)")


def _norm_init(cfg, dtype, dev) -> Params:
    ninit, _ = make_norm(cfg.norm)
    return _tree.tree_map(lambda t: t.to(dev), ninit(cfg.d_model, dtype))


def block_init(gen: torch.Generator, cfg, kind: str, use_moe: bool = False,
               *, cross: bool = False, dtype=torch.float32) -> Params:
    """One block of kind ``A``/``G``: norms, attention, cross-attention
    (``cross``), and an FFN or MoE, drawn from ``gen`` on its device."""
    if kind not in "AG":
        raise NotImplementedError(f"layer kind {kind!r}: ROADMAP A16c")
    dev = gen.device
    p: Params = {"norm1": _norm_init(cfg, dtype, dev)}
    p["attn"] = attn_init(gen, cfg.attn_config(), dtype)
    if cross:
        p["norm_x"] = _norm_init(cfg, dtype, dev)
        p["cross"] = cross_attn_init(gen, cfg.attn_config(), cfg.d_model,
                                     dtype)
    p["norm2"] = _norm_init(cfg, dtype, dev)
    if use_moe:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.moe, dtype)
    else:
        p["ffn"] = ffn_params(gen, cfg.ffn_config(), dtype)
    return p


def _encoder_attn(p: Params, h: torch.Tensor, acfg) -> torch.Tensor:
    """The encoder's bidirectional self-attention: RoPE, no causal mask."""
    b, t, _ = h.shape
    q = (h @ p["wq"]).reshape(b, t, acfg.n_heads, acfg.head_dim)
    k = (h @ p["wk"]).reshape(b, t, acfg.n_kv_heads, acfg.head_dim)
    v = (h @ p["wv"]).reshape(b, t, acfg.n_kv_heads, acfg.head_dim)
    pos = torch.arange(t, device=h.device)
    q = apply_rope(q, pos, acfg.rope_theta)
    k = apply_rope(k, pos, acfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=False, q_chunk=acfg.q_chunk,
                            kv_chunk=acfg.kv_chunk)
    return o.reshape(b, t, -1) @ p["wo"]


def block_apply(p: Params, x: torch.Tensor, cfg, kind: str,
                use_moe: bool = False, *, causal: bool = True,
                memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training path of one pre-norm residual block; returns (x,
    moe_aux).  ``causal=False`` is the encoder's bidirectional attention;
    ``memory`` feeds the cross-attention of a block that has one."""
    _, norm = make_norm(cfg.norm)
    aux = torch.zeros((), dtype=upcast_dtype(), device=x.device)
    acfg = cfg.attn_config()
    h = norm(p["norm1"], x)
    h = attn_apply(p["attn"], h, acfg) if causal \
        else _encoder_attn(p["attn"], h, acfg)
    x = x + h
    if memory is not None and "cross" in p:
        h = norm(p["norm_x"], x)
        x = x + cross_attn_apply(p["cross"], h, memory, acfg)
    h = norm(p["norm2"], x)
    if use_moe:
        h, aux = moe_apply(p["moe"], h, cfg.moe)
    else:
        h = ffn_apply(p["ffn"], h, cfg.ffn_config())
    return x + h, aux


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens``; an id outside the vocabulary gives a
    zero row (the reference's vocab-sharded lookup)."""
    v = embed.shape[0]
    ok = (tokens >= 0) & (tokens < v)
    rows = embed[tokens.clamp(0, v - 1)]
    return rows * ok[..., None].to(rows.dtype)


def _period_layout(cfg) -> Tuple[Tuple[str, bool], ...]:
    """(kind, use_moe) per position within one period of the decoder."""
    kinds = cfg.layer_kinds()
    period = len(cfg.pattern)
    start = cfg.n_dense_layers
    return tuple((kinds[start + pos], cfg.layer_uses_moe(start + pos))
                 for pos in range(period))


def _n_periods(cfg) -> int:
    return (cfg.n_layers - cfg.n_dense_layers) // len(cfg.pattern)


def lm_init(seed: int, cfg, *, dtype=None, device="cuda") -> Params:
    """Random params in the reference's tree, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default CUDA;
    raises without one unless ``device="cpu"``).  PyTorch cannot reproduce
    ``jax.random``'s bits: cross-checks carry the reference's params over
    with ``params_from_jax``."""
    _check_supported(cfg)
    dtype = dtype or dtype_of(cfg.dtype)
    if dtype != torch.float32:
        raise NotImplementedError(
            f"{dtype} params: the LM's bf16 paths are ROADMAP A16c")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    if cfg.frontend:
        p["frontend_proj"] = dense_init(gen, cfg.frontend_dim or cfg.d_model,
                                        cfg.d_model, dtype)
    if cfg.n_dense_layers:
        kinds = cfg.layer_kinds()
        p["prefix"] = [block_init(gen, cfg, kinds[i], dtype=dtype)
                       for i in range(cfg.n_dense_layers)]
    p["layers"] = {}
    for pos, (kind, use_moe) in enumerate(_period_layout(cfg)):
        blocks = [block_init(gen, cfg, kind, use_moe, cross=cfg.enc_dec,
                             dtype=dtype)
                  for _ in range(_n_periods(cfg))]
        p["layers"][f"b{pos}"] = _tree.tree_map(
            lambda *xs: torch.stack(xs), *blocks)
    p["final_norm"] = _norm_init(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.enc_dec:
        p["encoder"] = {
            "layers": [block_init(gen, cfg, _enc_kind(cfg, i), dtype=dtype)
                       for i in range(cfg.n_enc_layers)],
            "final_norm": _norm_init(cfg, dtype, dev)}
    return p


def _enc_kind(cfg, i: int) -> str:
    return cfg.enc_pattern[i % len(cfg.enc_pattern)]


def params_from_jax(tree, device="cuda") -> Params:
    """The reference's params (a pytree of numpy or JAX arrays, as
    ``jax.tree.map(np.asarray, ...)`` gives them) as the port's tree of
    tensors on ``device`` (default CUDA)."""
    import numpy as np
    dev = resolve_device(device)
    return _tree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def encode(params: Params, frontend_embeds: torch.Tensor, cfg
           ) -> torch.Tensor:
    """The encoder trunk over stub frontend embeddings (B, F,
    frontend_dim) → the memory (B, F, d)."""
    _, norm = make_norm(cfg.norm)
    x = frontend_embeds
    if "frontend_proj" in params:
        x = x @ params["frontend_proj"]
    for i, lp in enumerate(params["encoder"]["layers"]):
        x, _ = block_apply(lp, x, cfg, _enc_kind(cfg, i), causal=False)
    return norm(params["encoder"]["final_norm"], x)


def prepend_frontend(fe: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The projected frontend embeddings (B, F, d) ahead of the token
    embeddings (B, T, d)."""
    return torch.cat([fe.to(x.dtype), x], dim=1)


def lm_hidden(params: Params, tokens: torch.Tensor, cfg,
              frontend_embeds: Optional[torch.Tensor] = None,
              memory: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) → final-normed hidden states (B, T', d) and the MoE
    aux loss summed over layers.  A decoder-only frontend model's
    projected embeddings come first (T' = F + T); an enc-dec model's
    decoder cross-attends to ``memory``."""
    _check_supported(cfg)
    x = _embed_lookup(params["embed"], tokens)
    if frontend_embeds is not None and not cfg.enc_dec:
        fe = frontend_embeds
        if "frontend_proj" in params:
            fe = fe @ params["frontend_proj"]
        x = prepend_frontend(fe, x)
    aux = torch.zeros((), dtype=upcast_dtype(), device=x.device)
    kinds = cfg.layer_kinds()
    for i in range(cfg.n_dense_layers):
        x, a = block_apply(params["prefix"][i], x, cfg, kinds[i],
                           memory=memory)
        aux = aux + a
    layout = _period_layout(cfg)
    stacked = {f"b{pos}": _tree.tree_map(lambda t: t.unbind(0),
                                         params["layers"][f"b{pos}"])
               for pos in range(len(layout))}
    for i in range(_n_periods(cfg)):
        for pos, (kind, use_moe) in enumerate(layout):
            x, a = block_apply(_select(stacked[f"b{pos}"], i), x, cfg, kind,
                               use_moe, memory=memory)
            aux = aux + a
    _, norm = make_norm(cfg.norm)
    return norm(params["final_norm"], x), aux


def _select(unbound, i):
    """Layer ``i`` of a tree whose leaves are tuples of per-layer tensors."""
    if isinstance(unbound, dict):
        return {k: _select(v, i) for k, v in unbound.items()}
    return unbound[i]


def lm_head_weight(params: Params, cfg) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def chunked_xent(h2d: torch.Tensor, targets: torch.Tensor,
                 w_head: torch.Tensor, *, chunk: int = 4096
                 ) -> torch.Tensor:
    """Mean next-token cross-entropy over chunks of ``chunk`` positions,
    logits in f32 (``common.upcast_dtype``).  h2d: (T, d); targets: (T,)
    with -1 = pad; w_head: (d, V)."""
    t = h2d.shape[0]
    chunk = min(chunk, t)
    pad = -t % chunk
    if pad:
        h2d = torch.nn.functional.pad(h2d, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad), value=-1)
    up = upcast_dtype()
    w32 = w_head.to(up)
    loss_sum = torch.zeros((), dtype=up, device=h2d.device)
    n_valid = torch.zeros((), dtype=up, device=h2d.device)
    for lo in range(0, h2d.shape[0], chunk):
        hx, tx = h2d[lo:lo + chunk], targets[lo:lo + chunk]
        logits = hx.to(up) @ w32
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tx.clamp(min=0)[:, None].long())[:, 0]
        valid = (tx >= 0).to(up)
        loss_sum = loss_sum + ((lse - tgt) * valid).sum()
        n_valid = n_valid + valid.sum()
    return loss_sum / torch.clamp(n_valid, min=1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg
            ) -> torch.Tensor:
    """batch: tokens (B, T+1) [+ frontend_embeds (B, F, frontend_dim)];
    the next-token LM loss plus the MoE aux loss.  An enc-dec model
    encodes the frontend embeddings into the decoder's memory; a
    decoder-only frontend model prepends them, with no targets (-1) at
    their positions."""
    memory = None
    fe = batch.get("frontend_embeds")
    if cfg.enc_dec:
        memory = encode(params, fe, cfg)
        fe = None
    tokens = batch["tokens"]
    h, aux = lm_hidden(params, tokens[:, :-1], cfg, frontend_embeds=fe,
                       memory=memory)
    targets = tokens[:, 1:]
    if fe is not None:
        pad = torch.full(fe.shape[:2], -1, dtype=targets.dtype,
                         device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    d = h.shape[-1]
    loss = chunked_xent(h.reshape(-1, d), targets.reshape(-1),
                        lm_head_weight(params, cfg))
    return loss + aux
