"""Decoder-only dense LM assembly — the port of the parts of
``repro.models.transformer`` a dense decoder runs.

The param tree is the reference's: the layer stack is grouped into
repeating periods (``cfg.pattern``) and each position's params are stacked
over the periods under ``layers/b{pos}``, so checkpoints map leaf for leaf
between the packages.  Where the reference scans over periods, the port
loops over the leading axis in Python (each stacked leaf is unbound once,
so its gradient is one stack in the backward pass).

``remat`` is not applied: at the sizes the port trains (SmolLM-360M at
batch 8 × 128 tokens: ~2 GB of activations) recomputing the forward would
only cost time, and a recomputed sparse FFN would count ``encode:act``
twice (ROADMAP Queue C).  The sharding ``constraint`` calls are no-ops on
one device and are left out.

Families and features that are not ported raise ``NotImplementedError``
naming their ROADMAP item: enc-dec, modality frontends, MoE, MLA, sliding
windows, the ``M``/``m``/``s`` kinds, an unrolled dense prefix, and the
LM's bf16 paths (A16); decode and prefill (A17).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.device import resolve_device

from .attention import attn_apply, attn_init
from .common import dense_init, dtype_of, embed_init, make_norm, upcast_dtype
from .ffn import ffn_apply

Params = Dict[str, Any]


def _check_supported(cfg) -> None:
    unported = []
    if cfg.enc_dec:
        unported.append("encoder-decoder")
    if cfg.frontend:
        unported.append("modality frontends")
    if cfg.moe is not None:
        unported.append("MoE")
    if cfg.use_mla:
        unported.append("MLA")
    if cfg.n_dense_layers:
        unported.append("an unrolled dense prefix (n_dense_layers)")
    bad = sorted(set(cfg.pattern) - set("AG"))
    if bad:
        unported.append(f"layer kinds {bad}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported (ROADMAP A16)")


def _ffn_init(gen: torch.Generator, cfg, dtype) -> Params:
    fc = cfg.ffn_config()
    if fc.is_glu:
        return {"w_gate": dense_init(gen, fc.d_model, fc.d_ff, dtype),
                "w_up": dense_init(gen, fc.d_model, fc.d_ff, dtype),
                "w_down": dense_init(gen, fc.d_ff, fc.d_model, dtype)}
    return {"w_up": dense_init(gen, fc.d_model, fc.d_ff, dtype),
            "w_down": dense_init(gen, fc.d_ff, fc.d_model, dtype)}


def block_init(gen: torch.Generator, cfg, kind: str,
               dtype=torch.float32) -> Params:
    """One dense decoder block of kind ``A``/``G``: norms, attention, FFN,
    drawn from ``gen`` on its device."""
    if kind not in "AG":
        raise NotImplementedError(f"layer kind {kind!r}: ROADMAP A16")
    ninit, _ = make_norm(cfg.norm)
    dev = gen.device
    p: Params = {"norm1": _tree.tree_map(lambda t: t.to(dev),
                                         ninit(cfg.d_model, dtype))}
    p["attn"] = attn_init(gen, cfg.attn_config(), dtype)
    p["norm2"] = _tree.tree_map(lambda t: t.to(dev),
                                ninit(cfg.d_model, dtype))
    p["ffn"] = _ffn_init(gen, cfg, dtype)
    return p


def block_apply(p: Params, x: torch.Tensor, cfg, kind: str) -> torch.Tensor:
    """The training path of one dense decoder block (pre-norm residual)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    h = attn_apply(p["attn"], h, cfg.attn_config())
    x = x + h
    h = norm(p["norm2"], x)
    return x + ffn_apply(p["ffn"], h, cfg.ffn_config())


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
            f"{dtype} params: the LM's bf16 paths are ROADMAP A16")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ninit, _ = make_norm(cfg.norm)
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    p["layers"] = {}
    for pos, (kind, _) in enumerate(_period_layout(cfg)):
        blocks = [block_init(gen, cfg, kind, dtype)
                  for _ in range(_n_periods(cfg))]
        p["layers"][f"b{pos}"] = _tree.tree_map(
            lambda *xs: torch.stack(xs), *blocks)
    p["final_norm"] = _tree.tree_map(lambda t: t.to(dev),
                                     ninit(cfg.d_model, dtype))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def params_from_jax(tree, device="cuda") -> Params:
    """The reference's params (a pytree of numpy or JAX arrays, as
    ``jax.tree.map(np.asarray, ...)`` gives them) as the port's tree of
    tensors on ``device`` (default CUDA)."""
    import numpy as np
    dev = resolve_device(device)
    return _tree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def lm_hidden(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, T) → final-normed hidden states (B, T, d)."""
    _check_supported(cfg)
    x = _embed_lookup(params["embed"], tokens)
    layout = _period_layout(cfg)
    stacked = {f"b{pos}": _tree.tree_map(lambda t: t.unbind(0),
                                         params["layers"][f"b{pos}"])
               for pos in range(len(layout))}
    for i in range(_n_periods(cfg)):
        for pos, (kind, _) in enumerate(layout):
            x = block_apply(_select(stacked[f"b{pos}"], i), x, cfg, kind)
    _, norm = make_norm(cfg.norm)
    return norm(params["final_norm"], x)


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
    """batch: tokens (B, T+1); the next-token LM loss."""
    if batch.get("frontend_embeds") is not None:
        raise NotImplementedError("modality frontends: ROADMAP A16")
    tokens = batch["tokens"]
    h = lm_hidden(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:]
    d = h.shape[-1]
    return chunked_xent(h.reshape(-1, d), targets.reshape(-1),
                        lm_head_weight(params, cfg))
