"""Decoder LM / encoder-decoder assembly — the port of
``repro.models.transformer``: training, prefill and cached decode.

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

Layer kinds: ``A``/``G`` global attention + FFN, ``L`` sliding-window
attention + FFN, ``M`` Mamba + FFN (or MoE), ``m``/``s`` self-contained
mLSTM/sLSTM blocks (no FFN).  Params may be f32 or bf16 (``cfg.dtype``'s
default); norms, attention scores, the recurrences and the loss compute in
f32 (``common.upcast_dtype``).

``remat`` is not applied, to the periods or to the encoder's layers: at
the sizes the port trains recomputing the forward would only cost time,
and a recomputed sparse FFN would count ``encode:act`` twice (ROADMAP
Queue C).  The Mamba chunk body is the exception (``models/ssm.py``).
The activations are annotated where the reference annotates them
(``constraint``: ``act_btd``, ``act_stash``, ``head_dv``), so on DTensor
params (``train_loop(mesh=...)``) the installed rules lay them out as
GSPMD does.

Decode (``init_caches``, ``decode_step``): the caches are real per-period
tensors (the reference broadcasts one cache over the periods), updated in
place at each token's slot, so a tick copies no cache.  ``decode_step``
takes the f32 head (``decode_head``) from its caller, which may make it
once.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.device import resolve_device
from repro_torch.kernels import stats
from repro_torch.sharding.context import (by_axis, constraint,
                                         current_rules, data_dims, settle)
from repro_torch.sharding.partition import is_placed

from .attention import (attn_apply, attn_decode, attn_init,
                        blockwise_attention, cross_attn_apply,
                        cross_attn_init)
from .attention import init_cache as attn_init_cache
from .common import (MetaGenerator, apply_rope, dense_init, dtype_of,
                     embed_init, make_norm, upcast_dtype)
from .ffn import ffn_apply, ffn_params
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_decode, ssm_init, ssm_init_cache
from .xlstm import (mlstm_apply, mlstm_decode, mlstm_init, mlstm_init_cache,
                    slstm_apply, slstm_decode, slstm_init, slstm_init_cache)

Params = Dict[str, Any]


def _norm_init(cfg, dtype, dev) -> Params:
    ninit, _ = make_norm(cfg.norm)
    return _tree.tree_map(lambda t: t.to(dev), ninit(cfg.d_model, dtype))


def _block_attn_cfg(cfg, kind: str):
    """The attention config of a block of ``kind``: windowed for ``L``."""
    window = cfg.sliding_window if kind == "L" else None
    return cfg.attn_config(window=window)


def block_init(gen: torch.Generator, cfg, kind: str, use_moe: bool = False,
               *, cross: bool = False, dtype=torch.float32) -> Params:
    """One block of ``kind`` drawn from ``gen`` on its device: norms, its
    mixer (attention, Mamba, mLSTM or sLSTM), cross-attention (``cross``),
    and an FFN or MoE (none for ``m``/``s``)."""
    dev = gen.device
    p: Params = {"norm1": _norm_init(cfg, dtype, dev)}
    if kind in "ALG":
        p["attn"] = attn_init(gen, _block_attn_cfg(cfg, kind), dtype)
    elif kind == "M":
        p["ssm"] = ssm_init(gen, cfg.ssm_config(), dtype)
    elif kind == "m":
        p["mlstm"] = mlstm_init(gen, cfg.xlstm_config(), dtype)
        return p
    elif kind == "s":
        p["slstm"] = slstm_init(gen, cfg.xlstm_config(), dtype)
        return p
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
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
    h = norm(p["norm1"], x)
    if kind in "ALG":
        acfg = _block_attn_cfg(cfg, kind)
        h = attn_apply(p["attn"], h, acfg) if causal \
            else _encoder_attn(p["attn"], h, acfg)
    elif kind == "M":
        with stats.layer_scope("ssm"):
            h = ssm_apply(p["ssm"], h, cfg.ssm_config())
    elif kind == "m":
        with stats.layer_scope("mlstm"):
            return x + mlstm_apply(p["mlstm"], h, cfg.xlstm_config()), aux
    elif kind == "s":
        with stats.layer_scope("slstm"):
            return x + slstm_apply(p["slstm"], h, cfg.xlstm_config()), aux
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return _block_tail(p, x + h, cfg, use_moe, memory)


def _block_tail(p: Params, x: torch.Tensor, cfg, use_moe: bool,
                memory: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """After the mixer's residual: cross-attention over ``memory`` (if the
    block has one), then the FFN or MoE; returns (x, moe_aux)."""
    _, norm = make_norm(cfg.norm)
    aux = torch.zeros((), dtype=upcast_dtype(), device=x.device)
    x = constraint(x, "act_btd")
    if memory is not None and "cross" in p:
        h = norm(p["norm_x"], x)
        x = x + cross_attn_apply(p["cross"], h, memory, cfg.attn_config())
    h = norm(p["norm2"], x)
    if use_moe:
        h, aux = moe_apply(p["moe"], h, cfg.moe)
    else:
        h = ffn_apply(p["ffn"], h, cfg.ffn_config())
    return constraint(x + h, "act_btd"), aux


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens``; an id outside the vocabulary gives a
    zero row (the reference's vocab-sharded lookup).

    When the installed rules carry the mesh (``"__mesh__"``) and
    ``"embed_vocab_axis"``, and the table is a DTensor split on that axis
    along its vocabulary, each rank gathers from its own slice of the
    vocabulary, masks the ids it does not own, and the rows are summed
    over the vocab axis (``collectives._reduce``, counted in
    ``wire_bytes()``): the reference's ``shard_map`` lookup."""
    rules = current_rules() or {}
    mesh, vaxis = rules.get("__mesh__"), rules.get("embed_vocab_axis")
    if mesh is not None and vaxis is not None and is_placed(embed):
        names = embed.device_mesh.mesh_dim_names
        pl = embed.placements[names.index(vaxis)]
        if pl.is_shard(0):
            return _embed_lookup_vocab_sharded(embed, tokens, mesh, vaxis)
    v = embed.shape[0]
    ok = (tokens >= 0) & (tokens < v)
    ids = tokens.clamp(0, v - 1)
    if is_placed(embed):
        # F.embedding, whose backward DTensor shards (indexing's
        # index_put has no strategy for it in torch 2.11), on the table
        # gathered over every axis but its vocabulary's split (FSDP's
        # split of d meets the batch's split of the ids on the data axis)
        from torch.distributed.tensor import Replicate
        embed = embed.redistribute(placements=[
            p if p.is_shard(0) else Replicate() for p in embed.placements])
        rows = torch.nn.functional.embedding(ids, embed)
    else:
        rows = embed[ids]
    return rows * ok[..., None].to(rows.dtype)


def _embed_lookup_vocab_sharded(embed, tokens, mesh, vaxis: str):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import collectives
    names = embed.device_mesh.mesh_dim_names
    vs = embed.shape[0] // mesh.shape[vaxis]
    lo = mesh.coords[vaxis] * vs
    rows = by_axis(embed.device_mesh, Shard(0), Replicate())

    def f(emb, toks):
        idx = toks - lo
        ok = (idx >= 0) & (idx < vs)
        out = emb[idx.clamp(0, vs - 1)] * ok[..., None].to(emb.dtype)
        with torch.no_grad():
            summed = collectives._reduce(out.detach(), mesh, (vaxis,))
        return out + (summed - out).detach()     # the sum; its gradient
                                                 # is each rank's own rows

    table = [Shard(0) if n == vaxis else Replicate() for n in names]
    table_grad = [Partial() if d else pl
                  for d, pl in zip(data_dims(embed.device_mesh), table)]
    return local_map(f, out_placements=rows, in_placements=(table, rows),
                     in_grad_placements=(table_grad, rows),
                     device_mesh=embed.device_mesh,
                     redistribute_inputs=True)(embed, tokens)


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
    with ``params_from_jax``.  ``dtype`` defaults to ``cfg.dtype``
    (bfloat16 unless the config says otherwise); the leaves the reference
    keeps in f32 whatever the dtype (routers, SSM and xLSTM gate params)
    stay f32.  On ``device="meta"`` nothing is drawn: the same tree of
    leaves with the same shapes and dtypes, holding no data."""
    dtype = dtype or dtype_of(cfg.dtype)
    dev = resolve_device(device)
    gen = MetaGenerator() if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
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
        p["layers"][f"b{pos}"] = _stacked(
            lambda: block_init(gen, cfg, kind, use_moe, cross=cfg.enc_dec,
                               dtype=dtype), _n_periods(cfg))
    p["final_norm"] = _norm_init(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.enc_dec:
        p["encoder"] = {
            "layers": [block_init(gen, cfg, _enc_kind(cfg, i), dtype=dtype)
                       for i in range(cfg.n_enc_layers)],
            "final_norm": _norm_init(cfg, dtype, dev)}
    return p


def _stacked(draw, n: int) -> Params:
    """``n`` trees from ``draw()`` stacked leaf by leaf along a new leading
    axis, each copied into place as it is drawn (so the peak is the stack
    and one tree, not two stacks)."""
    tree = draw()
    out = _tree.tree_map(
        lambda t: torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device), tree)
    for i in range(n):
        if i:
            tree = draw()
        for dst, src in zip(_tree.leaves(out), _tree.leaves(tree)):
            dst[i].copy_(src)
        tree = None
    return out


def _enc_kind(cfg, i: int) -> str:
    return cfg.enc_pattern[i % len(cfg.enc_pattern)]


def params_from_jax(tree, device="cuda") -> Params:
    """The reference's params (a pytree of numpy or JAX arrays, as
    ``jax.tree.map(np.asarray, ...)`` gives them) as the port's tree of
    tensors on ``device`` (default CUDA).  A bf16 leaf arrives as an
    ``ml_dtypes`` bfloat16 array, which ``torch.from_numpy`` refuses: its
    bits are carried over as int16 and viewed as ``torch.bfloat16``."""
    dev = resolve_device(device)
    return _tree.tree_map(lambda a: _tensor_of(a).to(dev), tree)


def _tensor_of(a) -> torch.Tensor:
    import numpy as np
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
    x = _embed_lookup(params["embed"], tokens)
    if frontend_embeds is not None and not cfg.enc_dec:
        fe = frontend_embeds
        if "frontend_proj" in params:
            fe = fe @ params["frontend_proj"]
        x = prepend_frontend(fe, x)
    x = constraint(x, "act_btd")
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
        x = constraint(x, "act_stash")
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
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return constraint(w, "head_dv")


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
        tgt = settle(logits.gather(-1, tx.clamp(min=0)[:, None].long()))[:, 0]
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
    # on DTensors the loss is whole on every rank: the backward pass then
    # starts from one seed, not from a seed on each rank's partial sum
    return settle(loss + aux)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def block_init_cache(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> Params:
    """One block's decode state: the attention cache (a ring buffer for
    ``L``), Mamba's (conv, h), mLSTM's (C, n, m) or sLSTM's (c, n, m,
    h)."""
    if kind in "ALG":
        return attn_init_cache(_block_attn_cfg(cfg, kind), batch, max_len,
                               dtype, device)
    if kind == "M":
        return ssm_init_cache(cfg.ssm_config(), batch, dtype, device)
    if kind == "m":
        return mlstm_init_cache(cfg.xlstm_config(), batch, device)
    if kind == "s":
        return slstm_init_cache(cfg.xlstm_config(), batch, device)
    raise ValueError(f"unknown layer kind {kind!r}")


def block_decode(p: Params, x: torch.Tensor, cache: Params, index: int,
                 cfg, kind: str, use_moe: bool,
                 memory: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One block on one token x (B, 1, d) at position ``index``, its
    cache updated in place; cross-attends to ``memory`` when the block has
    cross-attention.  Returns (x, cache)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["norm1"], x)
    if kind in "ALG":
        h, cache = attn_decode(p["attn"], h, cache, index,
                               _block_attn_cfg(cfg, kind))
    elif kind == "M":
        h, cache = ssm_decode(p["ssm"], h, cache, cfg.ssm_config())
    elif kind == "m":
        h, cache = mlstm_decode(p["mlstm"], h, cache, cfg.xlstm_config())
        return x + h, cache
    elif kind == "s":
        h, cache = slstm_decode(p["slstm"], h, cache, cfg.xlstm_config())
        return x + h, cache
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    x, _ = _block_tail(p, x + h, cfg, use_moe, memory)
    return x, cache


def init_caches(cfg, batch: int, max_len: int, dtype=torch.float32,
                device="cuda") -> Params:
    """Zeroed decode caches in the reference's tree (``prefix`` list,
    ``layers/b{pos}`` stacked over the periods), each period's state a
    real slice of its stack (not a broadcast view), on ``device``
    (default CUDA).  Attention and conv caches in ``dtype``; recurrent
    states f32."""
    dev = resolve_device(device)
    kinds = cfg.layer_kinds()
    caches: Params = {}
    if cfg.n_dense_layers:
        caches["prefix"] = [
            block_init_cache(cfg, kinds[i], batch, max_len, dtype, dev)
            for i in range(cfg.n_dense_layers)]
    caches["layers"] = {}
    for pos, (kind, _) in enumerate(_period_layout(cfg)):
        one = block_init_cache(cfg, kind, batch, max_len, dtype, dev)
        caches["layers"][f"b{pos}"] = _tree.tree_map(
            lambda t: t[None].repeat((_n_periods(cfg),) + (1,) * t.dim()),
            one)
    return caches


def decode_head(params: Params, cfg) -> torch.Tensor:
    """The (d, V) head weight at the upcast dtype (f32) that
    ``decode_step`` multiplies by: the reference upcasts the head on
    every call; a caller that decodes many tokens makes it once (for bf16
    gemma3-12b a 4 GB copy)."""
    return lm_head_weight(params, cfg).to(upcast_dtype())


def decode_step(params: Params, token: torch.Tensor, caches: Params,
                index: int, cfg, memory: Optional[torch.Tensor] = None, *,
                head: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """token (B,) ids at position ``index`` (a Python int shared by the
    batch) → f32 logits (B, V); ``caches`` are updated in place and
    returned.  ``head`` is ``decode_head(params, cfg)``."""
    x = _embed_lookup(params["embed"], token)[:, None, :]   # (B, 1, d)
    kinds = cfg.layer_kinds()
    for i in range(cfg.n_dense_layers):
        x, _ = block_decode(params["prefix"][i], x, caches["prefix"][i],
                            index, cfg, kinds[i], False, memory=memory)
    layout = _period_layout(cfg)
    unbound = [tuple(_tree.tree_map(lambda t: t.unbind(0),
                                    tree["layers"][f"b{pos}"])
                     for tree in (params, caches))
               for pos in range(len(layout))]
    for i in range(_n_periods(cfg)):
        for (kind, use_moe), (lp, lc) in zip(layout, unbound):
            x, _ = block_decode(_select(lp, i), x, _select(lc, i), index,
                                cfg, kind, use_moe, memory=memory)
    _, norm = make_norm(cfg.norm)
    h = norm(params["final_norm"], x)[:, 0]                 # (B, d)
    return h.to(head.dtype) @ head, caches
