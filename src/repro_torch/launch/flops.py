"""Analytic executed-cost model: FLOPs / HBM bytes / collective bytes —
the port of ``repro.launch.flops``, its arithmetic unchanged.

WHY ANALYTIC: the port runs eagerly and has no compiler's cost analysis,
and the reference's reason holds too (XLA's HLO cost analysis counts a
``while`` body once, so any scanned program is undercounted).  This module
counts the executed work from the architecture itself.  It is held against
``torch.utils.flop_counter.FlopCounterMode`` over the port's own train and
prefill steps on small configs in tests/test_torch_flops.py, and against
the reference's ``analytic_cost`` field for field.

Granularity and conventions (the reference's):
  * matmul FLOPs are derived from the parameter tree itself: every weight
    leaf contributes 2·prod(shape) FLOPs per token that passes through it
    (exactly how the layers use them); MoE expert leaves are scaled by
    top_k·capacity_factor/n_experts (capacity dispatch computes that
    fraction); embed gathers are 0 FLOPs; tied heads add 2·d·V.
  * attention score/value FLOPs are 4·B·T·S_eff·H·Dh with S_eff set by the
    schedule (rect = full S; tri = causal prefix; window = clipped).
  * backward factor: fwd(1) + bwd(2) + remat re-fwd(1 if remat), as the
    port runs it: ``cfg.remat`` recomputes each encoder layer and decoder
    period in the backward (``models.common.remat``), so a path measured
    on the card is bounded at the ``remat`` it ran.
  * HBM/collective byte models use named coefficients (ACT_RW_COEF etc.);
    they are estimates, counted in bf16 bytes whatever the path's dtype,
    held fixed so that deltas are meaningful.

The parameter groups come from ``lm_init(..., device="meta")`` (the
reference's ``jax.eval_shape``), their paths normalized as the reference
normalizes its keystr paths, so every path regex sees the reference's
names.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict

from repro_torch import tree as _tree
from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4

ACT_RW_COEF = 16          # act HBM traffic ≈ coef · L · tokens · d · 2B (train)
ACT_RW_COEF_FWD = 6       # prefill/forward-only
WEIGHT_PASSES_TRAIN = 3   # fwd + bwd + remat re-read per microbatch
OPT_BYTES_PER_PARAM = 40  # master/mu/nu rw (f32) + grad rw
TP_COLLECTIVES_PER_LAYER = 2   # megatron-style per-layer activation syncs


def _norm(pstr: str) -> str:
    """The reference's normalization of a keystr path (``['a'][0]['b']``
    → ``a[0]b``; dict keys joined by ``/``)."""
    return pstr.replace("']['", "/").replace("['", "").replace("']", "")


@dataclasses.dataclass
class CostTerms:
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    detail: Dict[str, float]


def param_shapes(cfg: ModelConfig):
    """The param tree of ``cfg`` as meta tensors (no data)."""
    from repro_torch.models.transformer import lm_init
    return lm_init(0, cfg, device="meta")


def _param_groups(cfg: ModelConfig):
    """Split the param tree into (enc, dec, head, embed, expert-scaled)."""
    shapes = param_shapes(cfg)
    groups = {"dec": 0.0, "enc": 0.0, "cross_kv": 0.0, "head": 0.0,
              "expert_frac": 0.0, "total": 0.0}
    period = len(cfg.pattern)
    n_periods = (cfg.n_layers - cfg.n_dense_layers) // period
    moe = cfg.moe
    for kp, leaf in _tree.leaves_with_paths(shapes):
        path = _norm(kp)
        n = float(math.prod(leaf.shape))
        groups["total"] += n
        if re.search(r"(norm|scale|bias|b_i$|b_f$|dt_bias|d_skip|a_log)", path):
            continue
        if path == "embed":
            if cfg.tie_embeddings:
                groups["head"] += n
            continue
        if path == "lm_head":
            groups["head"] += n
            continue
        target = "enc" if path.startswith("encoder") else "dec"
        if "cross/wk" in path or "cross/wv" in path:
            target = "cross_kv"
        if re.search(r"moe/.*w_(gate|up|down)", path):
            frac = moe.top_k * moe.capacity_factor / moe.n_experts
            groups[target] += n * frac
        else:
            groups[target] += n
    return groups


def _attn_s_eff(t: int, s: int, cfg: ModelConfig, kind: str) -> float:
    """Effective scanned KV length per query token under the lowered
    schedule."""
    kc = min(cfg.kv_chunk, s)
    qc = min(cfg.q_chunk, t)
    nk = -(-s // kc)
    nq = -(-t // qc)
    if cfg.attn_schedule == "tri":
        # q-chunk i scans ceil((i+1)qc/kc) kv chunks
        tot = sum(min(nk, -(-((i + 1) * qc) // kc)) * kc for i in range(nq))
        s_eff = tot / nq
    else:
        s_eff = nk * kc
    if kind == "L" and cfg.sliding_window and cfg.attn_schedule == "win":
        # window schedule (perf variant): only chunks inside the window
        s_eff = min(s_eff, cfg.sliding_window + qc)
    return float(s_eff)


def _layer_kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    kinds = cfg.layer_kinds()
    out: Dict[str, int] = {}
    for k in kinds:
        out[k] = out.get(k, 0) + 1
    out["moe_layers"] = sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))
    return out


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *, dp_n: int,
                  model_n: int, microbatches: int = 1, fsdp: bool = False
                  ) -> CostTerms:
    n_chips = dp_n * model_n
    groups = _param_groups(cfg)
    kinds = _layer_kind_counts(cfg)
    d = cfg.d_model
    hq, dh = cfg.n_heads, cfg.head_dim_ if not cfg.use_mla else cfg.qk_nope_dim
    b, t = shape.global_batch, shape.seq_len
    detail: Dict[str, float] = {}

    train = shape.kind == "train"
    prefill = shape.kind == "prefill"
    decode = shape.kind == "decode"
    bwd_factor = (4.0 if cfg.remat else 3.0) if train else 1.0

    if cfg.enc_dec:
        tokens_dec = b * (t // 2)
        tokens_enc = b * (t // 2)
    elif cfg.frontend:
        tokens_dec = b * t          # frontend tokens flow through the trunk
        tokens_enc = 0
    else:
        tokens_dec = b * t
        tokens_enc = 0
    if decode:
        tokens_dec, tokens_enc = b, 0

    # ---------------- matmul FLOPs (param-tree-driven) ----------------
    mm = 2.0 * (groups["dec"] * tokens_dec + groups["enc"] * tokens_enc
                + groups["cross_kv"] * tokens_enc)
    mm_head = 2.0 * groups["head"] * (tokens_dec if not decode else b)
    if decode:
        mm = 2.0 * groups["dec"] * b + 2.0 * groups["cross_kv"] * 0
    detail["matmul_flops"] = mm * bwd_factor
    detail["head_flops"] = mm_head * bwd_factor

    # ---------------- attention score/value FLOPs ----------------
    attn_f = 0.0
    v_dim = cfg.v_head_dim if cfg.use_mla else cfg.head_dim_
    qk_dim = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.head_dim_
    for kind in ("A", "G", "L"):
        n_l = kinds.get(kind, 0)
        if not n_l:
            continue
        if decode:
            s_ctx = min(cfg.sliding_window, t) if (kind == "L" and
                                                   cfg.sliding_window) else t
            attn_f += n_l * 2.0 * b * hq * s_ctx * (qk_dim + v_dim)
        else:
            s_eff = _attn_s_eff(t if not cfg.enc_dec else t // 2,
                                t if not cfg.enc_dec else t // 2, cfg, kind)
            tok = tokens_dec if not cfg.enc_dec else tokens_dec
            attn_f += n_l * 2.0 * tok * hq * s_eff * (qk_dim + v_dim) * bwd_factor
    if cfg.enc_dec and not decode:
        # encoder self-attn (bidirectional, rect) + decoder cross-attn
        attn_f += cfg.n_enc_layers * 4.0 * tokens_enc * hq * (t // 2) \
            * cfg.head_dim_ * bwd_factor
        attn_f += cfg.n_layers * 4.0 * tokens_dec * hq * (t // 2) \
            * cfg.head_dim_ * bwd_factor
    if cfg.enc_dec and decode:
        attn_f += cfg.n_layers * 4.0 * b * hq * 4096 * cfg.head_dim_  # cross
    detail["attn_flops"] = attn_f

    # ---------------- recurrent-block extras ----------------
    rec_f = 0.0
    if kinds.get("M"):
        di, ds = cfg.ssm_expand * d, cfg.ssm_d_state
        per_tok = 14.0 * di * ds + 10.0 * di
        rec_f += kinds["M"] * per_tok * (tokens_dec if not decode else b) \
            * (bwd_factor if not decode else 1.0)
    if kinds.get("m"):
        xc = cfg.xlstm_config()
        ch, hd, nh = (xc.chunk if not decode else 1), xc.head_dim_m, cfg.n_heads
        per_tok = nh * (4.0 * ch * hd + 4.0 * hd * hd + 6.0 * ch)
        rec_f += kinds["m"] * per_tok * (tokens_dec if not decode else b) \
            * (bwd_factor if not decode else 1.0)
    if kinds.get("s"):
        per_tok = 30.0 * d
        rec_f += kinds["s"] * per_tok * (tokens_dec if not decode else b) \
            * (bwd_factor if not decode else 1.0)
    detail["recurrent_flops"] = rec_f

    # ---------------- elementwise + loss + optimizer ----------------
    ew = 20.0 * d * cfg.n_layers * (tokens_dec if not decode else b) \
        * (bwd_factor if not decode else 1.0)
    loss_f = (4.0 * cfg.vocab_size * tokens_dec * (2.0 if train else 1.0)) \
        if not decode else 4.0 * cfg.vocab_size * b
    opt_f = 12.0 * groups["total"] if train else 0.0
    detail["elementwise_flops"] = ew
    detail["loss_flops"] = loss_f
    detail["opt_flops"] = opt_f

    total_flops = (detail["matmul_flops"] + detail["head_flops"] + attn_f
                   + rec_f + ew + loss_f + opt_f)
    flops_per_device = total_flops / n_chips

    # ---------------- HBM bytes (per device) ----------------
    p_total = groups["total"]
    shard_factor = model_n * (dp_n if fsdp else 1)
    p_res_bytes = p_total * BF16 / shard_factor
    period = len(cfg.pattern)
    n_periods = max(1, (cfg.n_layers - cfg.n_dense_layers) // period)
    tokens_loc = (tokens_dec + tokens_enc) / dp_n if not decode \
        else max(b // dp_n, 1)
    if train:
        w_traffic = WEIGHT_PASSES_TRAIN * microbatches * p_res_bytes
        opt_traffic = OPT_BYTES_PER_PARAM * p_total / shard_factor
        act_traffic = ACT_RW_COEF * cfg.n_layers * tokens_loc * (d / model_n
                                                                 + d) / 2 * BF16
        hbm = w_traffic + opt_traffic + act_traffic
        detail.update(w_traffic=w_traffic, opt_traffic=opt_traffic,
                      act_traffic=act_traffic)
    elif prefill:
        hbm = p_res_bytes + ACT_RW_COEF_FWD * cfg.n_layers * tokens_loc \
            * d * BF16
    else:
        # decode: weights + cache traffic dominate
        cache_bytes = 0.0
        s_ctx = t
        kv_heads = cfg.n_kv_heads
        for kind, cnt in (("A", kinds.get("A", 0)), ("G", kinds.get("G", 0)),
                          ("L", kinds.get("L", 0))):
            if not cnt:
                continue
            s_k = min(cfg.sliding_window, s_ctx) if (kind == "L" and
                                                     cfg.sliding_window) else s_ctx
            if cfg.use_mla:
                per_tok_layer = (cfg.kv_lora_rank + cfg.qk_rope_dim) * BF16
            else:
                per_tok_layer = 2 * kv_heads * cfg.head_dim_ * BF16
            cache_bytes += cnt * max(b // dp_n, 1) * s_k * per_tok_layer / \
                (model_n if kv_heads % model_n == 0 or cfg.use_mla else 1)
        state_bytes = 0.0
        if kinds.get("M"):
            state_bytes += kinds["M"] * max(b // dp_n, 1) * \
                (cfg.ssm_expand * d) * cfg.ssm_d_state * F32 * 2 / model_n
        if kinds.get("m"):
            xc = cfg.xlstm_config()
            state_bytes += kinds["m"] * max(b // dp_n, 1) * cfg.n_heads \
                * xc.head_dim_m ** 2 * F32 * 2
        hbm = p_res_bytes + cache_bytes + state_bytes
        detail.update(cache_traffic=cache_bytes, state_traffic=state_bytes,
                      w_traffic=p_res_bytes)

    # ---------------- collective bytes (per device) ----------------
    coll = 0.0
    if model_n > 1:
        tok_tp = tokens_loc if not decode else max(b // dp_n, 1)
        coll_tp = TP_COLLECTIVES_PER_LAYER * 2.0 * cfg.n_layers * tok_tp \
            * d * BF16 * (2.0 if train else 1.0)
        coll += coll_tp
        detail["coll_tp"] = coll_tp
    if train and dp_n > 1:
        if fsdp:
            ag = microbatches * WEIGHT_PASSES_TRAIN * p_total * BF16 / model_n
            rs = p_total * F32 / model_n
            coll += ag + rs
            detail["coll_fsdp"] = ag + rs
        else:
            ar = 2.0 * p_total * F32 / model_n
            coll += ar
            detail["coll_dp_ar"] = ar
    if cfg.moe is not None and model_n > 1 and not decode:
        # per MoE layer: dispatch + combine a2a (2×), each way (2×), ×2 bwd
        a2a = kinds["moe_layers"] * 4.0 * tokens_loc * cfg.moe.top_k \
            * cfg.moe.capacity_factor * d * BF16 * (2.0 if train else 1.0)
        if cfg.moe.device_groups and cfg.moe.top_groups:
            # device-limited routing bounds each token's expert fan-out to
            # top_groups shards (of min(top_k, device_groups) otherwise)
            a2a *= cfg.moe.top_groups / min(cfg.moe.top_k,
                                            cfg.moe.device_groups)
        coll += a2a
        detail["coll_ep_a2a"] = a2a

    return CostTerms(
        flops_per_device=flops_per_device,
        hbm_bytes_per_device=hbm,
        coll_bytes_per_device=coll,
        detail=detail,
    )
