"""Mixture-of-experts FFN with capacity-based dispatch — the port of
``repro.models.moe``.

Top-k softmax routing (optionally device-limited: each token's experts come
from at most ``top_groups`` of ``device_groups`` expert groups), the Switch
load-balance aux loss, per-expert capacity positions by a cumulative sum
over the one-hot routing in token order (GShard), batched ``(E, C, d)``
expert products, and a combine weighted by the renormalized gates.  Tokens
over capacity are dropped: their combine weight is zero and the residual
carries them.

The reference scatters tokens into the expert buffers with
``buf.at[slot].set(..., mode="drop")``, every dropped (token, choice)
landing on one discarded sentinel row.  The port builds the same buffers as
a gather through the inverse map slot → (token, choice), so each live
buffer row has exactly one source, and combines with a gather of each
token's ``k`` slots, whose only shared row is the sentinel's zero row.  The
backward of both gathers therefore accumulates at most one value into any
row that is used, and the step is deterministic on the card.

``set_routing_hook`` is a test seam: a float64 check replays the routing an
f32 step chose (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import stats
from repro_torch.sharding.context import constraint, data_dims
from repro_torch.sharding.partition import is_placed

from .common import activation_fn, dense_init
from .ffn import FFNConfig, ffn_apply, ffn_params

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    activation: str = "silu_glu"
    router_aux_weight: float = 0.01
    # device-limited routing (DeepSeek-V2 §2.1.3): restrict each token's
    # top-k to experts living on at most ``top_groups`` of
    # ``device_groups`` expert shards — bounds EP all-to-all fan-out.
    device_groups: int = 0          # 0 → unrestricted
    top_groups: int = 0

    def shared_config(self, d_model: int) -> FFNConfig:
        return FFNConfig(d_model, self.d_ff_shared
                         or self.d_ff_expert * self.n_shared_experts,
                         self.activation)


# Called as ``hook(name, tensor)`` with name "group_idx" (the chosen expert
# groups, device-limited routing only), "gate_idx" (the chosen experts) and
# "keep" (the (token, choice) pairs within capacity); it returns the tensor
# the layer goes on with.
_ROUTING_HOOK = None


def set_routing_hook(fn):
    """Install (or, with None, remove) the routing hook; returns the
    previous one."""
    global _ROUTING_HOOK
    prev, _ROUTING_HOOK = _ROUTING_HOOK, fn
    return prev


def _routed(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` through the routing hook.  A recomputed forward
    (``cfg.remat``) takes the first forward's routing and capacity drops,
    and calls no hook again."""
    return stats.replayed_call(
        lambda: t if _ROUTING_HOOK is None else _ROUTING_HOOK(name, t))


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32) -> Params:
    """Router (f32), stacked expert weights (E, ·, ·) and the shared
    experts' FFN, drawn from ``gen`` on its device."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    std = d_model ** -0.5

    def ew(a, b):
        return (torch.randn((e, a, b), generator=gen, device=gen.device)
                * std).to(dtype)

    p: Params = {"router": dense_init(gen, d_model, e, torch.float32)}
    if cfg.activation.endswith("_glu"):
        p["w_gate"] = ew(d_model, f)
        p["w_up"] = ew(d_model, f)
        p["w_down"] = ew(f, d_model)
    else:
        p["w_up"] = ew(d_model, f)
        p["w_down"] = ew(f, d_model)
    if cfg.n_shared_experts > 0:
        p["shared"] = ffn_params(gen, cfg.shared_config(d_model), dtype)
    return p


def _expert_ffn(p: Params, xs: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """xs: (E, C, d) -> (E, C, d), batched over the expert axis."""
    if cfg.activation.endswith("_glu"):
        act = activation_fn(cfg.activation.split("_")[0])
        h = act(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
    else:
        h = activation_fn(cfg.activation)(torch.bmm(xs, p["w_up"]))
    return torch.bmm(h, p["w_down"])


def _expert_names(cfg: MoEConfig) -> Tuple[str, ...]:
    return ("w_gate", "w_up", "w_down") if cfg.activation.endswith("_glu") \
        else ("w_up", "w_down")


def _dispatch_combine(xt, slot, w, *weights, capacity: int, cfg: MoEConfig,
                      e_lo: int = 0) -> torch.Tensor:
    """The experts ``e_lo …`` that ``weights`` hold (stacked on dim 0) on
    their slots: xt (T, d) tokens, slot (T, k) buffer slots over all E
    experts (``E·capacity`` for a dropped choice), w (T, k, 1) combine
    weights → (T, d), each token's sum over its choices that these
    experts serve.

    Dispatch: buffer row s takes (token, choice) src[s]; rows nobody
    fills take the appended zero row.  Live slots are distinct, so only
    the discarded sentinel entry of ``src`` is written more than once."""
    p = dict(zip(_expert_names(cfg), weights))
    t, k = slot.shape
    d = xt.shape[-1]
    n = t * k
    lo = e_lo * capacity
    size = p["w_up"].shape[0] * capacity
    lslot = torch.where((slot >= lo) & (slot < lo + size), slot - lo,
                        torch.full_like(slot, size))
    src = torch.full((size + 1,), n, dtype=torch.long, device=xt.device)
    src[lslot.reshape(-1)] = torch.arange(n, device=xt.device)
    rows = torch.cat([xt.unsqueeze(1).expand(t, k, d).reshape(n, d),
                      xt.new_zeros((1, d))])
    xs = constraint(rows[src[:-1]].reshape(-1, capacity, d), "moe_ecd")
    ys = constraint(_expert_ffn(p, xs, cfg), "moe_ecd").reshape(size, d)
    ys = torch.cat([ys, ys.new_zeros((1, d))])
    # Combine: each token's k outputs weighted by the normalized gates.
    return (ys[lslot] * w.to(ys.dtype)).sum(dim=1)


def _experts(xt, slot, w, weights, capacity: int, cfg: MoEConfig):
    """``_dispatch_combine`` over every expert.  On DTensors it runs under
    ``local_map``: the tokens, slots and gates replicated (the slots are
    positions over the global batch), each expert weight gathered over
    the data axes and left as the rules place it over ``model``.  Where
    that splits the experts (EP) or their hidden width (TP), each model
    rank sums its part of every token's output (``Partial``), and its
    part of the tokens' and gates' gradients."""
    if not is_placed(weights[0]):
        return _dispatch_combine(xt, slot, w, *weights, capacity=capacity,
                                 cfg=cfg)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = weights[0].device_mesh
    names = mesh.mesh_dim_names
    data = data_dims(mesh)
    w_pl = [[Replicate() if dp else pl for dp, pl in zip(data, wt.placements)]
            for wt in weights]
    split = [not dp and pl.is_shard()
             for dp, pl in zip(data, weights[0].placements)]
    rep = [Replicate()] * len(names)
    part = [Partial() if s else Replicate() for s in split]
    e_lo = 0
    for i, (dp, pl) in enumerate(zip(data, weights[0].placements)):
        if not dp and pl.is_shard(0):
            e_lo = mesh.get_local_rank(names[i]) * (cfg.n_experts //
                                                    mesh.size(i))
    fn = functools.partial(_dispatch_combine, capacity=capacity, cfg=cfg,
                           e_lo=e_lo)
    return local_map(fn, out_placements=part,
                     in_placements=(rep, rep, rep, *w_pl),
                     in_grad_placements=(part, part, part, *w_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        xt, slot, w, *weights)


def capacity_of(tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: ``int(T·k / E · capacity_factor)``, at least 1."""
    return max(1, int(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig, *,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d_model) → (y, aux_loss)."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = capacity_of(t, cfg)
    dev = x.device

    logits = xt.to(params["router"].dtype) @ params["router"]   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if cfg.device_groups and cfg.top_groups:
        g = cfg.device_groups
        pg = probs.reshape(t, g, e // g)
        gidx = _routed("group_idx", torch.topk(
            pg.amax(dim=-1), cfg.top_groups, dim=-1).indices)  # (T, top_g)
        gmask = torch.zeros((t, g), dtype=probs.dtype, device=dev) \
            .scatter_(1, gidx, 1.0)
        probs = (pg * gmask[..., None]).reshape(t, e)
    gate_idx = _routed("gate_idx", torch.topk(probs, k, dim=-1).indices)
    gate_vals = probs.gather(1, gate_idx)                       # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Load-balance aux loss (Switch): E · Σ_e f_e · P_e
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(gate_idx[:, 0], e).to(probs.dtype) \
        .mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    # Capacity positions: each (token, choice)'s place in its expert's
    # buffer, in token order (GShard).
    ohf = torch.nn.functional.one_hot(gate_idx.reshape(-1), e)  # (T·k, E)
    pos = ((torch.cumsum(ohf, dim=0) - ohf) * ohf).sum(-1).reshape(t, k)
    keep = _routed("keep", pos < capacity)
    slot = gate_idx * capacity + torch.clamp(pos, max=capacity - 1)
    slot = torch.where(keep, slot, torch.full_like(slot, e * capacity))

    w = (gate_vals * keep.to(gate_vals.dtype))[..., None]
    names = _expert_names(cfg)
    y = _experts(xt, slot, w, [params[n] for n in names], capacity, cfg
                 ).to(x.dtype)

    if "shared" in params:
        y = y + ffn_apply(params["shared"], xt, cfg.shared_config(d))
    return y.reshape(shape), aux

