"""The mixture-of-experts FFN's config (the port of ``repro.models.moe.MoEConfig``).

Only the config is ported: ``configs.base.ModelConfig`` needs it.  The
mixture-of-experts FFN itself wait for ROADMAP A16; the LM stack raises
``NotImplementedError`` for a config that uses them.
"""
from __future__ import annotations

import dataclasses


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
