"""The Mamba SSM block's config (the port of ``repro.models.ssm.SSMConfig``).

Only the config is ported: ``configs.base.ModelConfig`` needs it.  The
Mamba SSM block itself wait for ROADMAP A16c; the LM stack raises
``NotImplementedError`` for a config that uses them.
"""
from __future__ import annotations

import dataclasses


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
