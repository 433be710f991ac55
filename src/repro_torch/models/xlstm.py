"""The xLSTM blocks' config (the port of ``repro.models.xlstm.XLSTMConfig``).

Only the config is ported: ``configs.base.ModelConfig`` needs it.  The
xLSTM blocks themselves wait for ROADMAP A16c; the LM stack raises
``NotImplementedError`` for a config that uses them.
"""
from __future__ import annotations

import dataclasses


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
