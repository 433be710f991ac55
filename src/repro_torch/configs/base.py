"""Config dataclasses shared by every architecture (the port of
``repro.configs.base``; data only).

``ModelConfig`` is a superset covering dense / MoE / SSM-hybrid / xLSTM /
VLM / audio enc-dec families.  Layer structure is a *pattern* string (one
char per layer within a repeating period):

  A  global attention + FFN           L  sliding-window attention + FFN
  G  global attention + FFN (alias of A, used in local:global patterns)
  M  Mamba SSM block (+FFN)           m  mLSTM block        s  sLSTM block

The stack is ``pattern`` repeated ``n_layers // len(pattern)`` times (after
``n_dense_layers`` unrolled prefix layers), which is what lets the LM
assembly scan over periods with stacked params.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.attention import AttnConfig
from repro_torch.models.ffn import FFNConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.models.xlstm import XLSTMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    ffn_activation: str = "silu_glu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    pattern: str = "A"
    sliding_window: Optional[int] = None
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_every: int = 1                # MoE on positions p with p % every == off
    moe_offset: int = 0
    n_dense_layers: int = 0           # unrolled dense-FFN prefix (deepseek)
    # --- MLA ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM / xLSTM ---
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    xlstm_chunk: int = 64
    # --- encoder-decoder ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_pattern: str = "A"
    # --- modality frontend stubs ---
    frontend: Optional[str] = None    # "vit" | "audio"
    frontend_dim: int = 0             # stub embedding dim (projected in-model)
    frontend_len: int = 256           # number of patch/frame embeddings
    # --- misc ---
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # beyond-paper: route ReLU-family FFNs through the sparse-bwd kernels
    sparse_ffn_scenario: Optional[str] = None   # "IN"|"IN_OUT"|"IN_OUT_WR"
    # attention lowering
    q_chunk: int = 512
    kv_chunk: int = 512
    attn_schedule: str = "rect"       # "rect" | "tri" (perf-optimized)
    remat: bool = True
    # scan unrolling (1 = rolled while-loops).  Used by the cost-model
    # validation tests: XLA's HLO cost analysis does not multiply while
    # bodies by trip count, so HLO-vs-analytic comparisons unroll.
    scan_unroll: int = 1

    # -- derived --
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self, *, window: Optional[int] = None) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim_,
            rope_theta=self.rope_theta, window=window,
            use_mla=self.use_mla, kv_lora_rank=self.kv_lora_rank,
            qk_nope_dim=self.qk_nope_dim, qk_rope_dim=self.qk_rope_dim,
            v_head_dim=self.v_head_dim,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
            schedule=self.attn_schedule, unroll=self.scan_unroll,
        )

    def ffn_config(self) -> FFNConfig:
        from repro_torch.core.policy import SCENARIOS
        pol = SCENARIOS.get(self.sparse_ffn_scenario) \
            if self.sparse_ffn_scenario else None
        return FFNConfig(self.d_model, self.d_ff, self.ffn_activation,
                         sparse_policy=pol)

    def ssm_config(self) -> SSMConfig:
        return SSMConfig(d_model=self.d_model, d_state=self.ssm_d_state,
                         d_conv=self.ssm_d_conv, expand=self.ssm_expand,
                         chunk=self.ssm_chunk, unroll=self.scan_unroll)

    def xlstm_config(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, n_heads=self.n_heads,
                           chunk=self.xlstm_chunk, unroll=self.scan_unroll)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind string for the decoder stack."""
        body = self.n_layers - self.n_dense_layers
        period = len(self.pattern)
        assert body % period == 0, (self.name, body, period)
        return tuple("A" * self.n_dense_layers + self.pattern * (body // period))

    def layer_uses_moe(self, idx: int) -> bool:
        if self.moe is None or idx < self.n_dense_layers:
            return False
        return (idx - self.n_dense_layers) % self.moe_every == self.moe_offset

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch × shape) grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1              # grad-accum splits of the global batch
    loss_scale: float = 0.0            # 0 → off (bf16); >0 → fp16 static scale
    grad_compression: bool = False     # int8 error-feedback DP compression
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    seed: int = 0
