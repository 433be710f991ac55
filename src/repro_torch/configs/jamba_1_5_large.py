"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8: one attention layer (position 4) per 7 Mamba layers; MoE on
every second layer.  Hybrid (7/8 recurrent) → runs long_500k (the single
attention layer per period carries a full 500k KV cache, SP-sharded).
"""
from repro_torch.models.moe import MoEConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern="MMMMAMMM",
    ffn_activation="silu_glu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  activation="silu_glu"),
    moe_every=2,
    moe_offset=1,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, ssm_chunk=8,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                  activation="silu_glu"))
