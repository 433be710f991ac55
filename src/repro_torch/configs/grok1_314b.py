"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
MoE on every layer.  Pure full attention → long_500k skipped.
"""
from repro_torch.models.moe import MoEConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    ffn_activation="gelu_glu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                  activation="gelu_glu"),
    moe_every=1,
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                  activation="gelu_glu"))
