"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

27L d_model=2048 16H (GQA kv=16, via MLA) d_ff=1408 (routed expert)
vocab=102400.  Layer 0 is a dense-FFN layer (d_ff 10944); layers 1–26 MoE.
MLA is still full softmax attention over the sequence → long_500k skipped.
"""
from repro_torch.models.moe import MoEConfig
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                   # dense prefix layer FFN
    vocab_size=102400,
    ffn_activation="silu_glu",
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2, d_ff_shared=2816,
                  activation="silu_glu"),
    moe_every=1,
    n_dense_layers=1,
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, d_ff=192,
    vocab_size=512, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                  n_shared_experts=1, d_ff_shared=64,
                  activation="silu_glu"))
