"""internvl2-1b [vlm] — InternViT + InternLM2/Qwen2-0.5B backbone
[arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The ViT frontend
is a STUB per the brief: input_specs() provides precomputed patch
embeddings (projected in-model to d_model).  Pure full attention →
long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    ffn_activation="silu_glu",
    frontend="vit",
    frontend_dim=1024,
    frontend_len=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                     d_ff=128, vocab_size=512, frontend_dim=32,
                     frontend_len=8)
