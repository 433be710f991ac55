"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    ffn_activation="silu_glu",
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab_size=512)
