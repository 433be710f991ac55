"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b family; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    ffn_activation="silu_glu",
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab_size=512)
