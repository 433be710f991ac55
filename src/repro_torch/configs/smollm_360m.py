"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    ffn_activation="silu_glu",
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
                     d_ff=192, vocab_size=512)
