"""gemma3-12b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3-1b-pt;
unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.  Pattern: five
sliding-window (1024) layers per global layer.  Not pure full-attention,
so the long_500k decode cell runs (window caches on L layers, full KV on
the 8 G layers).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern="LLLLLG",
    sliding_window=1024,
    ffn_activation="gelu_glu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab_size=512, sliding_window=8)
