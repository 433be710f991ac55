"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L (encoder) + 12L (decoder), d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206.  The speech frontend is a STUB: input_specs() provides
precomputed frame embeddings consumed by the encoder.  Standard
Transformer **ReLU** FFN → the paper's gradient-output-sparsity technique
applies NATIVELY to this arch (sparse_ffn_scenario can be enabled without
changing the architecture).  Full attention → long_500k skipped; decode
runs on the decoder (enc-dec, not encoder-only).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    ffn_activation="relu",
    norm="layernorm",
    enc_dec=True,
    n_enc_layers=12,
    frontend="audio",
    frontend_dim=1024,
    frontend_len=1024,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab_size=512,
                     frontend_dim=32, frontend_len=8)
