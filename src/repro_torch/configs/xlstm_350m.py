"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
are self-contained (mLSTM carries a 2× up-projection, sLSTM a 4/3 FFN);
there is no separate transformer FFN.  Pattern alternates mLSTM/sLSTM.
Recurrent O(1) state → runs the long_500k decode cell.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern="ms",
    ffn_activation="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                     vocab_size=512, xlstm_chunk=8)
