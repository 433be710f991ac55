"""Optimizers: AdamW with f32 master weights (the port of
``repro.optim.optimizer``)."""
from .optimizer import (OptConfig, adamw_init, adamw_update,  # noqa: F401
                        cosine_lr, global_norm)
