"""Architecture registry, per-cell applicability, and input_specs() (the
port of ``repro.configs.registry``).

``input_specs(cfg, shape)`` returns meta tensors standing in for every
input of the step function (the reference returns
``jax.ShapeDtypeStruct``s): the reference's shapes and dtypes, holding no
data, so the dry run (``repro_torch.launch.dryrun``) can size and run
full-size cells on one host without a card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import (deepseek_v2_lite, gemma3_12b, grok1_314b, internvl2_1b,
               jamba_1_5_large, seamless_m4t_medium, smollm_360m,
               stablelm_1_6b, stablelm_3b, xlstm_350m)
from .base import ALL_SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "xlstm-350m": xlstm_350m,
    "stablelm-1.6b": stablelm_1_6b,
    "stablelm-3b": stablelm_3b,
    "smollm-360m": smollm_360m,
    "gemma3-12b": gemma3_12b,
    "grok-1-314b": grok1_314b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "internvl2-1b": internvl2_1b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_ARCHS: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}

# Archs whose sequence mixing is sub-quadratic (SSM / hybrid / mostly-local):
# these run the long_500k decode cell.  Pure full-attention archs skip it
# (as in the reference).
LONG_CONTEXT_OK = ("xlstm-350m", "jamba-1.5-large-398b", "gemma3-12b")


def get(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def runs_cell(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k decode cell skipped"
    return True, ""


def all_cells(include_skipped: bool = False):
    for name, cfg in ARCHS.items():
        for shape in ALL_SHAPES:
            ok, why = runs_cell(cfg, shape)
            if ok or include_skipped:
                yield name, cfg, shape, ok, why


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Batch tree for lm_loss."""
    b, t = shape.global_batch, shape.seq_len
    act_dtype = _act_dtype(cfg)
    if cfg.enc_dec:
        frames = t // 2
        return {
            "tokens": _sds((b, t - frames + 1), torch.int32),
            "frontend_embeds": _sds((b, frames, cfg.frontend_dim),
                                    act_dtype),
        }
    if cfg.frontend:
        f = cfg.frontend_len
        return {
            "tokens": _sds((b, t - f + 1), torch.int32),
            "frontend_embeds": _sds((b, f, cfg.frontend_dim), act_dtype),
        }
    return {"tokens": _sds((b, t + 1), torch.int32)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       memory_len: int = 4096) -> Dict:
    """Inputs for decode_step: token, caches (KV of seq_len), index[,
    memory]."""
    from repro_torch.models.transformer import init_caches
    b, t = shape.global_batch, shape.seq_len
    act_dtype = _act_dtype(cfg)
    spec = {
        "token": _sds((b,), torch.int32),
        "caches": init_caches(cfg, b, t, act_dtype, device="meta"),
        "index": _sds((), torch.int32),
    }
    if cfg.enc_dec:
        spec["memory"] = _sds((b, memory_len, cfg.d_model), act_dtype)
    return spec


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    if shape.kind == "train" or shape.kind == "prefill":
        return train_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
