"""Architecture registry and per-cell applicability (the port of
``repro.configs.registry``).  ``input_specs`` belongs to the dry run and
waits for ROADMAP A21.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
