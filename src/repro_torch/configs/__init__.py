"""Architecture configs: one module per assigned arch (copies of the
reference's ``repro.configs``)."""
from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, ShapeConfig, TrainConfig)  # noqa: F401
from .registry import (ARCHS, LONG_CONTEXT_OK, SMOKE_ARCHS, all_cells, get,
                       runs_cell)  # noqa: F401
