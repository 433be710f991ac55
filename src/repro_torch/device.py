"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"`` and never fall back to the CPU
on their own: without a CUDA device they raise unless the caller asked for
the CPU explicitly (as the CPU tests do).
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises
    ``RuntimeError`` when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
