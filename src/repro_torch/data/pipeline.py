"""Deterministic synthetic image batches (the port of
``repro.data.pipeline.image_batch``).

Every batch is a pure function of (seed, step, shard), drawn from a
``torch.Generator`` seeded from that triple.  PyTorch cannot reproduce
``jax.random``'s bits, so the two packages' batches differ; cross-checks
feed both the same numpy batch instead.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(seed: int, step: int, shard_index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, shard_index]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def image_batch(seed: int, step: int, *, batch: int, image_size: int,
                channels: int = 3, num_classes: int = 100,
                shard_index: int = 0, shard_count: int = 1,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional gaussian-blob images (learnable), normalized to
    zero mean per image: (B, H, W, C) float32 NHWC and (B,) int64 labels.
    Drawn on the CPU (so every device sees the same batch), then moved."""
    dev = resolve_device(device)
    gen = _generator(seed, step, shard_index)
    b = batch // shard_count
    labels = torch.randint(0, num_classes, (b,), generator=gen)
    base = torch.randn((b, image_size, image_size, channels), generator=gen)
    freq = (labels[:, None].to(torch.float32) + 1) / num_classes
    xx = torch.linspace(0, math.pi * 4, image_size)
    pat = torch.sin(freq * xx[None, :])[:, None, :, None] \
        * torch.cos(freq * xx[None, :])[:, :, None, None]
    img = base * 0.5 + pat
    img = img - img.mean(dim=(1, 2, 3), keepdim=True)
    return img.to(dev), labels.to(dev)
