"""Deterministic synthetic data: LM token batches, image batches and their
iterators with a checkpointable cursor (the port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step, shard), drawn from a
``torch.Generator`` seeded from that triple, so a restart resumes the
stream exactly from the checkpointed step.  PyTorch cannot reproduce
``jax.random``'s bits, so the two packages' batches differ; cross-checks
feed both the same numpy batch instead.

``train_batch`` adds what the reference's ``registry.train_input_specs``
lays out for enc-dec and frontend configs: standard-normal stub frontend
embeddings beside the tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataState:
    """Checkpointable cursor."""
    step: int = 0


def _generator(seed: int, step: int, shard_index: int,
               stream: int = 0) -> torch.Generator:
    entropy = [seed, step, shard_index] + ([stream] if stream else [])
    state = np.random.SeedSequence(entropy).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def lm_batch(seed: int, step: int, *, batch: int, seq_len: int, vocab: int,
             shard_index: int = 0, shard_count: int = 1,
             noise: float = 0.05, device="cuda") -> Dict[str, torch.Tensor]:
    """(B, T+1) int32 token batch for next-token training, drawn on the CPU
    and moved to ``device``.

    Sequence model, as in the reference: x_{t+1} = (a·x_t + c) mod V with
    probability ``noise`` of a random replacement; (a, c, x_0) drawn per
    example, a in [1, 17)."""
    dev = resolve_device(device)
    gen = _generator(seed, step, shard_index)
    b = batch // shard_count
    a = torch.randint(1, 17, (b,), generator=gen)
    c = torch.randint(0, vocab, (b,), generator=gen)
    x = torch.randint(0, vocab, (b,), generator=gen)
    cols = [x]
    for _ in range(seq_len):
        x = (a * x + c) % vocab
        cols.append(x)
    tokens = torch.stack(cols, dim=1)
    flip = torch.rand(tokens.shape, generator=gen) < noise
    rand = torch.randint(0, vocab, tokens.shape, generator=gen)
    tokens = torch.where(flip, rand, tokens).to(torch.int32)
    return {"tokens": tokens.to(dev)}


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


def train_batch(cfg, seed: int, step: int, *, batch: int, seq_len: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The batch ``lm_loss`` takes for ``cfg`` at ``seq_len`` positions, laid
    out as the reference's ``registry.train_input_specs``: an enc-dec
    model gets seq_len // 2 frames of frontend embeddings and the rest as
    tokens, a frontend model ``frontend_len`` embeddings and the rest as
    tokens, any other model (B, seq_len + 1) tokens.  The f32 embeddings
    are standard normal, drawn on the CPU from their own stream of (seed,
    step)."""
    if cfg.enc_dec:
        frames = seq_len // 2
    elif cfg.frontend:
        frames = cfg.frontend_len
    else:
        return lm_batch(seed, step, batch=batch, seq_len=seq_len,
                        vocab=cfg.vocab_size, device=device)
    out = lm_batch(seed, step, batch=batch, seq_len=seq_len - frames,
                   vocab=cfg.vocab_size, device=device)
    gen = _generator(seed, step, 0, stream=1)
    fe = torch.randn((batch, frames, cfg.frontend_dim), generator=gen)
    out["frontend_embeds"] = fe.to(out["tokens"].device)
    return out


class LMSynthetic:
    """Iterator over ``lm_batch`` with a checkpointable step cursor."""

    def __init__(self, *, seed: int, batch: int, seq_len: int, vocab: int,
                 shard_index: int = 0, shard_count: int = 1,
                 state: Optional[DataState] = None, device="cuda"):
        self.seed, self.batch, self.seq_len, self.vocab = \
            seed, batch, seq_len, vocab
        self.shard_index, self.shard_count = shard_index, shard_count
        self.state = state or DataState()
        self.device = device

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = lm_batch(self.seed, self.state.step, batch=self.batch,
                     seq_len=self.seq_len, vocab=self.vocab,
                     shard_index=self.shard_index,
                     shard_count=self.shard_count, device=self.device)
        self.state.step += 1
        return b


class ImageSynthetic:
    """Iterator over ``image_batch`` with a checkpointable step cursor."""

    def __init__(self, *, seed: int, batch: int, image_size: int,
                 num_classes: int = 100, state: Optional[DataState] = None,
                 device="cuda"):
        self.seed, self.batch = seed, batch
        self.image_size, self.num_classes = image_size, num_classes
        self.state = state or DataState()
        self.device = device

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        out = image_batch(self.seed, self.state.step, batch=self.batch,
                          image_size=self.image_size,
                          num_classes=self.num_classes, device=self.device)
        self.state.step += 1
        return out
