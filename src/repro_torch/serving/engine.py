"""Batched decode engine: continuous-batching-style serving loop — the port
of ``repro.serving.engine``.

Requests are admitted into fixed batch slots; each engine tick decodes one
token for every slot (one ``decode_step`` over the whole batch).  A
finished slot (EOS or ``max_tokens``) is refilled from the queue at the
next tick.  As in the reference, all slots share one cache-length
high-water mark (``index``, one position per tick; per-slot validity is
enforced by masking on position), prompts are fed token by token through
the decode path, the next token is the greedy argmax of the f32 logits,
and ``run`` stops at ``max_len``.

Decode runs under ``torch.inference_mode()`` and updates the caches in
place.  The f32 head weight is made once per engine (for bf16 params the
reference upcasts the whole head on every tick: 4 GB for gemma3-12b's
tied 262,144 × 3,840 embedding); its products are the reference's, f32
products of the same values.  Only the ``B`` next tokens are read back to
the host each tick.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.transformer import (decode_head, decode_step,
                                            init_caches)


@dataclasses.dataclass
class GenRequest:
    request_id: int
    prompt: List[int]
    max_tokens: int = 16
    eos_token: Optional[int] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[GenRequest] = None
    prompt_cursor: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Fixed ``batch_slots`` over caches of ``max_len`` positions, on the
    params' device.  ``dtype`` is the attention and conv caches' dtype,
    f32 by default as in the reference (a Mamba block's conv window sets
    the dtype of its decode arithmetic)."""

    def __init__(self, cfg, params, *, batch_slots: int = 4,
                 max_len: int = 256, dtype=torch.float32):
        self.cfg = cfg
        self.params = params
        embed = params["embed"]
        self.device = embed.device
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.max_len = max_len
        with torch.inference_mode():
            self.caches = init_caches(cfg, batch_slots, max_len,
                                      dtype, self.device)
            self.head = decode_head(params, cfg)
        self.queue: List[GenRequest] = []
        self.done: Dict[int, List[int]] = {}
        self.index = 0

    def submit(self, req: GenRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in self.slots:
            if slot.req is None and self.queue:
                slot.req = self.queue.pop(0)
                slot.prompt_cursor = 0
                slot.generated = []

    @property
    def active(self) -> bool:
        return bool(self.queue) or any(s.req is not None for s in self.slots)

    @torch.inference_mode()
    def step(self) -> None:
        """One engine tick: feed each slot its next token, decode, collect."""
        self._admit()
        feed = [0] * len(self.slots)
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if slot.prompt_cursor < len(slot.req.prompt):
                feed[i] = slot.req.prompt[slot.prompt_cursor]
            else:
                feed[i] = slot.generated[-1] if slot.generated else 0
        tokens = torch.tensor(feed, dtype=torch.int32).to(self.device)
        logits, self.caches = decode_step(self.params, tokens, self.caches,
                                          self.index, self.cfg,
                                          head=self.head)
        nxt = logits.argmax(dim=-1).tolist()
        self.index += 1
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if slot.prompt_cursor < len(slot.req.prompt) - 1:
                slot.prompt_cursor += 1
                continue
            slot.prompt_cursor += 1
            slot.generated.append(int(nxt[i]))
            req = slot.req
            if len(slot.generated) >= req.max_tokens or \
                    (req.eos_token is not None and
                     slot.generated[-1] == req.eos_token):
                self.done[req.request_id] = list(slot.generated)
                slot.req = None

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        ticks = 0
        while self.active and ticks < max_ticks and self.index < self.max_len:
            self.step()
            ticks += 1
        return self.done
