"""Serving entry point: batched decode over a (smoke or full) arch — the
port of ``repro.launch.serve``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve [--arch NAME]
          [--requests 8] [--slots 4] [--max-tokens 12] [--device cuda]

As in the reference, ``--smoke`` is on whatever the command line says
(``store_true`` with ``default=True``), so the CLI serves the SMOKE
configs; full-width serving goes through ``serving.ServeEngine``.  Params
are f32, drawn from seed 0; prompts of 6 tokens from a ``torch.Generator``
seeded with 1.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, SMOKE_ARCHS
from repro_torch.device import resolve_device
from repro_torch.models.transformer import lm_init
from repro_torch.serving.engine import GenRequest, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    params = lm_init(0, cfg, dtype=torch.float32, device=dev)
    engine = ServeEngine(cfg, params, batch_slots=args.slots, max_len=256)
    gen = torch.Generator().manual_seed(1)
    for rid in range(args.requests):
        prompt = torch.randint(0, cfg.vocab_size, (6,), generator=gen)
        engine.submit(GenRequest(rid, prompt.tolist(),
                                 max_tokens=args.max_tokens))
    done = engine.run()
    for rid in sorted(done):
        print(f"req {rid}: {done[rid]}")
    print(f"served {len(done)}/{args.requests} requests "
          f"in {engine.index} engine ticks on {dev}")


if __name__ == "__main__":
    main()
