"""Serve a small LM with batched requests through the continuous-batching
engine on the PyTorch/CUDA port (more requests than batch slots; slots
refill as requests finish) — the twin of ``examples/serve_lm.py``.

Run:  python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import tree
from repro_torch.cnn_training import set_full_precision
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.device import resolve_device
from repro_torch.models.transformer import lm_init
from repro_torch.serving.engine import GenRequest, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_full_precision()
    cfg = SMOKE_ARCHS["smollm-360m"]
    # Drawn on the CPU, then moved: every device serves the same weights.
    params = tree.tree_map(lambda t: t.to(dev),
                           lm_init(0, cfg, dtype=torch.float32,
                                   device="cpu"))
    engine = ServeEngine(cfg, params, batch_slots=4, max_len=128)

    prompts = [[1 + i, 7, 3, 11] for i in range(10)]
    t0 = time.time()
    for rid, p in enumerate(prompts):
        engine.submit(GenRequest(rid, p, max_tokens=16))
    done = engine.run()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in done.values())
    for rid in sorted(done):
        print(f"req {rid}: {done[rid][:8]}…")
    print(f"\nserved {len(done)} requests / {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s, "
          f"{engine.index} engine ticks, 4 slots)")
    return {"done": done, "seconds": dt, "ticks": engine.index}


if __name__ == "__main__":
    main()
