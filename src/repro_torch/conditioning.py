"""How well an LM's first step is conditioned: how far a float64 step moves
when its params move by one f32 rounding, beside how far the f32 step lies
from the float64 step.

An f32 step rounds every op, so where a random-weight stack amplifies
small perturbations (xlstm-350m at full depth), its distance from float64
grows with depth whatever the code's correctness; the float64 steps from
params each moved by a factor (1 ± 2^-24), signs from a seeded generator,
measure that amplification without f32 arithmetic.  ``chip_smoke.py``
phase 9 holds xlstm-350m's full-depth f32 step to a multiple of this
spread, leaf by leaf.

  PYTHONPATH=src python -m repro_torch.conditioning --arch xlstm-350m \\
      --d-model 256 --vocab 512 --seq 512 --batch 2 --device cpu

prints the worst leaves of the f32 step's and of each moved float64 step's
relative L2 distance from the float64 step, and the largest ratio, leaf by
leaf, of the first to the farthest of the second.
"""
from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.models import common


def lm_grads(cfg, params, batch, dtype):
    """(loss, gradient leaves) of ``lm_loss`` at ``params`` cast to
    ``dtype``, every upcast at ``dtype``."""
    from repro_torch.models.transformer import lm_loss
    leaves = [x.detach().to(dtype).requires_grad_(True)
              for x in tree.leaves(params)]
    with common.upcast(dtype):
        loss = lm_loss(tree.unflatten_like(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def leaf_rels(grads, g64) -> List[float]:
    """Each gradient leaf's relative L2 distance from float64's."""
    return [float((a.double() - b).norm() / b.norm().clamp_min(1e-300))
            for a, b in zip(grads, g64)]


def moved_by_one_rounding(params, seed: int):
    """float64 copies of ``params``, each element times 1 ± 2^-24."""
    gen = torch.Generator(device=tree.leaves(params)[0].device)
    gen.manual_seed(seed)
    return tree.tree_map(lambda x: x.double() * (1 + 2.0 ** -24 * (
        2 * torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                          dtype=torch.float64) - 1)), params)


def rounding_spreads(cfg, params, batch, g64, draws: int = 2,
                     seed: int = 100) -> List[List[float]]:
    """For each of ``draws`` float64 steps from params moved by one f32
    rounding (seeds ``seed``, ``seed + 1``, ...), each leaf's relative L2
    distance from ``g64``."""
    out = []
    for draw in range(draws):
        _, g = lm_grads(cfg, moved_by_one_rounding(params, seed + draw),
                        batch, torch.float64)
        out.append(leaf_rels(g, g64))
        del g
    return out


def main(argv=None) -> None:
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import lm_init

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--draws", type=int, default=2)
    ap.add_argument("--seed", type=int, default=100,
                    help="the first draw's generator seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    cut = {k: v for k, v in (("n_layers", args.n_layers),
                             ("d_model", args.d_model),
                             ("vocab_size", args.vocab)) if v}
    cfg = cfg.with_(**cut)
    params = lm_init(0, cfg, dtype=torch.float32, device=dev)
    batch = lm_batch(0, 0, batch=args.batch, seq_len=args.seq,
                     vocab=cfg.vocab_size, device=dev)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    _, g32 = lm_grads(cfg, params, batch, torch.float32)
    _, g64 = lm_grads(cfg, params, batch, torch.float64)
    r32 = leaf_rels(g32, g64)
    spreads = rounding_spreads(cfg, params, batch, g64, args.draws,
                               args.seed)
    far = [max(s) for s in zip(*spreads)]

    def worst(rels):
        i = max(range(len(rels)), key=rels.__getitem__)
        return f"{rels[i]:.3e} ({paths[i]})"
    print(f"{cfg.name} {cut or 'uncut'}, {args.batch} x {args.seq} on "
          f"{dev}: f32 step vs float64, worst leaf {worst(r32)}")
    for d, s in enumerate(spreads):
        print(f"  float64 step from params one f32 rounding off (seed "
              f"{args.seed + d}) vs float64, worst leaf {worst(s)}")
    ratio = [a / b for a, b in zip(r32, far)]
    print(f"  per leaf, the f32 step's distance over the farthest draw's: "
          f"at most {worst(ratio)}")


if __name__ == "__main__":
    main()
