"""End-to-end run on the PyTorch/CUDA port: train a ~100M-param LM on the
deterministic synthetic token stream, with checkpoint/restart fault
tolerance and the straggler detector live (the twin of
``examples/train_lm.py``).

The config is a 12L/768d/12H GQA transformer (~90M params incl. tied
embeddings).  Optionally (--sparse-ffn) the FFN uses squared-ReLU routed
through the paper's sparse-backprop units (the loss curve is unchanged:
the op is exact).

Run:  python examples/torch_train_lm.py --steps 300 [--device cpu]
Resume after a kill: the same command — it restarts from the last
checkpoint under --ckpt-dir (default ``build/lm100m_ckpt`` in the checkout).
"""
import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models.transformer import lm_init

LM100M = ModelConfig(
    name="lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=16384,
    ffn_activation="silu_glu",
    tie_embeddings=True,
    dtype="float32",
    q_chunk=128,
    kv_chunk=128,
)


def main(argv=None, *, stop_after=None) -> dict:
    """Train as the flags say.  ``stop_after`` (not a flag) ends this
    process's run after that many steps, with the checkpoint a run killed
    just after its save at that step leaves behind; the same command then
    resumes from it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "lm100m_ckpt"))
    ap.add_argument("--sparse-ffn", action="store_true",
                    help="squared-ReLU FFN through the sparse-bwd units")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LM100M
    if args.sparse_ffn:
        cfg = cfg.with_(ffn_activation="relu2", sparse_ffn_scenario="IN_OUT")
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=20, total_steps=args.steps,
        microbatches=args.microbatches, checkpoint_every=50,
        keep_checkpoints=2)

    n_params = sum(x.numel() for x in tree.leaves(
        lm_init(0, cfg, device="meta")))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  "
          f"ffn={cfg.ffn_activation}")
    steps = args.steps if stop_after is None else min(stop_after, args.steps)
    out = train_loop(cfg, tcfg, batch_size=args.batch, seq_len=args.seq,
                     steps=steps, ckpt_dir=args.ckpt_dir, resume=True,
                     device=dev)
    losses = out["losses"]
    first, last = losses[:10], losses[-10:]
    print(f"first-10 mean loss {sum(first)/max(len(first), 1):.4f} → "
          f"last-10 mean {sum(last)/max(len(last), 1):.4f}  "
          f"(resumed_from={out['resumed_from']}, "
          f"stragglers={len(out['straggler'].flags)})")
    return out


if __name__ == "__main__":
    main()
