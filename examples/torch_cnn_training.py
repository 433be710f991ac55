"""Train one of the paper's five CNNs with sparse backprop on the PyTorch/
CUDA port and report the trace-driven accelerator cost model per scenario
(the twin of ``examples/cnn_training.py``: real training → real traces →
cycle model).

Run:  python examples/torch_cnn_training.py [--net vgg16] [--steps 5] \\
          [--kernel-impl pallas] [--device cpu]

The cost model's cycles are MODELED for the paper's accelerator (Table 1,
667 MHz), never times on the device the traces were captured on.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.benchmarks.common import Capture, network_totals
from repro_torch.cnn_training import train_steps
from repro_torch.device import resolve_device
from repro_torch.models.cnn import NETWORKS

SCENARIOS = ("DC", "IN", "IN_OUT", "IN_OUT_WR")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="vgg16", choices=list(NETWORKS))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--kernel-impl", default="xla_ref",
                    choices=["xla_ref", "pallas"])
    ap.add_argument("--queue-builder", default="prefix_sum",
                    choices=["prefix_sum", "argsort"],
                    help="compact-queue construction on the pallas impl: "
                         "on-device prefix-sum compaction (default) or the "
                         "argsort reference")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"training {args.net} with IN+OUT+WR sparse backprop…")
    run = train_steps(net=args.net, steps=args.steps,
                      image_size=args.image_size, width=args.width,
                      num_classes=100, batch=8, policy="IN_OUT_WR",
                      kernel_impl=args.kernel_impl,
                      builder=args.queue_builder, lr=0.05, device=dev)
    losses = [rec["loss"] for rec in run["steps"]]
    for i, loss in enumerate(losses):
        print(f"  step {i}: loss {loss:.4f}")

    print("\naccelerator cost model (full ImageNet geometry, batch 16):")
    totals = network_totals(args.net, Capture(device=str(dev)))
    dc = totals["DC"]["total_cycles"]
    for sc in SCENARIOS:
        t = totals[sc]
        print(f"  {sc:10s}  {t['iteration_ms']:9.2f} ms/iter   "
              f"speedup {dc / t['total_cycles']:.2f}x   "
              f"energy {t['total_energy_j']:.2f} J")
    return {"losses": losses, "totals": totals, "steps": run["steps"]}


if __name__ == "__main__":
    main()
