"""Train one of the paper's CNNs with sparse backprop on the port (the twin
of ``examples/cnn_training.py``, without the cost-model table).

Run:
  PYTHONPATH=src python -m repro_torch.cnn_training --net vgg16 --steps 3 \\
      --image-size 224 --width 1.0 --num-classes 1000 --batch 8 \\
      --kernel-impl pallas [--policy IN_OUT_WR|IN_OUT] [--lr 0.01] \\
      [--device cuda]
  PYTHONPATH=src python -m repro_torch.cnn_training --net mobilenet \\
      --scan-signed-inputs

``train_steps`` is the library entry point; it runs on CUDA unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.core.policy import DC, SCENARIOS
from repro_torch.data.pipeline import image_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune, launch_counts, stats
from repro_torch.models.cnn import NETWORKS, build_cnn, param_leaves


def set_full_precision() -> None:
    """Keep TF32 off for every plain float32 product (the dense schedule and
    the plain versions), so they compute in full float32 as the kernels do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _delta(after: dict, before: dict) -> dict:
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


def _relu_live(model, params, img) -> dict:
    """Per conv layer, the share of positive ReLU outputs (dense forward)."""
    caps = {}
    with torch.no_grad():
        model.apply(params, img, DC, capture=caps)
    return {name: float(torch.count_nonzero(v)) / v.numel()
            for name, v in caps.items()}


def train_steps(*, net: str = "vgg16", steps: int = 3, image_size: int = 224,
                width: float = 1.0, num_classes: int = 1000, batch: int = 8,
                policy: str = "IN_OUT_WR", kernel_impl: str = "pallas",
                builder: str = "prefix_sum", lr: float = 0.01,
                scan_signed_inputs: bool = False, autotune_gemms: bool = False,
                seed: int = 0, device="cuda", params: Optional[dict] = None,
                keep_first_grads: bool = False,
                relu_live: bool = False) -> dict:
    """Run ``steps`` SGD steps (batch ``step`` of ``image_batch(seed, ...)``
    at each) and return ``{"model", "params", "steps", "first_grads"}``.

    ``builder`` is the compact-queue builder (``"prefix_sum"`` or
    ``"argsort"``); ``scan_signed_inputs`` sets the policy field of that
    name (a ``bitmap_scan`` of the signed image and head input);
    ``autotune_gemms`` sets ``autotune`` (the GEMM schedules and tiles from
    the autotune cache, whose device-side telemetry is folded once a step,
    ``kernels.autotune.fold_pending``).
    ``params`` (updated in place) defaults to ``model.init(seed)``.  Each entry of ``steps`` holds the step's
    ``loss``, wall ``seconds`` (ended by a device synchronize), and the
    ``counts``/``launches`` it added to ``kernels.stats`` and the kernel
    launch counters, and ``elided``: the counted keys whose dispatch ran
    nothing (``stats.elided``; the first conv's dX, as the image requires
    no gradient).  With ``keep_first_grads`` the first step's gradients
    are returned too.  With ``relu_live`` each entry also holds
    ``relu_live``: per conv layer, the fraction of its ReLU outputs that
    are positive at the step's weights and batch, read by a dense forward
    outside the timed and counted region.  The default ``lr`` is the
    VGG paper's (Simonyan & Zisserman 2015, SGD at 0.01)."""
    dev = resolve_device(device)
    set_full_precision()
    model = build_cnn(net, image_size=image_size, width=width,
                      num_classes=num_classes)
    if params is None:
        params = model.init(seed, device=dev)
    pol = SCENARIOS[policy].with_(kernel_impl=kernel_impl,
                                  queue_builder=builder,
                                  scan_signed_inputs=scan_signed_inputs,
                                  autotune=autotune_gemms)
    leaves = param_leaves(params)
    records = []
    first_grads = None
    for i in range(steps):
        img, labels = image_batch(seed, i, batch=batch,
                                  image_size=image_size,
                                  num_classes=num_classes, device=dev)
        live = _relu_live(model, params, img) if relu_live else None
        c0, e0, l0 = stats.counts(), stats.elided(), launch_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = model.loss(params, img, labels, pol)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for p, g in zip(leaves.values(), grads):
                p.sub_(lr * g)
        loss_v = float(loss.detach())
        autotune.fold_pending()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        if keep_first_grads and i == 0:
            first_grads = dict(zip(leaves, grads))
        records.append({"loss": loss_v, "seconds": seconds,
                        "counts": _delta(stats.counts(), c0),
                        "elided": _delta(stats.elided(), e0),
                        "launches": _delta(launch_counts(), l0)})
        if live is not None:
            records[-1]["relu_live"] = live
    return {"model": model, "params": params, "steps": records,
            "first_grads": first_grads}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="vgg16", choices=list(NETWORKS))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kernel-impl", default="pallas",
                    choices=["xla_ref", "pallas"])
    ap.add_argument("--policy", default="IN_OUT_WR", choices=list(SCENARIOS))
    ap.add_argument("--queue-builder", default="prefix_sum",
                    choices=["prefix_sum", "argsort"])
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--scan-signed-inputs", action="store_true",
                    help="scan the signed image and head input for a "
                         "bitmap (SparsityPolicy.scan_signed_inputs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"training {args.net} under {args.policy} "
          f"({args.kernel_impl}) on {args.device}")
    run = train_steps(net=args.net, steps=args.steps,
                      image_size=args.image_size, width=args.width,
                      num_classes=args.num_classes, batch=args.batch,
                      policy=args.policy, kernel_impl=args.kernel_impl,
                      builder=args.queue_builder, lr=args.lr,
                      scan_signed_inputs=args.scan_signed_inputs,
                      device=args.device, relu_live=True)
    for i, rec in enumerate(run["steps"]):
        print(f"  step {i}: loss {rec['loss']:.4f}  "
              f"{rec['seconds'] * 1e3:.1f} ms  launches {rec['launches']}")
        live = " ".join(f"{k} {v:.3f}" for k, v in rec["relu_live"].items())
        print(f"    ReLU live fraction: {live}")


if __name__ == "__main__":
    main()
