"""Where a training step's time goes on the card: one profiled step.

Run on a machine with a CUDA device:
  PYTHONPATH=src python -m repro_torch.profile_step [--net vgg16]
      [--policy IN_OUT_WR] [--scan-signed-inputs] [--image-size 224]
      [--width 1.0] [--batch 8] [--trace out.json]
  PYTHONPATH=src python -m repro_torch.profile_step --arch smollm-360m
      [--batch 8] [--seq 128]

``--arch`` profiles the LM trainer's step instead (``launch/steps``: loss,
gradients and AdamW, f32, random weights), its device time keyed
``forward`` and ``adamw`` by the step's ranges and the backward pass,
launched from autograd's threads, as ``(no layer)``.

Runs two warm-up steps, then one step under ``torch.profiler`` (CPU and
CUDA activities), and prints: the step's wall time, the summed device time
of its kernels and copies and the resulting device-idle share, device time
by kernel name, and device time by model layer.  A kernel belongs to the
innermost ``layer:<name>`` range open on the host thread that launched it
(``models/cnn.py`` opens one around each layer's forward, and the autograd
Functions reopen it around the layer's backward).  ``--trace`` keeps the
chrome trace the summary is read from.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import tempfile
import time

import torch

from repro_torch.cnn_training import set_full_precision, train_steps
from repro_torch.core.policy import SCENARIOS
from repro_torch.data.pipeline import image_batch
from repro_torch.device import resolve_device
from repro_torch.models.cnn import NETWORKS, param_leaves

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# The device functions of csrc/masked_matmul.cu.
_GEMM_KERNELS = ("masked_gemm_kernel", "group_rows_kernel", "group_k_kernel",
                 "queue_member_kernel", "splitk_reduce_kernel",
                 "emit_nan_fixup_kernel")
# The device function of csrc/cell_encode.cuh (K1: encode_kernel<true, ...>,
# K5: encode_kernel<false, ...>; the second argument is the path).
_ENCODER_KERNELS = ("encode_kernel",)
_PORT_KERNELS = _GEMM_KERNELS + _ENCODER_KERNELS + ("queue_builder_kernel",)


def summarize_trace(events: list) -> dict:
    """Device time by kernel name and by layer from chrome-trace events.

    Returns ``{"busy_ms", "kernels": [(name, ms, calls)], "layers":
    [(layer, ms)], "longest": [(name, layer, ms, grid)], "in_order": [...]}``,
    each list longest first but ``in_order``, which holds the same launches
    as ``longest`` in device order; work launched outside every layer range
    is keyed ``"(no layer)"``."""
    launches = {}
    ranges = collections.defaultdict(list)
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat == "user_annotation" and e["name"].startswith("layer:"):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {}
    for tid, rs in ranges.items():
        rs.sort()
        starts[tid] = [r[0] for r in rs]

    def layer_of(tid, ts):
        rs = ranges.get(tid, [])
        best = None
        for lo, hi, name in rs[:bisect.bisect_right(starts.get(tid, []), ts)]:
            if lo <= ts <= hi and (best is None or lo >= best[0]):
                best = (lo, name)
        return best[1][len("layer:"):] if best else "(no layer)"

    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    by_layer = collections.defaultdict(float)
    launched = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        ms = e["dur"] / 1e3
        by_kernel[e["name"]][0] += ms
        by_kernel[e["name"]][1] += 1
        args = e.get("args", {})
        launch = launches.get(args.get("correlation"))
        layer = layer_of(*launch) if launch else "(no layer)"
        by_layer[layer] += ms
        launched.append((e["ts"], e["name"], layer, ms, args.get("grid")))
    kernels = sorted(((k, v[0], v[1]) for k, v in by_kernel.items()),
                     key=lambda r: -r[1])
    return {"busy_ms": sum(r[1] for r in kernels), "kernels": kernels,
            "layers": sorted(by_layer.items(), key=lambda r: -r[1]),
            "longest": [r[1:] for r in sorted(launched,
                                              key=lambda r: -r[3])],
            "in_order": [r[1:] for r in sorted(launched)]}


def profile_step(*, net="vgg16", policy="IN_OUT_WR",
                 scan_signed_inputs=False, image_size=224, width=1.0,
                 num_classes=1000, batch=8, device="cuda", trace=None):
    """Profile one step after two warm-up steps; returns a summary dict."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    set_full_precision()
    geom = dict(net=net, image_size=image_size, width=width,
                num_classes=num_classes, batch=batch, device=dev)
    run = train_steps(steps=2, policy=policy,
                      scan_signed_inputs=scan_signed_inputs, **geom)
    model, params = run["model"], run["params"]
    pol = SCENARIOS[policy].with_(kernel_impl="pallas",
                                  scan_signed_inputs=scan_signed_inputs)
    img, labels = image_batch(0, 2, batch=batch, image_size=image_size,
                              num_classes=num_classes, device=dev)
    leaves = list(param_leaves(params).values())
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = model.loss(params, img, labels, pol)
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            res = summarize_trace(json.load(f)["traceEvents"])
    res["wall_ms"] = wall_ms
    res["idle_share"] = max(0.0, 1.0 - res["busy_ms"] / wall_ms)
    return res


def profile_lm_step(*, arch="smollm-360m", batch=8, seq=128,
                    device="cuda", trace=None):
    """Profile one LM train step (``launch/steps.make_train_step``, AdamW)
    after two warm-up steps; returns a summary dict as ``profile_step``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import optimizer

    dev = resolve_device(device)
    set_full_precision()
    cfg = ARCHS[arch]
    ocfg = optimizer.OptConfig()
    params = transformer.lm_init(0, cfg, dtype=torch.float32, device=dev)
    opt = optimizer.adamw_init(params)
    step_fn = steps.make_train_step(cfg, ocfg)

    for i in range(2):
        params, opt, _ = step_fn(params, opt, lm_batch(
            0, i, batch=batch, seq_len=seq, vocab=cfg.vocab_size,
            device=dev))
    b = lm_batch(0, 2, batch=batch, seq_len=seq, vocab=cfg.vocab_size,
                 device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, b)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            res = summarize_trace(json.load(f)["traceEvents"])
    res["wall_ms"] = wall_ms
    res["idle_share"] = max(0.0, 1.0 - res["busy_ms"] / wall_ms)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="profile the LM trainer's step of this config "
                         "(repro_torch.configs.ARCHS) instead of a CNN's")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--net", default="vgg16", choices=list(NETWORKS))
    ap.add_argument("--policy", default="IN_OUT_WR", choices=list(SCENARIOS))
    ap.add_argument("--scan-signed-inputs", action="store_true")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if args.arch:
        res = profile_lm_step(arch=args.arch, batch=args.batch,
                              seq=args.seq, trace=args.trace)
    else:
        res = profile_step(net=args.net, policy=args.policy,
                           scan_signed_inputs=args.scan_signed_inputs,
                           image_size=args.image_size,
                           width=args.width, num_classes=args.num_classes,
                           batch=args.batch, trace=args.trace)
    print(f"step wall {res['wall_ms']:.1f} ms under the profiler; device "
          f"busy {res['busy_ms']:.1f} ms; idle share "
          f"{res['idle_share']:.3f}")
    print("device time by kernel (ms, calls; the 25 longest and every "
          "kernel of the port):")
    for k, (name, ms, n) in enumerate(res["kernels"]):
        if k < 25 or _short_name(name) in _PORT_KERNELS:
            print(f"  {ms:10.3f}  {n:5d}  {name[:110]}")
    print("device time by layer, forward + backward (ms):")
    for name, ms in res["layers"]:
        print(f"  {ms:10.3f}  {name}")
    print("longest launches (ms, layer, grid):")
    for name, layer, ms, grid in res["longest"][:10]:
        print(f"  {ms:10.3f}  {layer:10s}  {grid}  {name[:80]}")
    for what, names in (
            ("masked GEMM launches in device order (ms, layer, grid); per "
             "layer FP, then dX and WG, a split launch followed by its "
             "reduce:", _GEMM_KERNELS),
            ("cell-bitmap encoder launches in device order (ms, layer, "
             "grid):", _ENCODER_KERNELS)):
        print(what)
        for name, layer, ms, grid in res["in_order"]:
            short = re.search(r"(\w+)(<[^>]*>)?\(", name)
            if short and short.group(1) in names:
                print(f"  {ms:10.3f}  {layer:10s}  {str(grid):16s}  "
                      f"{short.group(0)[:-1]}")


def _short_name(name: str) -> str:
    """A kernel's function name without its namespace and arguments."""
    short = re.search(r"(\w+)(<[^>]*>)?\(", name)
    return short.group(1) if short else name


if __name__ == "__main__":
    main()
