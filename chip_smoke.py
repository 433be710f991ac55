#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure makes the exit code nonzero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels under src/repro_torch/csrc, built with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the VGG16 training step gives it, with its time, its plain
     version's time, a one-call PyTorch yardstick and its lower bound;
  4. end to end at full width (VGG16, 224x224, width 1.0, 1000 classes,
     batch 8): three IN_OUT_WR SGD steps and one IN_OUT step through
     ``repro_torch.cnn_training.train_steps``, with the launch counters
     reset just before and read just after; each step's ReLU live fraction
     per layer; the first step's loss and gradients against the same step
     on the dense ``xla_ref`` schedule, with the ReLU sign flips between the
     two forwards counted and bounded; the per-step count contract.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
KERNEL_RTOL = 1e-4             # max|kernel - plain| <= KERNEL_RTOL * max|plain|
# The full-width step against the dense xla_ref step, per gradient leaf as
# max|Δ| <= rtol * max|g|.  The two forwards sum in different orders, so a
# few pre-activations within f32 rounding of 0 take the other side of the
# ReLU.  Such σ′ flips must stay rare (FLIP_SHARE of the activations).
# Each changes one of the ~10^5 terms of every weight-gradient entry of
# its layer and the layers below it, which are held to STEP_RTOL_FLIPPED;
# the leaves above the highest flipped layer see no flip and are held to
# KERNEL_RTOL.
FLIP_SHARE = 1e-6
STEP_RTOL_FLIPPED = 5e-3
# SGD losses may wander with the batch but not blow up: each step's loss
# stays within LOSS_GROWTH times the first.
LOSS_GROWTH = 2.0

FAILURES = []


def check(ok, what):
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def time_ms(fn, reps=7, warmup=2):
    """Median CUDA-event time of ``fn`` over ``reps`` calls, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want):
    """(max|got - want|, that over max|want|, within KERNEL_RTOL)."""
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    return err, rel, rel <= KERNEL_RTOL


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_traffic(shape, block, out_mask, a_mask, b_mask, mult, bits):
    """(FLOPs, bytes) that these masks leave a masked GEMM.

    FLOPs: 2 * rows * cols * (live k length) over the live output tiles.
    Bytes, each needed input read once and each output written once: an A
    block (i, k) where a_mask[i, k] and some live output tile (i, j) has
    b_mask[k, j]; a B block (k, j) likewise; mult over the live output
    tiles; the whole output and the whole emitted bitmap."""
    import torch
    g, m, k, n = shape
    bm, bk, bn = block
    dev = (out_mask if out_mask is not None else a_mask).device

    def edges(d, e):
        nb = -(-d // e)
        idx = torch.arange(nb, device=dev, dtype=torch.float64)
        return torch.clamp(d - idx * e, max=e)

    rows, klen, cols = edges(m, bm), edges(k, bk), edges(n, bn)
    ni, nk, nj = rows.numel(), klen.numel(), cols.numel()

    def mask(x, gi, r, c):
        return torch.ones(r, c, device=dev, dtype=torch.float64) \
            if x is None else x[gi].double()

    flops = read = 0.0
    for gi in range(g):
        om, am = mask(out_mask, gi, ni, nj), mask(a_mask, gi, ni, nk)
        bmk = mask(b_mask, gi, nk, nj)
        flops += float((om * ((am * klen[None, :]) @ bmk)
                        * rows[:, None] * cols[None, :]).sum())
        a_need = am * ((om @ bmk.t()) > 0)
        b_need = bmk * ((am.t() @ om) > 0)
        read += float((a_need * rows[:, None] * klen[None, :]).sum())
        read += float((b_need * klen[:, None] * cols[None, :]).sum())
        if mult is not None:
            read += float((om * rows[:, None] * cols[None, :]).sum())
    written = g * m * n + (0 if bits is None else bits.numel())
    return 2.0 * flops, 4.0 * (read + written)


def kernel_phase(dev):
    import torch
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import queue_builder as qb
    from repro_torch.kernels import relu_encode as re_
    from repro_torch.kernels import shapes

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, case, err, ok, ms, plain_ms, library_ms, bytes_, ops,
               rel=None):
        bound_b = bytes_ / HBM_BYTES_PER_S * 1e3
        bound_o = ops / F32_FLOP_PER_S * 1e3
        bound = max(bound_b, bound_o)
        line = {"kernel": name, "case": case, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "gflop": ops / 1e9, "bound_ms": bound,
                "bound_by": "bytes" if bound_b >= bound_o else "operations"}
        if rel is not None:
            line["rel_err"] = rel
        print("kernel " + json.dumps(line), flush=True)
        check(ok, f"{name} {case} matches its plain version")
        if name not in rows:           # the first case is the main one
            rows[name] = line
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    # K1 relu_encode: conv2's and conv4's inputs (gran (1, 64), (1, 128)).
    for case, (m, n, gran) in (("conv2 input", (401408, 64, (1, 64))),
                               ("conv4 input", (100352, 128, (1, 128)))):
        z = torch.randn(m, n, device=dev, generator=gen)
        y, bits = re_.relu_encode(z, gran)
        yp, bp = re_.relu_encode_plain(z, gran)
        ok = torch.equal(y, yp) and torch.equal(bits, bp)
        err = float((y - yp).abs().max())
        nbits = bits.numel()
        report("relu_encode", case, err, ok,
               time_ms(lambda: re_.relu_encode(z, gran)),
               time_ms(lambda: re_.relu_encode_plain(z, gran)),
               time_ms(lambda: torch.relu(z)),
               8.0 * m * n + 4.0 * nbits, 0.0)

    # K2 queue builder: the conv2 dX tile bitmap (3136 x 1) and a (784 x 4)
    # one, at full capacity and at a capacity below n_live.
    for shape in ((3136, 1), (784, 4)):
        bm = (torch.rand(shape, device=dev, generator=gen) < 0.5) \
            .to(torch.int32)
        n_live = int(bm.sum())
        for cap in (bm.numel(), n_live // 2):
            got = qb.build_queue_kernel(bm, capacity=cap)
            want = qb.build_queue_plain(bm, cap)
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            report("queue_builder", f"{shape[0]}x{shape[1]} cap {cap}",
                   0.0 if ok else 1.0, ok,
                   time_ms(lambda: qb.build_queue_kernel(bm, capacity=cap)),
                   time_ms(lambda: qb.build_queue_plain(bm, cap)),
                   time_ms(lambda: torch.nonzero(bm)),
                   4.0 * bm.numel() + 8.0 * cap + 4.0, 0.0)

    def gemm_case(g, m, k, n, block, live=0.5, sigma=True, a_t=False,
                  b_mask=True, out_mask=True):
        ni, nk, nj = shapes.grid_shape((m, k, n), block)
        if a_t:   # WG: A = patches^T, a strided view of (K, M) patches
            a = torch.randn(g, k, m, device=dev, generator=gen) \
                .transpose(1, 2)
        else:
            a = torch.randn(g, m, k, device=dev, generator=gen)
        b = torch.randn(g, k, n, device=dev, generator=gen)

        def rand_mask(*s):
            return (torch.rand(s, device=dev, generator=gen) < live) \
                .to(torch.int32)
        om = rand_mask(g, ni, nj) if out_mask else None
        am = rand_mask(g, ni, nk)
        bmk = rand_mask(g, nk, nj) if b_mask else None
        mult = None
        if sigma:
            mult = (torch.rand(g, m, n, device=dev, generator=gen) < 0.5) \
                .to(torch.float32)
        return a, b, om, am, bmk, mult

    def run_gemm(name, case, g, m, k, n, block, emit, **kw):
        a, b, om, am, bmk, mult = gemm_case(g, m, k, n, block, **kw)
        ni, _, nj = shapes.grid_shape((m, k, n), block)
        qmask = om if om is not None else torch.ones(
            g, ni, nj, dtype=torch.int32, device=dev)
        flat = qmask.reshape(g * ni, nj).contiguous()
        n_live = int(flat.sum())
        plain_out = torch.zeros(g, m, n, device=dev)
        plain_bits = None if emit is None else torch.zeros(
            g, -(-m // emit[0]), -(-n // emit[1]), dtype=torch.int32,
            device=dev)

        def plain():
            return mm.grouped_masked_matmul_plain(
                a, b, om, am, bmk, block=block, epilogue_mult=mult,
                emit_gran=emit, out=plain_out, bits=plain_bits)
        want, want_bits = plain()

        def predicated():
            return mm.grouped_masked_matmul_kernel(
                a, b, om, am, bmk, block=block, epilogue_mult=mult,
                emit_gran=emit)

        queues = {cap: qb.build_queue_kernel(flat, capacity=cap)
                  for cap in (flat.numel(), max(n_live // 2, 1))}

        def compact(cap):
            # K3 alone on a prebuilt queue; below n_live the overflow
            # fallback K4 runs too (and K3 exits on the device).
            fi, jj, nl = queues[cap]
            out, bits = mm.grouped_compact_masked_matmul_kernel(
                a, b, fi, jj, nl, am, bmk, block=block, epilogue_mult=mult,
                emit_gran=emit)
            if cap < flat.numel():
                out, bits = mm.grouped_masked_matmul_kernel(
                    a, b, qmask, am, bmk, block=block, epilogue_mult=mult,
                    emit_gran=emit, out=out, bits=bits, n_live=nl,
                    capacity=cap)
            return out, bits

        flops, bytes_ = gemm_traffic((g, m, k, n), block, om, am, bmk, mult,
                                     want_bits)
        lib_ms = time_ms(lambda: torch.matmul(a, b))
        plain_ms = time_ms(plain)
        variants = [("compact_gemm", lambda: compact(flat.numel()), ""),
                    ("compact_gemm", lambda: compact(max(n_live // 2, 1)),
                     " overflow->predicated")]
        if om is not None:
            variants.append(("predicated_gemm", predicated, ""))
        for kname, fn, tag in variants:
            if name and kname != name:
                continue
            got, got_bits = fn()
            torch.cuda.synchronize()
            err, rel, ok = rel_err(got, want)
            if emit is not None:
                ok = ok and torch.equal(got_bits, want_bits)
            ok = ok and torch.equal(got == 0, want == 0) if om is not None \
                else ok
            report(kname, case + tag, err, ok, time_ms(fn), plain_ms, lib_ms,
                   bytes_, flops, rel)

    # K3/K4: conv4's dX GEMM (sigma-prime + bitmap emit, ~50% live masks),
    # a conv4-shaped WG GEMM (A = patches^T through strides), and a ragged
    # small case with block (8, 16, 8).
    run_gemm("", "conv4 dX 100352x1152x128", 1, 100352, 1152, 128,
             (128, 128, 128), (1, 128), b_mask=False)
    run_gemm("compact_gemm", "conv4 WG 1152x100352x128", 1, 1152, 100352,
             128, (128, 128, 128), None, sigma=False, a_t=True,
             out_mask=False)
    run_gemm("", "ragged 2x333x250x77 block 8x16x8", 2, 333, 250, 77,
             (8, 16, 8), (2, 4))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: end to end
# ---------------------------------------------------------------------------

def clone_params(params):
    return {layer: {k: v.detach().clone().requires_grad_(True)
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


def step_contract(rec, scenario, tag):
    c, launches = rec["counts"], rec["launches"]
    check(math.isfinite(rec["loss"]), f"{tag}: loss {rec['loss']} finite")
    check(c.get("encode:act") == 8, f"{tag}: encode:act == 8 ({c})")
    check(c.get("emit:grad", 0) >= 1, f"{tag}: emit:grad >= 1")
    check(c.get("registry:hit") == 8, f"{tag}: registry:hit == 8")
    check(not any(k.startswith("scan") for k in c), f"{tag}: no scan:*")
    check(launches.get("relu_encode", 0) == c.get("encode:act", 0),
          f"{tag}: relu_encode launches == encode:act ({launches})")
    check(launches.get("queue_builder", 0) == c.get("queue:prefix_sum", 0),
          f"{tag}: queue_builder launches == queue:prefix_sum")
    check(launches.get("compact_gemm", 0) == c.get("gemm:compact:1", 0),
          f"{tag}: compact_gemm launches == gemm:compact:1")
    check(launches.get("predicated_gemm", 0)
          == c.get("gemm:predicated:1", 0),
          f"{tag}: predicated_gemm launches == gemm:predicated:1")
    if scenario == "IN_OUT_WR":
        check(c.get("queue:prefix_sum", 0) == c.get("gemm:compact:1", -1)
              > 0, f"{tag}: queue:prefix_sum == gemm:compact:1")
    else:
        check(c.get("gemm:predicated:1", 0) > 0,
              f"{tag}: predicated GEMMs dispatched")


def end_to_end(dev, image_size=224, width=1.0, num_classes=1000, batch=8):
    import torch
    from repro_torch import kernels
    from repro_torch.cnn_training import train_steps
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn, param_leaves

    geom = dict(net="vgg16", image_size=image_size, width=width,
                num_classes=num_classes, batch=batch, device=dev)
    model = build_cnn("vgg16", image_size=image_size, width=width,
                      num_classes=num_classes)
    params = model.init(0, device=dev)
    init = clone_params(params)
    io_params = clone_params(params)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # The main path: every launch counter is 0 just before, read just after.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    wr = train_steps(steps=3, policy="IN_OUT_WR", kernel_impl="pallas",
                     params=params, keep_first_grads=True, relu_live=True,
                     **geom)
    io = train_steps(steps=1, policy="IN_OUT", kernel_impl="pallas",
                     params=io_params, **geom)
    main_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0

    for i, rec in enumerate(wr["steps"]):
        print(f"IN_OUT_WR step {i}: loss {rec['loss']:.6f} "
              f"{rec['seconds'] * 1e3:.1f} ms counts {rec['counts']} "
              f"launches {rec['launches']}", flush=True)
        print(f"IN_OUT_WR step {i} ReLU live fraction: " + json.dumps(
            {k: round(v, 4) for k, v in rec["relu_live"].items()}),
              flush=True)
        step_contract(rec, "IN_OUT_WR", f"IN_OUT_WR step {i}")
        loss0 = wr["steps"][0]["loss"]
        check(rec["loss"] <= LOSS_GROWTH * loss0,
              f"IN_OUT_WR step {i}: loss {rec['loss']:.4f} <= "
              f"{LOSS_GROWTH} x step 0's {loss0:.4f}")
    rec = io["steps"][0]
    print(f"IN_OUT step 0: loss {rec['loss']:.6f} {rec['seconds'] * 1e3:.1f} "
          f"ms counts {rec['counts']} launches {rec['launches']}", flush=True)
    step_contract(rec, "IN_OUT", "IN_OUT step 0")
    for name, n in launches.items():
        check(n > 0, f"main path launched {name} ({n} times)")
    step_ms = statistics.median(r["seconds"] * 1e3 for r in wr["steps"][1:])
    print(f"IN_OUT_WR median step ms (steps 2-3): {step_ms:.1f}; "
          f"main path {main_s:.1f} s; peak memory {peak_gb:.2f} GiB",
          flush=True)

    # Step 1 against the same step on the dense xla_ref schedule.
    img, labels = image_batch(0, 0, batch=batch, image_size=image_size,
                              num_classes=num_classes, device=dev)
    leaves = param_leaves(init)
    t0 = time.perf_counter()
    loss_x = model.loss(init, img, labels, IN_OUT_WR.with_(
        kernel_impl="xla_ref"))
    grads_x = torch.autograd.grad(loss_x, list(leaves.values()))
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"xla_ref step: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    loss_p = wr["steps"][0]["loss"]
    loss_x = float(loss_x.detach())
    check(abs(loss_p - loss_x) <= 1e-5 * abs(loss_x),
          f"step 1 loss {loss_p:.7f} vs xla_ref {loss_x:.7f}")
    # σ′ flips: activations positive in one forward and not in the other.
    caps = {}
    with torch.no_grad():
        for impl in ("pallas", "xla_ref"):
            caps[impl] = {}
            model.apply(init, img, IN_OUT_WR.with_(kernel_impl=impl),
                        capture=caps[impl])
    flips = {k: int(((v > 0) != (caps["xla_ref"][k] > 0)).sum())
             for k, v in caps["pallas"].items()}
    n_act = sum(v.numel() for v in caps["pallas"].values())
    n_flip = sum(flips.values())
    print(f"ReLU sign flips pallas vs xla_ref: {n_flip} of {n_act} "
          f"activations {flips}", flush=True)
    check(n_flip <= FLIP_SHARE * n_act,
          f"sign flips {n_flip} <= {FLIP_SHARE} x {n_act} activations")
    order = list(caps["pallas"])
    flipped = [order.index(k) for k, n in flips.items() if n]
    top = max(flipped) if flipped else -1
    print("highest flipped layer: "
          + (order[top] if flipped else "none"), flush=True)
    for name, gx in zip(leaves, grads_x):
        gp = wr["first_grads"][name]
        err = float((gp - gx).abs().max()) / max(float(gx.abs().max()),
                                                 1e-30)
        layer = name.split("/")[0]
        below = layer in order and order.index(layer) <= top
        rtol = STEP_RTOL_FLIPPED if below else KERNEL_RTOL
        check(err <= rtol, f"grad {name}: max|diff|/max|g| = {err:.3e} "
              f"<= {rtol:g} ({'at or below' if below else 'above'} "
              f"the highest flip)")
    return launches, step_ms


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"FAIL: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch import kernels
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    set_full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    rows = kernel_phase(dev)
    launches, _ = end_to_end(dev)

    sources = {"relu_encode": ("src/repro_torch/csrc/relu_encode.cu",
                               "src/repro/kernels/relu_encode.py:63"),
               "queue_builder": ("src/repro_torch/csrc/queue_builder.cu",
                                 "src/repro/kernels/queue_builder.py:122"),
               "compact_gemm": ("src/repro_torch/csrc/masked_matmul.cu",
                                "src/repro/kernels/masked_matmul.py:492"),
               "predicated_gemm": ("src/repro_torch/csrc/masked_matmul.cu",
                                   "src/repro/kernels/masked_matmul.py:347")}
    out = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "case": r["case"]})
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
