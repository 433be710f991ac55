#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure makes the exit code nonzero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels under src/repro_torch/csrc, built with nvcc;
     each masked_gemm_kernel instantiation's registers and spill bytes
     (ptxas) and its TF32 HMMA instructions (cuobjdump -sass), which must
     be there, with no spill;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the VGG16 and MobileNet training steps give it, with its
     time, its plain version's time, a one-call PyTorch yardstick and its
     lower bound.  K1 and K5, one cell-bitmap encoder, also run with
     planted NaNs (their cells must be 0, as in the reference) and K1 with
     a pointer off 16-byte alignment; each case prints its encode_plan and
     its device time, replayed from a CUDA graph beside the library call's.
     The masked GEMM runs each shape in its compact, overflow
     -> predicated and predicated schedules, which must agree bit for bit,
     at the split-K weight-gradient shapes (VGG16 conv1, conv2, conv4,
     MobileNet dw1), conv9's 2-split dX and the group-major depthwise dX
     shapes (dw1, dw2) too; its split-K reduce is held alone against its
     plain version in the reduce plan's order (bit-equal) and in split
     order, at conv2's and dw1's WGs and conv9's dX (sigma-prime + emit),
     with its device time replayed from a CUDA graph beside torch.sum's.
     K2 runs at the step's bitmaps up to MobileNet dw2's dX (50,176 tiles),
     below capacity too, three calls each; the group-major compact
     pre-pass (queue_member) and the emit's NaN fix-up run alone against
     their plain versions.  K6 and
     K7, on no training path, run at VGG16 conv4's dX and WG shapes, where
     they must also equal sparse_gemm at G = 1 bit for bit.  conv4's dX
     runs again with a NaN planted in its sigma-prime multiplier, whose
     emit cell must be 0 on every schedule.  The standard tile's edges
     (TILE_EDGES: K = 1, 7, 9, 33, ragged M and N, unit strides on m and
     on k, operands off 16-byte alignment, a dead tile, planted ±inf and
     NaN) run on every schedule, NaN and inf in the plain version's
     places.  The standard path's rows take their bound at three TF32
     products on the tensor cores (TF32X3_FLOP_PER_S), the FMA bound
     beside it.  A capacity-
     limited dispatch must count fallback:queue_overflow on the card as on
     the CPU, with no host sync.  Last, phase 6's networks at their own
     shapes: one IN_OUT_WR step each of GoogLeNet, ResNet-18 and
     DenseNet-121, in which every K1 encode, K2 queue and GEMM dispatch
     (K2 -> K3 with its split-K reduce and NaN fix-up) is held against its
     plain version on the same inputs, the first call of each shape timed;
  4. VGG16 end to end at full width (224x224, width 1.0, 1000 classes,
     batch 8): three IN_OUT_WR SGD steps and one IN_OUT step through
     ``repro_torch.cnn_training.train_steps``, with the launch counters
     reset just before and read just after; each step's ReLU live fraction
     per layer; the first step's loss and gradients against the same step
     on the dense ``xla_ref`` schedule, with the ReLU sign flips between the
     two forwards counted and bounded; the per-step count contract;
  5. MobileNet end to end at full width (same geometry), the same checks,
     with ``scan_signed_inputs=True`` (the bitmap_scan kernel on the signed
     image and head input) and its 13 depthwise convs on the grouped GEMMs;
     its BN gradients against a float64 step under the f32 step's own
     ReLU masks, and that rule itself against faults planted in a retaken
     first step (CONTROLS), on every conv layer's leaves;
  6. the paper's experiment: one full-width IN_OUT_WR step each of
     GoogLeNet, ResNet-18 and DenseNet-121 through the kernels, held by the
     rules of phases 4-5 (the BN nets, as MobileNet, against float64
     steps under the f32 step's own ReLU masks, and that rule against the
     CONTROLS faults planted again), with no dense-conv fallback and every GEMM compact; all five networks captured
     at the full geometry under IN_OUT_WR (``repro_torch.benchmarks``),
     VGG16 and ResNet-18 also under DC from the same weights and batches
     (densities within DENSITY_ATOL; zero maps equal at 0 steps);
     relu_bwd_masked and weight_grad_masked at VGG16 conv4's shapes with
     sigma-prime from the captured conv3 activation, against their plain
     versions on the CPU; then every table of ``benchmarks.run`` from the
     captures, with the modeled total cycles in the order DC >= IN >=
     IN_OUT >= IN_OUT_WR for each network.  Each of its paths resets the
     launch counters before and reads them after;
  7. guarded LM training: SmolLM-360M at full width under a StepGuard with
     a checkpoint and a resume, its first step against float64 with two
     planted faults, the chaos matrix, VGG16 with ``autotune=True``;
  8. the encoder-decoder, frontend and MoE LMs at full width, batch 8 x 512
     positions: seamless-m4t-medium (full depth, its ReLU FFN under
     IN_OUT_WR on the masked plain path as the reference runs it) with its
     first step against float64 under its own ReLU masks, against the dense
     step and two planted faults, five AdamW steps, a checkpoint and a
     bit-equal resume; its decoder layer 0's FFN on that step's input
     through K1, K2 and K3 against the plain path, each kernel call held
     against its plain version; internvl2-1b (full depth) with the float64
     rule, one planted fault and three steps; deepseek-v2-lite at 3 layers
     with the float64 rule under its own routing, two planted faults, the
     tokens dropped per MoE layer, and guarded train_loop runs with a
     bit-equal resume;
  9. sliding windows, Mamba, xLSTM, bf16 and serving, at full width:
     gemma3-12b served at full depth in bf16 (ServeEngine at the serve
     CLI's defaults: tick ms, tokens/s, the weight-read bound), then cut
     to one period (6 layers): decode across the ring buffer's wrap
     against the parallel forward, the first bf16 step at 1 x 4,096
     against f32 with two planted window faults, three AdamW steps;
     xlstm-350m (full depth, f32): train_loop with a checkpoint and a
     bit-equal resume, the first step against float64 with two planted
     faults (at full depth beside float64 steps from params one f32
     rounding off), serving and decode against the parallel forward; jamba's
     layer 0 (Mamba + FFN) against float64 and ssm_decode against
     ssm_apply; deepseek-v2-lite served at full depth in bf16 with MLA's
     absorbed decode against the parallel forward, and that decode in
     f32 at 4 layers; the serve CLI.  Every decode check also rejects a
     planted fault;
 10. data-parallel training over two gloo ranks sharing the card
     (``launch.mesh.RankPool``; NCCL refuses two ranks on one GPU):
     ``sparse_psum`` on CUDA tensors at VGG16 conv13's WG shape, each
     rank's sum against the numpy sum of both ranks' inputs, the
     compressed and dense-fallback counts, an uncorrelated pair falling
     back, the chaos matrix's collective case, and the same reduce through
     one NCCL world of one rank; VGG16 IN_OUT_WR at full width through
     ``make_spmd_grad_fn`` (the global batch of 8, 4 images a rank, the
     kernels on each rank) against the single-process step, with each
     rank's counts and launches, and one more step in each rank with
     every kernel call held against its plain version at the rank's
     shapes; SmolLM-360M at full width through
     ``train_loop(mesh=..., spmd=True)`` with a StepGuard, its first step
     against the single-process step, its losses against the
     single-process loop's under a bound a planted fault breaks, a
     checkpoint written by rank 0 alone and a resume.  A rank's exception
     or hang fails the run;
 11. the bitmap-contract verifier (``repro_torch.analysis``): one
     full-width IN_OUT_WR step each of VGG16 and MobileNet (phase 4's
     geometry and first batch, MobileNet with ``scan_signed_inputs``) run
     unaudited and then under the trace audit, with zero violations, the
     audited loss and gradients bit-equal to the unaudited ones, one
     encode region per ``encode:act`` count and the step's ms with and
     without the recorder; a second bitmap_scan of dy, a torch.matmul and
     a hand-built GemmSpec planted on the card and caught (RESCAN,
     DENSE_GEMM, SPEC_UNRESOLVED); the five standard workloads clean; the
     kernel sweep (guard bands, poison, the shadow build's store counts)
     over every kernel of the table, clean, and its planted faults caught;
     whether compute-sanitizer can run; the lint of src/repro_torch clean;
 12. the dry run, the analytic cost model and the roofline
     (``repro_torch.launch.dryrun``, ``launch.flops``,
     ``launch.hlo_analysis``, ``benchmarks.roofline``): two dry runs start
     with phase 8 and run on the host's cores beside phases 8-11 at the
     lowest priority — every SMOKE cell of the registry (10 archs x 4
     shapes x both production meshes, 0 failed, the 14 long_500k skips)
     and the full-width train_4k, decode_32k and long_500k cells of all
     ten archs, each step traced on meta tensors; the measured paths of phases 7-9 (SmolLM-360M's and
     internvl2-1b's steps, the gemma3-12b, deepseek-v2-lite and xlstm-350m
     ticks) each at or above its analytic bound on the H100's peaks, in a
     roofline table; phase 10's profiled SmolLM step, whose traced
     all-reduce bytes must equal collectives.wire_bytes(), beside the
     analytic all-reduce bytes;
 13. tensor parallelism and FSDP (run after phase 11, before phase 12's
     dry runs) over four gloo ranks sharing the card as a (2, 2)
     ("data", "model") mesh, params and optimizer state DTensors placed
     by the partition rules: a probe of the collectives DTensor issues on
     CUDA tensors; SmolLM-360M at full width (TP_LAYERS of its 32 layers)
     through ``train_loop(mesh=...)`` without (``lm_tp``) and with FSDP
     (``lm_fsdp``), each against the single-process loop under a rule two
     planted faults must break (a shard one row off, a gradient's
     reduction over ``data`` dropped), each rank's bytes equal to
     ``dryrun.spec_bytes``, and an FSDP checkpoint resumed on the spmd
     layout and by the single-process loop; seamless decoder layer 0's
     ReLU FFN through K1-K3 on each rank's tensor-parallel shard
     (``ffn_tp``): its ReLU sign flips against the single-process call
     under phase 4's rule, its output and gradients against the plain
     dense FFN under the ranks' own masks, its counts against the
     single-process call's, every kernel call held against its plain
     version at the shard's shapes.
 14. per-period rematerialisation (``cfg.remat``; run after phase 13,
     before phase 12's dry runs; phases 7-13 run their LMs at
     ``remat=False``): seamless-m4t-medium at full width and depth (its
     ReLU FFN under IN_OUT_WR on the kernels, K1-K3, the split-K reduce
     and the NaN fix-up) on phase 8's batch, and SmolLM-360M on phase 7's,
     each three AdamW steps at remat=False and at remat=True from the
     same params and batches: step ms, peak memory, losses, launches a
     step; the first step's gradients and the final params and moments
     within REMAT_LEAF_RTOL, equal count dicts, seamless's launches up by
     exactly one forward's a step and its peak lower at remat=True, and a
     fault planted in the recomputation only rejected;
 15. the wall-clock harness (``repro_torch.benchmarks.wallclock``; run
     after phase 14, before phase 12's dry runs): its three documents at
     full geometry — fenced medians and IQRs of the masked GEMM's
     predicated (K4), compact (K2 -> K3) and dense schedules, two small
     train steps and the scripted autotune session (equal to the same
     session on the CPU); the fused sigma-prime + emit against the plain
     GEMM and GEMM-then-bitmap_scan (K5); the compressed against the dense
     all-reduce on four gloo ranks sharing the card, meshes 4 and 2x2 —
     with the first call of each timed row held against the plain
     versions.  A schema or coverage error fails the run; each claim of
     the reference's checkers is printed held or missed with both medians;
 16. the four example scripts (``examples/torch_*.py``; run beside phase
     12's dry runs), each ``main`` on the card at a small size against the
     same ``main`` on the CPU: the quickstart's sparse-vs-dense gradient
     gap within EXAMPLE_GAP and its sparsity lines equal; cnn_training's
     step-0 loss within 1e-5 and its modeled cycles DC >= IN >= IN_OUT >=
     IN_OUT_WR; train_lm stopped after its step-3 checkpoint, as a killed
     run, and resumed, bit-equal to the uninterrupted run; serve_lm's
     greedy tokens equal.
In every CNN step the first conv's dX is elided (the image requires no
gradient): counted as the reference counts it, launching nothing, so each
launch counter equals its dispatches counted less ``stats.elided()``.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.
"""
import contextlib
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
# The standard masked-GEMM tile does an f32 product as three TF32 products
# on the tensor cores (495 TFLOP/s dense): its least time for f32 work.
TF32X3_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 on the tensor cores (dense)
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
# Under BatchNorm one flip moves its channel's Σdy and Σdy·x̂ by ~1/N
# (N = 392 samples at 7x7) and BN's backward spreads that over the channel
# and every layer below: the dense f32 step is itself up to 2.8e-2·max|g|
# off an unmasked float64 step at full width.  So in a BN net (MobileNet,
# ResNet-18, DenseNet-121) the leaves at or below the highest flip are
# held, in relative L2 norm, to a float64 step (plain PyTorch, cuDNN in
# f64) under the f32 step's own ReLU masks (``dense_f64_step(masks=...)``):
# within KERNEL_RTOL.  Under its own masks only the arithmetic is
# compared; the flips are bounded by FLIP_SHARE.  Readings at full width:
# MobileNet 8.39e-5 at its largest leaf (the dense xla_ref step 7.98e-5
# under its own masks), ResNet-18 2.5e-6.
# The float64 rule is itself checked on every run: the first step is taken
# again with a fault planted in the port's GEMM dispatch, and each fault
# must fail the rule on some leaf ("none" plants nothing and must pass):
# every GEMM operand rounded to bf16; CONTROL_LAYER's dX GEMM without its
# σ′ epilogue; that GEMM with one live output tile zeroed.
CONTROLS = ("none", "bf16_operands", "sigma_prime_dropped",
            "live_tile_skipped")
CONTROL_LAYER = "dw7"
# SGD losses may wander with the batch but not blow up: each step's loss
# stays within LOSS_GROWTH times the first.
LOSS_GROWTH = 2.0

# The BN scale and bias of the MobileNet phase are drawn off the init's
# (1, 0): there ReLU's positive homogeneity gives a BN scale that feeds
# ReLU -> depthwise conv -> BN (conv0, pw1-pw12) an exactly zero gradient,
# whose f32 value is rounding noise that no relative bound can hold.
BN_SCALE_SD, BN_BIAS_SD = 0.2, 0.5

FAILURES = []
# Phase 4's median step ms per net, printed beside phase 7's autotuned step.
STEP_MS = {}
# kernel_phase's (report, encoder_detail), for phase 7's step audit.
REPORTERS = []
# Phase 12's readings of earlier phases: each measured path's (config,
# shape, dtype its GEMMs compute in, measured ms) from phases 7-9, phase
# 10's profiled SmolLM step in each rank, and its NCCL world's events.
MEASURED = {}
DP_TRACE = []
NCCL_TRACE = {}


def check(ok, what):
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def rel_err(got, want):
    """(max|got - want|, that over max|want|, within KERNEL_RTOL), NaNs
    held apart: they must sit in the same places."""
    import torch
    err = float((got - want).nan_to_num(0.0).abs().max())
    rel = err / max(float(want.nan_to_num(0.0).abs().max()), 1e-30)
    return err, rel, rel <= KERNEL_RTOL and torch.equal(got.isnan(),
                                                        want.isnan())


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


# The standard tile's edges, held in phase 3 as tests/test_torch_cuda.py
# holds them: (G, M, K, N, block, A layout, B layout, offset, plant).  "km"
# is A a transposed view of (G, K, M) (unit stride on m, as patches^T),
# "nk" B a transposed view of (G, N, K) (unit stride on k); an offset of 1
# puts both operands 4 bytes off 16-byte alignment; "dead" clears every k
# block of one live output tile; "inf" puts ±inf in a live block beside
# TF32-exact partners (1.5, 0.0), a subnormal and normal values, and a NaN
# whose payload lies in its low 13 bits.
TILE_EDGES = {
    "K=1": (1, 130, 1, 70, (128, 128, 128), "mk", "kn", 0, None),
    "K=7": (2, 150, 7, 96, (64, 8, 32), "mk", "kn", 0, None),
    "K=9": (1, 140, 9, 40, (128, 8, 128), "km", "kn", 0, None),
    "K=33": (1, 96, 33, 72, (32, 16, 64), "mk", "nk", 0, None),
    "M and N ragged": (2, 333, 100, 250, (256, 32, 256), "mk", "kn", 0,
                       None),
    "A unit stride on m": (2, 200, 130, 96, (128, 32, 128), "km", "kn", 0,
                           None),
    "B unit stride on k": (1, 200, 130, 96, (128, 32, 128), "mk", "nk", 0,
                           None),
    "4 bytes off alignment": (1, 190, 130, 100, (128, 32, 128), "mk", "kn",
                              1, None),
    "4 bytes off, both transposed": (1, 190, 130, 100, (128, 32, 128), "km",
                                     "nk", 1, None),
    "a whole tile's k blocks dead": (1, 256, 96, 128, (64, 16, 64), "mk",
                                     "kn", 0, "dead"),
    "inf beside 1.5, 0, a subnormal": (1, 160, 40, 48, (64, 16, 16), "mk",
                                       "kn", 0, "inf"),
}


def tile_build_check():
    """The standard tile as built: for each ``masked_gemm_kernel``
    instantiation of the default library, its registers and spill bytes
    (``ptxas -v`` in the build's log) and its TF32 HMMA instructions
    (``cuobjdump -sass`` of the library).  Returns {mangled name: (regs,
    spill bytes, TF32 HMMAs)}; fails the run where one holds no TF32 HMMA
    or spills."""
    import re
    import shutil
    from repro_torch.kernels import _build

    found, fn = {}, None
    for line in _build.build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or "masked_gemm_kernel" not in fn:
            continue
        regs, spill, hmma = found.get(fn, (None, 0, 0))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        found[fn] = (regs, spill, hmma)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", _build.library_path()],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump -sass of the kernel library "
          f"({sass.stderr.strip()[:200]})")
    for part in sass.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "masked_gemm_kernel" not in name:
            continue
        hmma = sum(1 for ln in part.splitlines()
                   if "HMMA" in ln and "TF32" in ln)
        regs, spill, _ = found.get(name, (None, 0, 0))
        found[name] = (regs, spill, hmma)
    for name, (regs, spill, hmma) in sorted(found.items()):
        print(f"standard tile {name}: {regs} registers, {spill} spill bytes, "
              f"{hmma} TF32 HMMA", flush=True)
    check(len(found) >= 3 and all(h > 0 for _, _, h in found.values()),
          f"every masked_gemm_kernel instantiation ({len(found)}) holds TF32 "
          f"HMMA instructions")
    check(all(s_ == 0 for _, s_, _ in found.values()),
          "no masked_gemm_kernel instantiation spills")
    return found


def kernel_phase(dev):
    import torch
    from repro_torch.kernels import bitmap_scan as k5
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import queue_builder as qb
    from repro_torch.kernels import relu_encode as re_
    from repro_torch.kernels import _build, ref, shapes, stats
    from repro_torch.kernel_times import event_ms as time_ms
    from repro_torch.kernel_times import graph_ms as device_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def report(name, case, err, ok, ms, plain_ms, library_ms, bytes_, ops,
               rel=None, plan=None, flop_rate=F32_FLOP_PER_S):
        bound_b = bytes_ / HBM_BYTES_PER_S * 1e3
        bound_o = ops / flop_rate * 1e3
        bound = max(bound_b, bound_o)
        line = {"kernel": name, "case": case, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "gflop": ops / 1e9, "bound_ms": bound,
                "bound_by": "bytes" if bound_b >= bound_o else "operations"}
        if flop_rate == TF32X3_FLOP_PER_S:    # the FMA tile's bound beside
            line["f32_bound_ms"] = max(bound_b,
                                       ops / F32_FLOP_PER_S * 1e3)
        if rel is not None:
            line["rel_err"] = rel
        if plan is not None:
            line.update(plan)
        print("kernel " + json.dumps(line), flush=True)
        check(ok, f"{name} {case} matches its plain version")
        if name not in rows:           # the first case is the main one
            rows[name] = line
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    def encoder_detail(x, gran, y, kernel, library):
        """The encoder's launch plan for ``x``, as its wrapper computes it,
        and the device times of the kernel and of its library call (the
        single-call times hold the wrapper's host work too)."""
        aligned = x.data_ptr() % 16 == 0 and (y is None
                                              or y.data_ptr() % 16 == 0)
        plan = re_.encode_plan(*x.shape, gran, aligned, ld=x.stride(0),
                               sm_count=torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
        return {"plan": plan._asdict(), "device_ms": device_ms(kernel),
                "library_device_ms": None if library is None
                else device_ms(library)}

    def nan_rows(m):
        """The 64 rows in which ``operand`` plants a NaN."""
        return torch.arange(0, m, m // 64, device=dev)[:64]

    def operand(m, n, offset=0, nan=False):
        """(m, n) normal values ``offset`` elements into their buffer (an
        offset of 1 leaves the pointer 4 bytes off 16-byte alignment);
        with ``nan``, a NaN in column 0 beside a positive value in column
        1 of each of ``nan_rows(m)``."""
        buf = torch.randn(m * n + offset, device=dev, generator=gen)
        x = buf[offset:].view(m, n)
        if nan:
            x[nan_rows(m), 0] = float("nan")
            x[nan_rows(m), 1] = 1.5
        return x

    def nan_cells_dead(bits, m, gran):
        """The cells holding the planted NaNs are 0, as in the reference."""
        return int(bits[nan_rows(m) // gran[0], 0].sum()) == 0

    def same(a, b):
        """Bit-equal, a NaN equal to a NaN."""
        return torch.equal(a.isnan(), b.isnan()) and \
            torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))

    # K1 relu_encode: VGG16 conv2's and conv4's inputs (gran (1, 64),
    # (1, 128)); MobileNet's dw1 and dw2 inputs (depthwise: (1, 1)) and pw1's
    # (1, 32); dw2's and pw1's with planted NaNs (at (1, 32) beside a live
    # value in the cell) and dw2's with a pointer off 16-byte alignment
    # (the thread path).
    for case, (m, n, gran, offset, nan) in (
            ("conv2 input", (401408, 64, (1, 64), 0, False)),
            ("conv4 input", (100352, 128, (1, 128), 0, False)),
            ("dw1 input", (100352, 32, (1, 1), 0, False)),
            ("dw2 input", (100352, 64, (1, 1), 0, False)),
            ("pw1 input", (100352, 32, (1, 32), 0, False)),
            ("dw2 input, planted NaNs", (100352, 64, (1, 1), 0, True)),
            ("pw1 input, planted NaNs", (100352, 32, (1, 32), 0, True)),
            ("dw2 input, unaligned", (100352, 64, (1, 1), 1, False))):
        z = operand(m, n, offset, nan)
        y, bits = re_.relu_encode(z, gran)
        yp, bp = re_.relu_encode_plain(z, gran)
        ok = same(y, yp) and torch.equal(bits, bp)
        if nan:
            ok = ok and nan_cells_dead(bits, m, gran)
        err = float((y - yp).nan_to_num(0.0).abs().max())
        report("relu_encode", case, err, ok,
               time_ms(lambda: re_.relu_encode(z, gran)),
               time_ms(lambda: re_.relu_encode_plain(z, gran)),
               time_ms(lambda: torch.relu(z)),
               8.0 * m * n + 4.0 * bits.numel(), 0.0,
               plan=encoder_detail(z, gran, y,
                                   lambda: re_.relu_encode(z, gran),
                                   lambda: torch.relu(z)))

    # K2 queue builder: the conv2 dX tile bitmap (3136 x 1), a (784 x 4)
    # one, and MobileNet's dw1 and dw2 dX bitmaps (G * Mb x 1: 25,088 and
    # 50,176 tiles, several blocks of look-back), each at full capacity and
    # at a capacity below n_live; three calls each, so that a status word
    # left stale by one call would show in the next.
    for shape in ((3136, 1), (784, 4), (25088, 1), (50176, 1)):
        bm = (torch.rand(shape, device=dev, generator=gen) < 0.5) \
            .to(torch.int32)
        n_live = int(bm.sum())
        for cap in (bm.numel(), n_live // 2):
            got = [qb.build_queue_kernel(bm, capacity=cap) for _ in range(3)]
            want = qb.build_queue_plain(bm, cap)
            ok = all(torch.equal(a, b) for q in got for a, b in zip(q, want))
            report("queue_builder", f"{shape[0]}x{shape[1]} cap {cap}",
                   0.0 if ok else 1.0, ok,
                   time_ms(lambda: qb.build_queue_kernel(bm, capacity=cap)),
                   time_ms(lambda: qb.build_queue_plain(bm, cap)),
                   time_ms(lambda: torch.nonzero(bm)),
                   4.0 * bm.numel() + 8.0 * cap + 4.0, 0.0,
                   plan={"device_ms": device_ms(
                       lambda: qb.build_queue_kernel(bm, capacity=cap))})

    # The group-major compact pre-pass alone at dw1's dX queue (25,088
    # tiles, about half live) and overflowing: the bitmap zero-filled, then
    # marked; the library call is index_put_ on the live slots' indices,
    # decoded beforehand.
    bm = (torch.rand((25088, 1), device=dev, generator=gen) < 0.5) \
        .to(torch.int32)
    for cap in (bm.numel(), int(bm.sum()) // 2):
        fi, jj, nl = qb.build_queue_kernel(bm, capacity=cap)
        member = torch.zeros(bm.numel(), dtype=torch.int32, device=dev)
        mm.queue_member(fi, jj, nl, member, n_cols=1)
        want = mm.queue_member_plain(fi, jj, nl, torch.zeros_like(member),
                                     n_cols=1)
        ok = torch.equal(member, want) and (
            int(want.sum()) == (int(nl[0]) if cap == bm.numel() else 0))
        live = int(nl[0]) if int(nl[0]) <= cap else 0
        rows_l, cols_l = fi[:live].long(), jj[:live].long()
        one = torch.ones((), dtype=torch.int32, device=dev)
        report("queue_member", f"dw1 dX queue 25088 tiles cap {cap}",
               0.0 if ok else 1.0, ok,
               time_ms(lambda: mm.queue_member(fi, jj, nl, member,
                                               n_cols=1)),
               time_ms(lambda: mm.queue_member_plain(
                   fi, jj, nl, torch.zeros_like(member), n_cols=1)),
               time_ms(lambda: member.view(-1, 1).index_put_(
                   (rows_l, cols_l), one)),
               4.0 * (bm.numel() + 3 * live + 1), 0.0,
               plan={"device_ms": device_ms(lambda: mm.queue_member(
                   fi, jj, nl, member, n_cols=1))})

    def gemm_case(g, m, k, n, block, live=0.5, sigma=True, a_t=False,
                  b_mask=True, out_mask=True, a_grouped=False,
                  a_grouped_t=False):
        ni, nk, nj = shapes.grid_shape((m, k, n), block)
        if a_t:   # WG: A = patches^T, a strided view of (K, M) patches
            a = torch.randn(g, k, m, device=dev, generator=gen) \
                .transpose(1, 2)
        elif a_grouped:   # grouped dX: group g's columns of (M, K*G) patches
            a = torch.randn(m, k * g, device=dev, generator=gen) \
                .reshape(m, k, g, 1).permute(2, 0, 1, 3).reshape(g, m, k)
        elif a_grouped_t:   # grouped WG: the same view of (K, M*G), ^T
            a = torch.randn(k, m * g, device=dev, generator=gen) \
                .reshape(k, m, g, 1).permute(2, 0, 1, 3).reshape(g, k, m) \
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

    def gemm_rate(plan):
        """The operations' rate of a GEMM row's bound: the standard tile's
        three TF32 products, or f32 outside the tensor cores."""
        return TF32X3_FLOP_PER_S if plan["path"] == mm.STANDARD \
            else F32_FLOP_PER_S

    def run_gemm(name, case, g, m, k, n, block, emit, reduce_row=False,
                 nan=False, **kw):
        a, b, om, am, bmk, mult = gemm_case(g, m, k, n, block, **kw)
        ni, _, nj = shapes.grid_shape((m, k, n), block)
        if nan:
            # A NaN in sigma-prime's multiplier inside the first live tile:
            # its emit cell must be 0 on every schedule, as in the reference.
            gi, ti, tj = om.nonzero()[0].tolist()
            mult[gi, ti * block[0], tj * block[2]] = float("nan")
            nan_cell = (gi, ti * block[0] // emit[0],
                        tj * block[2] // emit[1])
        plan = {"path": mm.gemm_path(g, m, k, n, block),
                "splits": mm.split_plan(g, m, k, n, block)}
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
                     " overflow->predicated"),
                    ("predicated_gemm", predicated, "")]
        results = []
        for kname, fn, tag in variants:
            if name and kname != name:
                continue
            got, got_bits = fn()
            torch.cuda.synchronize()
            results.append(got)
            err, rel, ok = rel_err(got, want)
            if emit is not None:
                ok = ok and torch.equal(got_bits, want_bits)
            if nan:
                ok = ok and int(got_bits[nan_cell]) == 0
            ok = ok and torch.equal(got == 0, want == 0)
            report(kname, case + tag, err, ok, time_ms(fn), plain_ms, lib_ms,
                   bytes_, flops, rel, plan, flop_rate=gemm_rate(plan))
        # One plan per shape: every schedule sums in one order.
        check(all(same(r, results[0]) for r in results),
              f"{case}: compact, its overflow fallback and predicated are "
              f"bit-equal")
        if reduce_row:
            reduce_case(case, a, b, qmask, am, bmk, mult, block, emit,
                        queues[flat.numel()])

    def reduce_case(case, a, b, qmask, am, bmk, mult, block, emit, queue):
        """The split-K reduce alone, after one compact GEMM pass, against
        its plain version: the partials added in the reduce plan's order
        (bit-equal) and in split order (within KERNEL_RTOL), x sigma-prime
        over the live tiles, the bitmap."""
        g, m, k = a.shape
        n = b.shape[2]
        fi, jj, nl = queue
        out = torch.zeros(g, m, n, device=dev)
        bits = None if emit is None else torch.zeros(
            g, -(-m // emit[0]), -(-n // emit[1]), dtype=torch.int32,
            device=dev)
        args, rargs, splits, (ws, _member) = mm.launch_args(
            mm._COMPACT, a, b, out, bits, None, am, bmk, mult, fi, jj, nl,
            fi.numel(), block, emit)
        plan = mm.reduce_plan(mm.gemm_path(g, m, k, n, block), g, m, n,
                              splits)
        lib = _build.load()
        _build.check(lib.masked_gemm_launch(*args), "masked_gemm")
        check(splits > 1, f"{case}: split-K plan ({splits} splits)")

        def reduce():
            # on the current stream: the capturing one inside a CUDA graph
            _build.check(lib.masked_gemm_reduce_launch(
                *rargs[:-1], _build.stream_handle(dev)), "reduce")

        live = ref.expand_block_mask(qmask, block[0], block[2])[
            :, :m, :n].bool()

        def plain(order=plan):
            total = mm.splitk_reduce_plain(ws, order)
            if mult is not None:
                total = total * mult
            return torch.where(live, total, torch.zeros_like(total))
        reduce()
        torch.cuda.synchronize()
        want = plain()
        err, rel, ok = rel_err(out, want)
        ok = ok and torch.equal(out, want)
        if emit is not None:
            ok = ok and torch.equal(bits, mm.emit_bits(want, emit))
        _, seq_rel, seq_ok = rel_err(out, plain(mm.ReducePlan(1, 256, 1)))
        check(seq_ok, f"{case}: the reduce is within {KERNEL_RTOL:g} x "
              f"max|plain| of the sequential split-order sum ({seq_rel:.2e})")
        live_el = float(live.sum())
        bytes_ = 4.0 * (splits * live_el + (live_el if mult is not None
                                            else 0.0) + g * m * n
                        + (0 if bits is None else bits.numel()))
        report("splitk_reduce", f"{case}, {splits} splits", err, ok,
               time_ms(reduce), time_ms(plain),
               time_ms(lambda: torch.sum(ws, 0)), bytes_,
               (splits - 1) * live_el, rel,
               {"splits": splits, "reduce_plan": plan._asdict(),
                "device_ms": device_ms(reduce),
                "library_device_ms": device_ms(lambda: torch.sum(ws, 0))})

    def fixup_case():
        """emit_nan_fixup: an unsplit emitting launch at conv4's dX shape
        with a NaN planted in sigma-prime's multiplier raises the device
        flag, and the fix-up that the launcher runs after it clears the NaN
        cell's bit; then the fix-up alone, which reads the whole output
        whatever the flag says, against its plain version, on the bits as
        the epilogue leaves them (the NaN cell set)."""
        g, m, k, n, block, emit = 1, 100352, 1152, 128, (128,) * 3, (1, 128)
        a, b, om, am, _, mult = gemm_case(g, m, k, n, block, b_mask=False)
        gi, ti, tj = om.nonzero()[0].tolist()
        mult[gi, ti * block[0] + 1, tj * block[2]] = float("nan")
        out = torch.zeros(g, m, n, device=dev)
        bits = torch.zeros(g, m, 1, dtype=torch.int32, device=dev)
        args, _, splits, _ = mm.launch_args(
            mm._PREDICATED, a, b, out, bits, om, am, None, mult, None, None,
            None, 0, block, emit)
        lib = _build.load()
        _build.check(lib.masked_gemm_launch(*args), "masked_gemm")
        torch.cuda.synchronize()
        cell = (gi, ti * block[0] + 1, 0)
        check(splits == 1 and int(bits[cell]) == 0 and torch.equal(
            bits, mm.emit_nan_fixup_plain(
                out, mm.emit_bits(out.nan_to_num(0.0), emit), emit)),
            "emit_nan_fixup: the launcher's fix-up clears the NaN cell")
        raw = bits.clone()
        raw[cell] = 1
        want = mm.emit_nan_fixup_plain(out, raw.clone(), emit)
        work = raw.clone()
        mm.emit_nan_fixup(out, work, emit)
        torch.cuda.synchronize()
        ok = torch.equal(work, want) and int(work[cell]) == 0
        report("emit_nan_fixup", "conv4 dX 100352x1152x128, a NaN in one "
               "cell", 0.0 if ok else 1.0, ok,
               time_ms(lambda: mm.emit_nan_fixup(out, work, emit)),
               time_ms(lambda: mm.emit_nan_fixup_plain(out, work, emit)),
               None, 4.0 * g * m * n + 4.0, 0.0,
               plan={"device_ms": device_ms(
                   lambda: mm.emit_nan_fixup(out, work, emit))})

    # K3/K4: conv4's dX GEMM (sigma-prime + bitmap emit, ~50% live masks),
    # a conv4-shaped WG GEMM (A = patches^T through strides), and a ragged
    # small case with block (8, 16, 8).
    run_gemm("", "conv4 dX 100352x1152x128", 1, 100352, 1152, 128,
             (128, 128, 128), (1, 128), b_mask=False)
    run_gemm("", "conv4 dX, planted NaN", 1, 100352, 1152, 128,
             (128, 128, 128), (1, 128), b_mask=False, nan=True)
    run_gemm("", "conv4 WG 1152x100352x128", 1, 1152, 100352,
             128, (128, 128, 128), None, sigma=False, a_t=True,
             out_mask=False)
    run_gemm("", "ragged 2x333x250x77 block 8x16x8", 2, 333, 250, 77,
             (8, 16, 8), (2, 4))
    # Grouped: MobileNet dw1's dX GEMM, 32 groups of (100,352 x 9) @ (9 x 1)
    # on degenerate (128, 9, 1) tiles, A a strided per-group view (the
    # group-major rows path), and dw2's, 64 groups.
    run_gemm("", "dw1 dX 32x(100352x9x1) block 128x9x1", 32, 100352, 9, 1,
             (128, 9, 1), (1, 1), b_mask=False, a_grouped=True)
    run_gemm("", "dw2 dX 64x(100352x9x1) block 128x9x1", 64, 100352, 9, 1,
             (128, 9, 1), (1, 1), b_mask=False, a_grouped=True)
    # The weight-gradient GEMMs that one block per output tile left on 1-9
    # SMs: split-K.  conv1's and conv2's (conv2 with all-live masks, as in
    # the step), and dw1's, 32 groups of (9 x 100,352) @ (100,352 x 1) with
    # A through _group_patches' strides (the group-major k path).
    run_gemm("", "conv1 WG 27x401408x64", 1, 27, 401408, 64,
             (128, 128, 128), None, sigma=False, a_t=True, out_mask=False)
    run_gemm("", "conv2 WG 576x401408x64 all live", 1, 576, 401408, 64,
             (128, 128, 128), None, live=1.0, sigma=False, a_t=True,
             out_mask=False, reduce_row=True)
    run_gemm("", "dw1 WG 32x(9x100352x1) block 9x128x1", 32, 9, 100352, 1,
             (9, 128, 1), None, sigma=False, a_grouped_t=True,
             out_mask=False, reduce_row=True)
    # A 2-split reduce with sigma-prime and the bitmap emit: conv9's dX.
    run_gemm("", "conv9 dX 6272x4608x512", 1, 6272, 4608, 512,
             (128, 128, 128), (1, 128), b_mask=False, reduce_row=True)
    fixup_case()

    def tile_edge(case, g, m, k, n, block, a_lay, b_lay, offset, plant):
        """One TILE_EDGES case: predicated, compact and its overflow
        fallback against the plain version on the same inputs."""
        def operand(outer, inner, transposed):
            shape = (g, inner, outer) if transposed else (g, outer, inner)
            buf = torch.randn(math.prod(shape) + offset, device=dev,
                              generator=gen)
            x = buf[offset:].view(shape)
            return x.transpose(1, 2) if transposed else x
        a = operand(m, k, a_lay == "km")
        b = operand(k, n, False) if b_lay == "kn" \
            else operand(n, k, False).transpose(1, 2)
        ni, nk, nj = shapes.grid_shape((m, k, n), block)
        om, am, bmk = ((torch.rand(sh, device=dev, generator=gen) < 0.6)
                       .to(torch.int32)
                       for sh in ((g, ni, nj), (g, ni, nk), (g, nk, nj)))
        mult = (torch.rand(g, m, n, device=dev, generator=gen) < 0.7).float()
        if plant == "dead":
            om[0, 1, :] = 1
            am[0, 1, :] = 0
        elif plant == "inf":
            kk, kb = 5, 5 // block[1]
            om[0] = 1
            am[0, :, kb] = 1
            bmk[0, kb, :] = 1
            a[0, 3, kk], a[0, 20, kk] = float("inf"), float("-inf")
            a[0, 70, kk + 1] = torch.tensor(
                [0x7F800001], dtype=torch.int32).view(torch.float32)[0]
            b[0, kk, 0], b[0, kk, 1], b[0, kk, 2] = 1.5, 0.0, 1e-40
            mult[0, 3, :3] = 1.0
        emit = (2, 4)
        kw = dict(block=block, epilogue_mult=mult, emit_gran=emit)

        def plain():
            return mm.grouped_masked_matmul_plain(
                a, b, om, am, bmk, out=torch.zeros(g, m, n, device=dev),
                bits=torch.zeros(g, -(-m // 2), -(-n // 4),
                                 dtype=torch.int32, device=dev), **kw)
        want, want_bits = plain()
        flat = om.reshape(-1, nj).contiguous()
        queues = [qb.build_queue_kernel(flat, capacity=cap)
                  for cap in (flat.numel(), int(flat.sum()) // 2)]

        def compact(q, overflow):
            out, bits = mm.grouped_compact_masked_matmul_kernel(
                a, b, *q, am, bmk, **kw)
            if overflow:
                out, bits = mm.grouped_masked_matmul_kernel(
                    a, b, om, am, bmk, out=out, bits=bits, n_live=q[2],
                    capacity=q[0].numel(), **kw)
            return out, bits
        variants = (("predicated_gemm", "", lambda: mm
                     .grouped_masked_matmul_kernel(a, b, om, am, bmk, **kw)),
                    ("compact_gemm", "", lambda: compact(queues[0], False)),
                    ("compact_gemm", " overflow->predicated",
                     lambda: compact(queues[1], True)))
        fin = want.isfinite()
        scale = max(float(want[fin].abs().max()), 1e-30)
        plan = {"path": mm.gemm_path(g, m, k, n, block),
                "splits": mm.split_plan(g, m, k, n, block)}
        flops, bytes_ = gemm_traffic((g, m, k, n), block, om, am, bmk, mult,
                                     want_bits)
        results = []
        for kname, tag, fn in variants:
            got, got_bits = fn()
            torch.cuda.synchronize()
            results.append(got)
            err = float((got[fin] - want[fin]).abs().max())
            ok = (torch.equal(got.isnan(), want.isnan())
                  and torch.equal(got == math.inf, want == math.inf)
                  and torch.equal(got == -math.inf, want == -math.inf)
                  and err <= KERNEL_RTOL * scale
                  and torch.equal(got == 0, want == 0)
                  and torch.equal(got_bits, want_bits))
            report(kname, f"tile edge {case} {g}x{m}x{k}x{n} block "
                   f"{block}{tag}", err, ok, time_ms(fn), time_ms(plain),
                   time_ms(lambda: torch.matmul(a, b)), bytes_, flops,
                   err / scale, plan, flop_rate=gemm_rate(plan))
        check(plan["path"] == mm.STANDARD
              and all(same(r, results[0]) for r in results)
              and (plant != "inf" or (bool(want.isinf().any())
                                      and bool(want.isnan().any()))),
              f"tile edge {case}: the standard path, its schedules "
              f"bit-equal")

    for case, spec in TILE_EDGES.items():
        tile_edge(case, *spec)

    # The standard tile and torch.matmul (f32, TF32 off) against a float64
    # product at conv4's dX shape, dense: max|Δ| over max|float64|.
    a = torch.randn(1, 100352, 1152, device=dev, generator=gen)
    b = torch.randn(1, 1152, 128, device=dev, generator=gen)
    want = torch.matmul(a.double(), b.double())
    scale = float(want.abs().max())
    tile_err = float((mm.grouped_masked_matmul_kernel(
        a, b, None, None, None, block=(128, 128, 128))[0].double()
        - want).abs().max()) / scale
    lib_err = float((torch.matmul(a, b).double() - want).abs().max()) / scale
    check(tile_err <= KERNEL_RTOL,
          f"standard tile at conv4 dX 100352x1152x128, dense, against "
          f"float64: {tile_err:.2e} of max|float64| (torch.matmul in f32 "
          f"{lib_err:.2e})")
    del a, b, want

    # K5 bitmap_scan: conv0's input (the image, gran (1, 1)), the head's
    # input (gran (128, 128)) and a ragged signed case; bits exact.  The
    # x.ne(0) yardstick computes the same function only at gran (1, 1).
    for case, (m, n, gran, density, nan) in (
            ("conv0 input 401408x3 gran 1x1", (401408, 3, (1, 1), 1.0,
                                               False)),
            ("head input 8x1024 gran 128x128", (8, 1024, (128, 128), 1.0,
                                                False)),
            ("ragged 333x29 gran 8x8", (333, 29, (8, 8), 0.02, False)),
            ("conv0 input, planted NaNs, gran 1x3", (401408, 3, (1, 3), 1.0,
                                                    True))):
        x = operand(m, n, nan=nan)
        x *= torch.rand(m, n, device=dev, generator=gen) < density
        bits = k5.bitmap_scan(x, gran)
        want = k5.bitmap_scan_plain(x, gran)
        ok = torch.equal(bits, want)
        if nan:
            ok = ok and nan_cells_dead(bits, m, gran)
        ne = (lambda: x.ne(0)) if gran == (1, 1) else None
        report("bitmap_scan", case, 0.0 if ok else 1.0, ok,
               time_ms(lambda: k5.bitmap_scan(x, gran)),
               time_ms(lambda: k5.bitmap_scan_plain(x, gran)),
               None if ne is None else time_ms(ne),
               4.0 * m * n + 4.0 * bits.numel(), 0.0,
               plan=encoder_detail(x, gran, None,
                                   lambda: k5.bitmap_scan(x, gran), ne))

    # K6/K7, the 2-D launches, at VGG16 conv4's dX shape (block-aligned):
    # each against its plain version; K7 scattered bit-equal to K6, and K6
    # bit-equal to sparse_gemm at G = 1 (the role the reference gives them).
    m, k, n, block = 100352, 1152, 128, (128, 128, 128)
    bm, bk, bn = block
    a, b, om, am, _, mult = gemm_case(1, m, k, n, block, b_mask=False)
    a, b, om, am, mult = a[0], b[0], om[0], am[0], mult[0]
    bmk = torch.ones(k // bk, n // bn, dtype=torch.int32, device=dev)
    kw = dict(bm=bm, bk=bk, bn=bn, epilogue_mult=mult)
    flops, bytes_ = gemm_traffic((1, m, k, n), block, om[None], am[None],
                                 bmk[None], mult, None)
    lib_ms = time_ms(lambda: torch.matmul(a, b))
    k6 = mm.masked_matmul_kernel(a, b, om, am, bmk, **kw)
    want = mm.masked_matmul_plain(a, b, om, am, bmk, **kw)
    torch.cuda.synchronize()
    err, rel, ok = rel_err(k6, want)
    report("masked_matmul_2d", "conv4 dX 100352x1152x128", err, ok,
           time_ms(lambda: mm.masked_matmul_kernel(a, b, om, am, bmk, **kw)),
           time_ms(lambda: mm.masked_matmul_plain(a, b, om, am, bmk, **kw)),
           lib_ms, bytes_, flops, rel, flop_rate=TF32X3_FLOP_PER_S)
    ii, jj, n_live = qb.build_queue_kernel(om, capacity=om.numel())
    k7 = mm.compact_masked_matmul_kernel(a, b, ii, jj, n_live, am, bmk, **kw)
    want7 = mm.compact_masked_matmul_plain(a, b, ii, jj, n_live, am, bmk,
                                           **kw)
    torch.cuda.synchronize()
    err, rel, ok = rel_err(k7, want7)
    report("compact_masked_matmul_2d", "conv4 dX 100352x1152x128", err, ok,
           time_ms(lambda: mm.compact_masked_matmul_kernel(
               a, b, ii, jj, n_live, am, bmk, **kw)),
           time_ms(lambda: mm.compact_masked_matmul_plain(
               a, b, ii, jj, n_live, am, bmk, **kw)),
           lib_ms, bytes_, flops, rel, flop_rate=TF32X3_FLOP_PER_S)
    nl = int(n_live[0])
    scattered = torch.zeros_like(k6)
    scattered.view(m // bm, bm, n // bn, bn)[
        ii[:nl].long(), :, jj[:nl].long(), :] = k7[:nl]
    check(torch.equal(scattered, k6), "K7 scattered is bit-equal to K6")
    for schedule in ("compact", "predicated"):
        spec = ops.GemmSpec(block=block, schedule=schedule,
                            epilogue=("sigma_prime",))
        got = ops.sparse_gemm(a, b, (om, am, bmk), spec, epilogue_mult=mult)
        check(torch.equal(got, k6),
              f"K6 is bit-equal to sparse_gemm(G=1, {schedule})")

    # K6/K7 at a split shape (VGG16 conv4's WG, 9 output tiles): the same
    # plan as sparse_gemm(G=1), so the same bits.
    m, k, n = 1152, 100352, 128
    splits = mm.split_plan(1, m, k, n, block)
    a, b, om, am, bmk, mult = gemm_case(1, m, k, n, block)
    a, b, om, am, bmk, mult = a[0], b[0], om[0], am[0], bmk[0], mult[0]
    kw = dict(bm=bm, bk=bk, bn=bn, epilogue_mult=mult)
    flops, bytes_ = gemm_traffic((1, m, k, n), block, om[None], am[None],
                                 bmk[None], mult, None)
    lib_ms = time_ms(lambda: torch.matmul(a, b))
    k6 = mm.masked_matmul_kernel(a, b, om, am, bmk, **kw)
    want = mm.masked_matmul_plain(a, b, om, am, bmk, **kw)
    torch.cuda.synchronize()
    err, rel, ok = rel_err(k6, want)
    case = f"conv4 WG 1152x100352x128, {splits} splits"
    report("masked_matmul_2d", case, err, ok,
           time_ms(lambda: mm.masked_matmul_kernel(a, b, om, am, bmk, **kw)),
           time_ms(lambda: mm.masked_matmul_plain(a, b, om, am, bmk, **kw)),
           lib_ms, bytes_, flops, rel, {"splits": splits},
           flop_rate=TF32X3_FLOP_PER_S)
    ii, jj, n_live = qb.build_queue_kernel(om, capacity=om.numel())
    k7 = mm.compact_masked_matmul_kernel(a, b, ii, jj, n_live, am, bmk, **kw)
    want7 = mm.compact_masked_matmul_plain(a, b, ii, jj, n_live, am, bmk,
                                           **kw)
    torch.cuda.synchronize()
    err, rel, ok = rel_err(k7, want7)
    report("compact_masked_matmul_2d", case, err, ok,
           time_ms(lambda: mm.compact_masked_matmul_kernel(
               a, b, ii, jj, n_live, am, bmk, **kw)),
           time_ms(lambda: mm.compact_masked_matmul_plain(
               a, b, ii, jj, n_live, am, bmk, **kw)),
           lib_ms, bytes_, flops, rel, {"splits": splits},
           flop_rate=TF32X3_FLOP_PER_S)
    nl = int(n_live[0])
    scattered = torch.zeros_like(k6)
    scattered.view(m // bm, bm, n // bn, bn)[
        ii[:nl].long(), :, jj[:nl].long(), :] = k7[:nl]
    check(splits > 1 and torch.equal(scattered, k6),
          f"K7 scattered is bit-equal to K6 at {splits} splits")
    for schedule in ("compact", "predicated"):
        spec = ops.GemmSpec(block=block, schedule=schedule,
                            epilogue=("sigma_prime",))
        got = ops.sparse_gemm(a, b, (om, am, bmk), spec, epilogue_mult=mult)
        check(torch.equal(got, k6),
              f"K6 is bit-equal to sparse_gemm(G=1, {schedule}) at "
              f"{splits} splits")

    # A capacity-limited compact dispatch counts fallback:queue_overflow on
    # the card exactly as on the CPU, with no host sync in the dispatch.
    g, m, k, n, block = 2, 333, 250, 77, (8, 16, 8)
    a, b, om, am, bmk, mult = gemm_case(g, m, k, n, block)
    spec = ops.GemmSpec(block=block, groups=g, schedule="compact",
                        epilogue=("sigma_prime", "bitmap_emit"),
                        emit_gran=(2, 4),
                        max_active_blocks=int(om.sum()) // 2)
    counted = {}
    for where in ("cpu", "cuda"):
        stats.reset()
        args = [x.to(where) for x in (a, b, om, am, bmk, mult)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = ops.sparse_gemm(*args[:2], tuple(args[2:5]), spec,
                                  epilogue_mult=args[5])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counted[where] = (stats.counts(), res)
    stats.reset()
    (c_cpu, (o_cpu, b_cpu)), (c_gpu, (o_gpu, b_gpu)) = \
        counted["cpu"], counted["cuda"]
    print(f"overflowing dispatch counts: cpu {c_cpu} card {c_gpu}",
          flush=True)
    check(c_gpu == c_cpu and c_gpu.get("fallback:queue_overflow") == 1,
          "fallback:queue_overflow counted once on the card, as on the CPU, "
          "with no host sync in the dispatch")
    err, _, ok = rel_err(o_gpu.cpu(), o_cpu)
    check(ok and torch.equal(b_gpu.cpu(), b_cpu),
          "the overflowing dispatch matches the CPU run")

    # The shapes of phase 6's networks, as their own step gives them: one
    # IN_OUT_WR step of each from phase 6's weights and batch, in which
    # every K1 encode, every K2 queue and every GEMM dispatch (K2 -> K3,
    # with the split-K reduce and the NaN fix-up where the plan has them)
    # is held against its plain version on the same inputs as it returns.
    # The first call of each shape is timed.  The role is read from the
    # order: a layer's first dispatch is its forward, a transposed A its WG.
    for net in NEW_NETS:
        audit_step(dev, net, report, encoder_detail)
    bf16_cases(dev, report, encoder_detail, time_ms, gemm_case)
    REPORTERS[:] = [report, encoder_detail]
    # The overflowing dispatch above left a device overflow flag pending
    # for the autotune cache; phase 7 starts from a fresh cache.
    from repro_torch.kernels import autotune
    autotune.reset()
    return rows


def bf16_cases(dev, report, detail, time_ms, gemm_case):
    """K1, K5 and the masked GEMM (compact and predicated) at VGG16 conv4's
    dX shape with bf16 operands and bf16 outputs, against their plain
    versions.  On the card the wrappers widen bf16 operands to f32 and
    launch the f32 kernels; ``widen_ms`` is that widening alone, beside the
    f32 cases of the same shape above.  A bf16 output is the f32 result
    rounded once, so it is held to the f32 rule plus one bf16 rounding step
    (2^-8 of each element); bitmaps exactly."""
    import torch
    from repro_torch.kernels import bitmap_scan as k5
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import relu_encode as re_

    bf = torch.bfloat16
    m, n = 100352, 128
    z = torch.randn(m, n, device=dev).to(bf)
    for gran in ((1, 128), (8, 16)):
        y, bits = re_.relu_encode(z, gran)
        yp, bp = re_.relu_encode_plain(z, gran)
        ok = y.dtype == bf and torch.equal(y, yp) and torch.equal(bits, bp)
        report("relu_encode", f"conv4 dX-shaped {m}x{n} bf16 gran {gran}",
               float((y.float() - yp.float()).abs().max()), ok,
               time_ms(lambda: re_.relu_encode(z, gran)),
               time_ms(lambda: re_.relu_encode_plain(z, gran)),
               time_ms(lambda: torch.relu(z)),
               4.0 * m * n + 4.0 * bits.numel(), 0.0,
               plan={"widen_ms": time_ms(lambda: z.float())})
        s_ = k5.bitmap_scan(z, gran)
        sp = k5.bitmap_scan_plain(z, gran)
        report("bitmap_scan", f"conv4 dX-shaped {m}x{n} bf16 gran {gran}",
               0.0 if torch.equal(s_, sp) else 1.0, torch.equal(s_, sp),
               time_ms(lambda: k5.bitmap_scan(z, gran)),
               time_ms(lambda: k5.bitmap_scan_plain(z, gran)),
               time_ms(lambda: z.ne(0)),
               2.0 * m * n + 4.0 * s_.numel(), 0.0,
               plan={"widen_ms": time_ms(lambda: z.float())})

    g, m, k, n, block = 1, 100352, 1152, 128, (128, 128, 128)
    # the masks of the f32 conv4 dX case (no B mask)
    a, b, om, am, bmk, mult = gemm_case(g, m, k, n, block, b_mask=False)
    a16, b16 = a.to(bf), b.to(bf)
    emit = (1, 128)
    widen_ms = time_ms(lambda: (a16.float(), b16.float()))
    n_bits = m * (n // emit[1])
    flops, with_mult = gemm_traffic((g, m, k, n), block, om, am, bmk, mult,
                                    torch.empty(n_bits))
    _, f32_ops = gemm_traffic((g, m, k, n), block, om, am, bmk, None, None)
    # bf16 operands and output (2 bytes), the f32 multiplier and bits
    bytes_ = (f32_ops - 4.0 * m * n) / 2 + 2.0 * m * n \
        + (with_mult - f32_ops)
    for schedule in ("compact", "predicated"):
        spec = ops.GemmSpec(block=block, schedule=schedule,
                            epilogue=("sigma_prime", "bitmap_emit"),
                            emit_gran=emit, out_dtype=bf)
        masks = (om[0], am[0], None)

        def run():
            return ops.sparse_gemm(a16[0], b16[0], masks, spec,
                                   epilogue_mult=mult[0])
        got, bits = run()
        want32, want_bits = mm.grouped_masked_matmul_plain(
            a16, b16, om, am, bmk, block=block, epilogue_mult=mult,
            emit_gran=emit, out=torch.zeros(g, m, n, device=dev),
            bits=torch.zeros(g, m, n // emit[1], dtype=torch.int32,
                             device=dev))
        # the f32 result rounded once: against the plain f32 sum (two f32
        # sums in different orders may round to neighbouring bf16 values)
        want = want32[0]
        diff = (got.float() - want).abs()
        limit = KERNEL_RTOL * float(want.abs().max()) + want.abs() * 2 ** -8
        ok = got.dtype == bf and bool((diff <= limit).all()) \
            and torch.equal(bits, want_bits[0])
        report(f"{schedule}_gemm", f"conv4 dX 100352x1152x128 bf16 "
               f"operands, bf16 out ({schedule} dispatch)",
               float(diff.max()), ok, time_ms(run),
               time_ms(lambda: mm.grouped_masked_matmul_plain(
                   a16, b16, om, am, bmk, block=block, epilogue_mult=mult,
                   emit_gran=emit, out=torch.zeros(g, m, n, device=dev),
                   bits=torch.zeros(g, m, n // emit[1], dtype=torch.int32,
                                    device=dev))),
               time_ms(lambda: torch.matmul(a16[0], b16[0])), bytes_, flops,
               float(diff.max()) / max(float(want.abs().max()), 1e-30),
               {"widen_ms": widen_ms}, flop_rate=BF16_FLOP_PER_S)


@contextlib.contextmanager
def held_against_plain(dev, tag, report=None, detail=None):
    """Inside the block every GEMM dispatch, K2 queue and K1 encode is held
    against its plain version on the same inputs as it returns; the first
    call of each shape is timed and reported (``report`` prints a kernel
    line, ``detail`` an encoder's plan), labelled ``tag``.  Without
    ``report`` nothing is timed: every call is only held and checked.
    A GEMM's zeros sit where its plain version's do, but for one cell an
    output block that may be 0 on one side and within KERNEL_RTOL of
    max|plain| on the other: a sum that cancels to 0 in one order and not
    in the other (the standard tile sums on the tensor cores, in k8 steps,
    the plain version in f32 FMA), such cells counted in the check's line
    and in ``held["zeros_apart"]``.  Yields (held:
    the calls held per kind and the zeros apart, schedules: dispatches per (schedule, block),
    live: (case, live share of the output tiles, of A's blocks, of B's
    blocks, share of the dense FLOPs) per timed GEMM)."""
    import torch
    from repro_torch.kernel_times import event_ms as time_ms
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops, shapes, stats
    from repro_torch.kernels import queue_builder as qb
    from repro_torch.kernels import relu_encode as re_

    schedules, live = {}, []
    real_dispatch, real_queue = ops._dispatch, ops.build_queue
    real_encode = re_.relu_encode
    seen, timing = set(), []
    held = {"gemm": 0, "queue": 0, "encode": 0, "zeros_apart": 0}

    def once(key):
        new = key not in seen
        seen.add(key)
        return new

    def plain_dispatch(a, b, masks, spec, mult):
        g, m, k = a.shape
        n = b.shape[2]
        ni, nk, nj = shapes.grid_shape((m, k, n), spec.block)

        def pad(x, *s):
            return None if x is None \
                else shapes.pad_mask3(x, g, *s).contiguous()
        emit = spec.emit_gran if spec.emits_bitmap else None
        return mm.grouped_masked_matmul_plain(
            a, b, pad(masks.out, ni, nj), pad(masks.a, ni, nk),
            pad(masks.b, nk, nj), block=spec.block,
            epilogue_mult=None if mult is None else mult.float(),
            emit_gran=emit, out=torch.zeros(g, m, n, device=dev),
            bits=None if emit is None else torch.zeros(
                g, -(-m // emit[0]), -(-n // emit[1]),
                dtype=torch.int32, device=dev))

    def dispatch(a, b, masks, spec, mult):
        out, bits = real_dispatch(a, b, masks, spec, mult)
        if timing:
            return out, bits
        layer = stats.current_layer()
        again = stats.recomputing()      # under cfg.remat: the forward again
        role = "FP" if once(("layer", layer, again)) else \
            "WG" if a.stride(-1) != 1 else "dX"
        g, m, k = a.shape
        n = b.shape[2]
        want, want_bits = plain_dispatch(a, b, masks, spec, mult)
        err, rel, ok = rel_err(out, want)
        apart = (out == 0) != (want == 0)
        near, per_block = 0.0, 0
        if bool(apart.any()):
            near = float(torch.maximum(out.abs(), want.abs())[apart].max())
            at = apart.nonzero()
            at[:, 1] //= spec.block[0]
            at[:, 2] //= spec.block[2]
            per_block = int(torch.unique(at, dim=0,
                                         return_counts=True)[1].max())
        scale = max(float(want.nan_to_num(0.0).abs().max()), 1e-30)
        ok = ok and (per_block == 0 or (
            per_block == 1 and near <= KERNEL_RTOL * scale))
        ok = ok and (bits is None or torch.equal(bits, want_bits))
        zeros_apart = (f"; {int(apart.sum())} zeros apart, at most "
                       f"{per_block} an output block, the largest "
                       f"{near / scale:.1e} of max|plain|"
                       if per_block else "")
        held["zeros_apart"] += int(apart.sum())
        held["gemm"] += 1
        sched = (spec.schedule, spec.block)
        schedules[sched] = schedules.get(sched, 0) + 1
        kname = {"compact": "compact_gemm",
                 "predicated": "predicated_gemm"}.get(spec.schedule,
                                                      "dense_schedule")
        emit = spec.emit_gran if spec.emits_bitmap else None
        plan = {"path": mm.gemm_path(g, m, k, n, spec.block),
                "splits": mm.split_plan(g, m, k, n, spec.block),
                "block": spec.block, "emit_gran": emit}
        case = (f"{tag} {layer} {role}{' recomputed' if again else ''} "
                f"{g}x{m}x{k}x{n}"
                + (" sigma-prime" if mult is not None else "")
                + ("" if emit is None else f" emit {emit}"))
        if report is None or not once((
                "gemm", g, m, k, n, spec.block, spec.schedule, emit,
                mult is None, tuple(x is None for x in masks))):
            check(ok, f"{kname} {case} matches its plain version "
                  f"({rel:.2e} of max|plain|{zeros_apart})")
            return out, bits
        ni, nk, nj = shapes.grid_shape((m, k, n), spec.block)
        om = shapes.pad_mask3(masks.out, g, ni, nj, device=dev)
        am, bmk = (None if x is None else shapes.pad_mask3(x, g, *s)
                   for x, s in ((masks.a, (ni, nk)), (masks.b, (nk, nj))))
        flops, bytes_ = gemm_traffic((g, m, k, n), spec.block, om, am,
                                     bmk, mult, bits)
        live.append((case, float(om.float().mean()),
                     None if am is None else float(am.float().mean()),
                     None if bmk is None else float(bmk.float().mean()),
                     flops / (2.0 * g * m * k * n)))
        timing.append(True)
        try:
            report(kname, case + f" ({spec.schedule} dispatch, block "
                   f"{spec.block})", err,
                   ok, time_ms(lambda: real_dispatch(a, b, masks, spec,
                                                     mult)),
                   time_ms(lambda: plain_dispatch(a, b, masks, spec,
                                                  mult)),
                   time_ms(lambda: torch.matmul(a, b)), bytes_, flops,
                   rel, plan, flop_rate=TF32X3_FLOP_PER_S
                   if plan["path"] == mm.STANDARD else F32_FLOP_PER_S)
        finally:
            timing.clear()
        return out, bits

    def queue(bitmap, *, capacity, builder="prefix_sum"):
        if timing:                 # uncounted: K2 alone
            return qb.build_queue_kernel(bitmap, capacity=capacity)
        got = real_queue(bitmap, capacity=capacity, builder=builder)
        want = qb.build_queue_plain(bitmap, capacity)
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        held["queue"] += 1
        case = f"{tag} {stats.current_layer()} {bitmap.shape[0]}x" \
            f"{bitmap.shape[1]} cap {capacity}"
        if report is None or not once(("queue", tuple(bitmap.shape),
                                       capacity)):
            check(ok, f"queue_builder {case} matches its plain version")
            return got
        report("queue_builder", case, 0.0 if ok else 1.0, ok,
               time_ms(lambda: qb.build_queue_kernel(
                   bitmap, capacity=capacity)),
               time_ms(lambda: qb.build_queue_plain(bitmap, capacity)),
               time_ms(lambda: torch.nonzero(bitmap)),
               4.0 * bitmap.numel() + 8.0 * capacity + 4.0, 0.0)
        return got

    def encode(z, gran):
        y, bits = real_encode(z, gran)
        yp, bp = re_.relu_encode_plain(z, gran)
        ok = torch.equal(y, yp) and torch.equal(bits, bp)
        held["encode"] += 1
        case = f"{tag} {stats.current_layer()} input " \
            f"{z.shape[0]}x{z.shape[1]} gran {gran}"
        if report is None:
            check(ok, f"relu_encode {case} matches its plain version")
            return y, bits
        report("relu_encode", case, float((y - yp).abs().max()), ok,
               time_ms(lambda: real_encode(z, gran)),
               time_ms(lambda: re_.relu_encode_plain(z, gran)),
               time_ms(lambda: torch.relu(z)),
               8.0 * z.numel() + 4.0 * bits.numel(), 0.0,
               plan=detail(z, gran, y,
                                   lambda: real_encode(z, gran),
                                   lambda: torch.relu(z)))
        return y, bits

    ops._dispatch, ops.build_queue, re_.relu_encode = \
        dispatch, queue, encode
    try:
        yield held, schedules, live
    finally:
        ops._dispatch, ops.build_queue, re_.relu_encode = \
            real_dispatch, real_queue, real_encode


def audit_step(dev, net, report, detail, policy=None, state=None, **geom):
    """One IN_OUT_WR step of ``net`` (phase 6's weights and batch, or
    ``state`` = (model, params, img, labels)) under ``policy`` (default
    ``IN_OUT_WR`` on the kernels) with every K1 encode, K2 queue and GEMM
    dispatch in it held against its plain version (``held_against_plain``).
    Returns the dispatches held per (schedule, block)."""
    import torch
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.kernels import stats
    from repro_torch.models.cnn import param_leaves

    model, params, img, labels = state or new_net(dev, net, **geom)
    params = clone_params(params)
    policy = policy or IN_OUT_WR.with_(kernel_impl="pallas")
    leaves = param_leaves(params)
    stats.reset()
    with held_against_plain(dev, net, report, detail) as (held, schedules,
                                                           _):
        loss = model.loss(params, img, labels, policy)
        torch.autograd.grad(loss, list(leaves.values()))
    c, e = stats.counts(), stats.elided()
    r = ran_counts(c, e)
    stats.reset()
    print(f"{net} step audit: {held}; the step's counts {c}, elided {e}",
          flush=True)
    check(held["gemm"] == _sum(r, "gemm:") > 0
          and held["queue"] == r.get("queue:prefix_sum", 0)
          and held["encode"] == r.get("encode:act"),
          f"{net} step audit held every dispatch, queue and encode "
          f"against its plain version")
    return schedules


# ---------------------------------------------------------------------------
# Phases 4 and 5: end to end
# ---------------------------------------------------------------------------

def clone_params(params):
    return {layer: {k: v.detach().clone().requires_grad_(True)
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}


def perturb_batchnorm(params, seed):
    """BN scale += BN_SCALE_SD * N(0, 1), bias += BN_BIAS_SD * N(0, 1),
    drawn on the CPU from ``seed`` (see BN_SCALE_SD)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for leaves in params.values():
            for name, sd in (("bn_scale", BN_SCALE_SD),
                             ("bn_bias", BN_BIAS_SD)):
                if name in leaves:
                    noise = torch.randn(leaves[name].shape, generator=gen)
                    leaves[name].add_(sd * noise.to(leaves[name].device))
    return params


def dense_f64_step(model, params, img, labels, masks=None):
    """The same step in plain float64 PyTorch (cuDNN convolutions, its own
    padding, pools and BatchNorm: no code of the port's model or engine):
    returns the loss, the gradients keyed like ``param_leaves`` and the
    post-ReLU activation of each conv layer and of each add merge.  With
    ``masks`` (captured activations keyed the same way) every ReLU keeps
    exactly the elements that are positive in ``masks``: the float64 step
    then takes the same σ′ decisions as the step that gave the masks."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.cnn import Branch, ConvNode, PoolNode, \
        param_leaves

    def same_pad(h, r, stride, padding):      # JAX's SAME/VALID, (lo, hi)
        if padding == "VALID":
            return 0, 0
        total = max((-(-h // stride) - 1) * stride + r - h, 0)
        return total // 2, total - total // 2

    p64 = {layer: {k: v.detach().double().requires_grad_(True)
                   for k, v in leaves.items()}
           for layer, leaves in params.items()}
    caps = {}

    def conv(x, node):
        p = p64[node.name]
        _, h, w, c = x.shape
        r = p["w"].shape[0]
        hlo, hhi = same_pad(h, r, node.stride, node.padding)
        wlo, whi = same_pad(w, r, node.stride, node.padding)
        xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi)).permute(0, 3, 1, 2)
        x = F.conv2d(xp, p["w"].permute(3, 2, 0, 1), stride=node.stride,
                     groups=c if node.depthwise else 1).permute(0, 2, 3, 1)
        if node.has_bn:                       # batch statistics over N, H, W
            mu = x.mean(dim=(0, 1, 2), keepdim=True)
            var = ((x - mu) ** 2).mean(dim=(0, 1, 2), keepdim=True)
            x = (x - mu) / torch.sqrt(var + 1e-5) * p["bn_scale"] \
                + p["bn_bias"]
        return x

    def pool(x, node):                        # JAX's SAME reduce_window
        _, h, w, _ = x.shape
        hlo, hhi = same_pad(h, node.size, node.stride, "SAME")
        wlo, whi = same_pad(w, node.size, node.stride, "SAME")
        fill = float("-inf") if node.kind == "max" else 0.0
        xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=fill)
        xp = xp.permute(0, 3, 1, 2)
        y = F.max_pool2d(xp, node.size, node.stride) if node.kind == "max" \
            else F.avg_pool2d(xp, node.size, node.stride)
        return y.permute(0, 2, 3, 1)

    def relu(x, name):
        if masks is None:
            return torch.relu(x)
        return x * (masks[name] > 0).to(x.device, torch.float64)

    def run(nodes, x, pending):
        # pending: the name of the node whose output x is, while its ReLU
        # is still to be applied (else None)
        for node in nodes:
            if isinstance(node, ConvNode):
                x = conv(relu(x, pending) if pending else x, node)
                pending = node.name if node.relu_after else None
                caps[node.name] = relu(x, pending) if pending else x
            elif isinstance(node, PoolNode):
                x, pending = pool(relu(x, pending) if pending else x,
                                  node), None
            elif isinstance(node, Branch):
                if pending:
                    x, pending = relu(x, pending), None
                outs = []
                for path in node.paths:
                    y, y_pending = run(path, x, None)
                    outs.append(relu(y, y_pending) if y_pending else y)
                if node.merge == "concat":
                    x = torch.cat(outs, -1)
                else:
                    x = outs[0]
                    for y in outs[1:]:
                        x = x + y
                    caps[node.name] = relu(x, node.name)
                    pending = node.name
            else:
                raise ValueError(f"dense_f64_step: unknown node {node}")
        return x, pending

    x, pending = run(model.layers, img.double(), None)
    if pending:
        x = relu(x, pending)
    logp = torch.log_softmax(x.mean(dim=(1, 2)) @ p64["head"]["w"], dim=-1)
    loss = -logp.gather(1, labels.long()[:, None]).mean()
    leaves = param_leaves(p64)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads)), caps


def rel_l2(g, want):
    """|g - want| / |want| in float64, L2 over the whole leaf."""
    return float((g.double() - want).norm() / want.norm())


def grad_verdicts(net, grads, grads_x, g64, order, top):
    """Each leaf of a step's gradients against the dense xla_ref step and,
    in a BN net (``g64`` given: the float64 step under this step's own
    ReLU masks), against that float64 step: ``(name, f64_rule, ok,
    message, reading)``, the reading being the leaf's distance in its
    rule's norm.  Leaves at or below the highest flipped layer (index
    ``top`` in ``order``) take the float64 rule in a BN net and
    STEP_RTOL_FLIPPED otherwise; those above take KERNEL_RTOL."""
    out = []
    for name, gx in grads_x.items():
        gp = grads[name]
        err = float((gp - gx).abs().max()) / max(float(gx.abs().max()),
                                                 1e-30)
        layer = name.split("/")[0]
        below = layer in order and order.index(layer) <= top
        if below and g64 is not None:
            l2 = rel_l2(gp, g64[name])
            out.append((name, True, l2 <= KERNEL_RTOL,
                        f"{net} grad {name}: |g - g64|/|g64| = {l2:.3e} <= "
                        f"{KERNEL_RTOL:g} (the float64 step under its own "
                        f"masks; max|diff|/max|g| against xla_ref "
                        f"{err:.3e})", l2))
            continue
        rtol = STEP_RTOL_FLIPPED if below else KERNEL_RTOL
        out.append((name, False, err <= rtol,
                    f"{net} grad {name}: max|diff|/max|g| = {err:.3e} <= "
                    f"{rtol:g} ({'at or below' if below else 'above'} the "
                    f"highest flip)", err))
    return out


def control_grads(kind, model, params, img, labels, policy,
                  layer=CONTROL_LAYER):
    """The first step's gradients with a planted fault (see CONTROLS) in
    ``layer``'s fused dX GEMM."""
    import torch
    from repro_torch.core import sparse_conv, sparse_linear
    from repro_torch.kernels import stats
    from repro_torch.models.cnn import param_leaves

    real = sparse_linear._mm

    def bf16(t):
        return t.to(torch.bfloat16).to(t.dtype)

    def planted(a, b, *args, epilogue=None, **kw):
        if kind == "bf16_operands":
            return real(bf16(a), bf16(b), *args, epilogue=epilogue, **kw)
        # The fused dX GEMM of ``layer``: the only _mm call with a σ′
        # epilogue in that layer's backward.
        if epilogue is None or stats.current_layer() != layer \
                or kind == "none":
            return real(a, b, *args, epilogue=epilogue, **kw)
        if kind == "sigma_prime_dropped":
            return real(a, b, *args, **kw)
        res = real(a, b, *args, epilogue=epilogue, **kw)
        out = res[0] if isinstance(res, tuple) else res
        if out.dim() == 2:                    # a G = 1 layer: (M, N)
            out = out[None]
        spec = kw.get("spec") or args[3].gemm_spec()
        bm, _, bn = spec.block                # live_tile_skipped
        live = out[:, :bm, :bn].flatten(1).ne(0).any(dim=1).nonzero()
        out[int(live[0]), :bm, :bn] = 0
        return res

    leaves = param_leaves(params)
    sparse_linear._mm = sparse_conv._mm = planted
    try:
        loss = model.loss(params, img, labels, policy)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        sparse_linear._mm = sparse_conv._mm = real
    return dict(zip(leaves, grads))


def hold_first_step(net, model, init, img, labels, loss_p, grads_p, scan,
                    bn):
    """A path's first step (loss ``loss_p``, gradients ``grads_p``) against
    the same step on the dense xla_ref schedule: the loss, the σ′ flips
    between the two forwards and the gradient rules of ``grad_verdicts``.
    In a BN net (``bn``) the leaves at or below the highest flip are held
    to a float64 step under the step's own ReLU masks (see KERNEL_RTOL's
    notes).  Returns ``(grads_x, g64, order, top)`` for ``run_controls``."""
    import torch
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.models.cnn import param_leaves

    dev = img.device
    leaves = param_leaves(init)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss_x = model.loss(init, img, labels, IN_OUT_WR.with_(
        kernel_impl="xla_ref"))
    grads_x = dict(zip(leaves, torch.autograd.grad(
        loss_x, list(leaves.values()))))
    torch.cuda.synchronize(dev)
    print(f"{net} xla_ref step: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    loss_x = float(loss_x.detach())
    check(abs(loss_p - loss_x) <= 1e-5 * abs(loss_x),
          f"{net} step 1 loss {loss_p:.7f} vs xla_ref {loss_x:.7f}")
    # σ′ flips: activations positive in one forward and not in the other.
    caps = {}
    with torch.no_grad():
        for impl in ("pallas", "xla_ref"):
            caps[impl] = {}
            model.apply(init, img, IN_OUT_WR.with_(
                kernel_impl=impl, scan_signed_inputs=scan),
                capture=caps[impl])
    flips = {k: int(((v > 0) != (caps["xla_ref"][k] > 0)).sum())
             for k, v in caps["pallas"].items()}
    n_act = sum(v.numel() for v in caps["pallas"].values())
    n_flip = sum(flips.values())
    print(f"{net} ReLU sign flips pallas vs xla_ref: {n_flip} of {n_act} "
          f"activations {flips}", flush=True)
    check(n_flip <= FLIP_SHARE * n_act,
          f"{net} sign flips {n_flip} <= {FLIP_SHARE} x {n_act} activations")
    order = list(caps["pallas"])
    flipped = [order.index(k) for k, n in flips.items() if n]
    top = max(flipped) if flipped else -1
    print(f"{net} highest flipped layer: "
          + (order[top] if flipped else "none"), flush=True)
    g64 = None
    if bn:
        loss64, g64_u, caps64 = dense_f64_step(model, init, img, labels)
        f64 = {impl: sum(int(((v > 0) != (caps64[k] > 0)).sum())
                         for k, v in caps[impl].items()) for impl in caps}
        print(f"{net} float64 step loss {loss64:.9f}; sign flips against "
              f"float64 {f64}", flush=True)
        g64 = dense_f64_step(model, init, img, labels,
                             masks=caps["pallas"])[1]
        # What the flips alone do: the f32 step against the float64 step
        # under no masks, beside that float64 step against itself under
        # the f32 step's masks.
        for name, gp in grads_p.items():
            if name.split("/")[0] in order[:top + 1]:
                print(f"{net} flip witness {name}: against the unmasked "
                      f"float64 step {rel_l2(gp, g64_u[name]):.3e}; the "
                      f"float64 step under the step's masks "
                      f"{rel_l2(g64[name], g64_u[name]):.3e}", flush=True)
    for _, _, ok, what, _ in grad_verdicts(net, grads_p, grads_x, g64, order,
                                           top):
        check(ok, what)
    return grads_x, g64, order, top


def run_controls(net, model, init, img, labels, scan, held, layer):
    """The first step again with each CONTROLS fault planted in ``layer``:
    every fault must fail the float64 rule on some leaf, and nothing
    planted must fail it on none."""
    from repro_torch.core.policy import IN_OUT_WR

    grads_x, g64, order, top = held
    rule = "float64 rule"
    pol = IN_OUT_WR.with_(kernel_impl="pallas", scan_signed_inputs=scan)
    for kind in CONTROLS:
        v = [(ok, what, x) for _, f64_rule, ok, what, x in grad_verdicts(
            net, control_grads(kind, model, init, img, labels, pol, layer),
            grads_x, g64, order, top)
            if f64_rule]
        bad = [what for ok, what, _ in v if not ok]
        print(f"{net} control {kind} in {layer}: the {rule} fails "
              f"{len(bad)} of {len(v)} leaves; largest reading "
              f"{max(x for _, _, x in v):.3e}", flush=True)
        for what in bad[:6]:
            print("    " + what, flush=True)
        check(bool(bad) == (kind != "none"),
              f"{net} control {kind}: "
              + (f"passes the {rule}" if kind == "none"
                 else f"rejected by the {rule}"))


def _sum(c, prefix):
    return sum(v for k, v in c.items() if k.startswith(prefix))


def ran_counts(counts, elided):
    """The counts of what ran: a dispatch whose result autograd does not
    read (``stats.elided``) is counted as the reference counts it, and
    launches nothing."""
    return {k: v - elided.get(k, 0) for k, v in counts.items()}


def image_dx_elided(scenario):
    """What a CNN step elides: the first conv's dX (the image requires no
    gradient), with its emit and, when compact, its queue."""
    sched = SCHEDULE[scenario]
    out = {f"gemm:{sched}:1": 1, "emit:grad": 1}
    if sched == "compact":
        out["queue:prefix_sum"] = 1
    return out


def launch_contract(rec, scenario, tag):
    """Every launch counter equals its dispatches that ran (counted less
    elided); the elided one is the image's dX; the schedule ran."""
    c, launches, e = rec["counts"], rec["launches"], rec["elided"]
    r = ran_counts(c, e)
    check(math.isfinite(rec["loss"]), f"{tag}: loss {rec['loss']} finite")
    check(e == image_dx_elided(scenario),
          f"{tag}: elided only the first conv's dX ({e})")
    check(c.get("emit:grad", 0) >= 1, f"{tag}: emit:grad >= 1")
    check(launches.get("relu_encode", 0) == c.get("encode:act", 0),
          f"{tag}: relu_encode launches == encode:act ({launches})")
    check(launches.get("bitmap_scan", 0) == _sum(c, "scan_pallas:"),
          f"{tag}: bitmap_scan launches == scan_pallas:*")
    check(launches.get("queue_builder", 0) == r.get("queue:prefix_sum", 0),
          f"{tag}: queue_builder launches == queue:prefix_sum - elided")
    check(launches.get("compact_gemm", 0) == _sum(r, "gemm:compact:"),
          f"{tag}: compact_gemm launches == gemm:compact:* - elided")
    check(launches.get("predicated_gemm", 0) == _sum(r, "gemm:predicated:"),
          f"{tag}: predicated_gemm launches == gemm:predicated:* - elided")
    check(launches.get("splitk_reduce", 0) <= _sum(r, "gemm:compact:")
          + _sum(r, "gemm:predicated:"),
          f"{tag}: splitk_reduce launches <= K3/K4 dispatches that ran")
    check(launches.get("emit_nan_fixup", 0) == r.get("emit:grad", 0),
          f"{tag}: emit_nan_fixup launches == emit:grad - elided")
    if scenario == "IN_OUT_WR":
        check(c.get("queue:prefix_sum", 0) == _sum(c, "gemm:compact:") > 0,
              f"{tag}: queue:prefix_sum == gemm:compact:*")
    else:
        check(_sum(c, "gemm:predicated:") > 0,
              f"{tag}: predicated GEMMs dispatched")


def vgg16_contract(rec, scenario, tag):
    c = rec["counts"]
    launch_contract(rec, scenario, tag)
    check(c.get("encode:act") == 8, f"{tag}: encode:act == 8 ({c})")
    check(c.get("registry:hit") == 8, f"{tag}: registry:hit == 8")
    check(not any(k.startswith("scan") for k in c), f"{tag}: no scan:*")
    check(_sum(c, "gemm:") == c.get(f"gemm:{SCHEDULE[scenario]}:1"),
          f"{tag}: every GEMM at G = 1")


def mobilenet_contract(rec, scenario, tag):
    c = rec["counts"]
    launch_contract(rec, scenario, tag)
    check(c.get("encode:act") == 26, f"{tag}: encode:act == 26 ({c})")
    check(c.get("scan_pallas:act") == 2, f"{tag}: scan_pallas:act == 2")
    check(_sum(c, "gemm:") == 84, f"{tag}: 84 GEMM dispatches")
    grouped = _sum(c, "gemm:") - c.get(f"gemm:{SCHEDULE[scenario]}:1", 0)
    check(grouped == 39, f"{tag}: 39 grouped GEMMs (13 depthwise x 3)")
    check(c.get("conv:dense_fallback", 0) == 0,
          f"{tag}: conv:dense_fallback == 0")


SCHEDULE = {"IN_OUT_WR": "compact", "IN_OUT": "predicated"}
# Each path's kernels: the main-path run must launch every one of them.
PATHS = {"vgg16": (vgg16_contract, False, None,
                   ("relu_encode", "queue_builder", "compact_gemm",
                    "predicated_gemm", "splitk_reduce", "emit_nan_fixup")),
         "mobilenet": (mobilenet_contract, True, 1,
                       ("relu_encode", "queue_builder", "compact_gemm",
                        "predicated_gemm", "splitk_reduce", "bitmap_scan",
                        "queue_member", "emit_nan_fixup"))}


def end_to_end(dev, net, image_size=224, width=1.0, num_classes=1000,
               batch=8):
    """Drive one path at full width; returns its launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.cnn_training import train_steps
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn

    contract, scan, bn_seed, path_kernels = PATHS[net]
    geom = dict(net=net, image_size=image_size, width=width,
                num_classes=num_classes, batch=batch, device=dev,
                scan_signed_inputs=scan)
    model = build_cnn(net, image_size=image_size, width=width,
                      num_classes=num_classes)
    params = model.init(0, device=dev)
    if bn_seed is not None:
        perturb_batchnorm(params, bn_seed)
    init = clone_params(params)
    io_params = clone_params(params)
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
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    for i, rec in enumerate(wr["steps"]):
        tag = f"{net} IN_OUT_WR step {i}"
        print(f"{tag}: loss {rec['loss']:.6f} {rec['seconds'] * 1e3:.1f} ms "
              f"counts {rec['counts']} launches {rec['launches']}",
              flush=True)
        print(f"{tag} ReLU live fraction: " + json.dumps(
            {k: round(v, 4) for k, v in rec["relu_live"].items()}),
              flush=True)
        contract(rec, "IN_OUT_WR", tag)
        loss0 = wr["steps"][0]["loss"]
        check(rec["loss"] <= LOSS_GROWTH * loss0,
              f"{tag}: loss {rec['loss']:.4f} <= {LOSS_GROWTH} x step 0's "
              f"{loss0:.4f}")
    rec = io["steps"][0]
    print(f"{net} IN_OUT step 0: loss {rec['loss']:.6f} "
          f"{rec['seconds'] * 1e3:.1f} ms counts {rec['counts']} "
          f"launches {rec['launches']}", flush=True)
    contract(rec, "IN_OUT", f"{net} IN_OUT step 0")
    for name in path_kernels:
        check(launches[name] > 0,
              f"{net} main path launched {name} ({launches[name]} times)")
    step_ms = statistics.median(r["seconds"] * 1e3 for r in wr["steps"][1:])
    STEP_MS[net] = step_ms
    print(f"{net} IN_OUT_WR median step ms (steps 2-3): {step_ms:.1f}; "
          f"main path {main_s:.1f} s; peak memory {peak_gb:.2f} GiB",
          flush=True)

    img, labels = image_batch(0, 0, batch=batch, image_size=image_size,
                              num_classes=num_classes, device=dev)
    held = hold_first_step(net, model, init, img, labels,
                           wr["steps"][0]["loss"], wr["first_grads"], scan,
                           bn_seed is not None)
    if bn_seed is not None:
        # The float64 rule must see a fault: each planted one is rejected
        # by it, on every conv layer's leaves, and the same harness with
        # nothing planted is not.
        grads_x, g64, order, _ = held
        run_controls(net, model, init, img, labels, scan,
                     (grads_x, g64, order, len(order) - 1), CONTROL_LAYER)
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the three other networks, the captures, the ops, the tables
# ---------------------------------------------------------------------------

# Each new path's kernels: the path's run must launch every one of them.
NEW_NETS = ("googlenet", "resnet18", "densenet121")
BN_NETS = ("resnet18", "densenet121")
# In these two BN nets, as in MobileNet, the float64 rule measures each
# f32 step against a float64 step under that step's own ReLU masks.  Their
# flips are few (7 in ResNet-18's first step), so which elements flip
# decides the distance to an unmasked float64 step: one flip at b2conv1,
# where x̂ = -bias/scale is O(1), moved its BN scale gradient 2.8e-4 in
# relative L2 against the dense step's 4.5e-5.  The float64 rule, on every
# conv layer's leaves, must reject the CONTROLS faults, planted in a dX
# GEMM that carries σ′ (b2conv2's: b2conv1's ReLU; b2conv1's own dX feeds
# a residual sum and carries none):
BN_CONTROL_LAYER = {"resnet18": "b2conv2", "densenet121": "d3c3"}
STEP_KERNELS = ("relu_encode", "queue_builder", "compact_gemm",
                "splitk_reduce", "emit_nan_fixup")
CAPTURE_KERNELS = STEP_KERNELS + ("predicated_gemm", "queue_member")
OPS_KERNELS = ("queue_builder", "compact_gemm", "splitk_reduce")
TABLE_KERNELS = ("relu_encode", "queue_builder", "compact_gemm",
                 "predicated_gemm", "emit_nan_fixup")
# Captures under IN_OUT_WR and DC from the same weights and batches: each
# layer's density within DENSITY_ATOL after the training steps, and with no
# step taken the two zero maps differ in at most ZERO_MAP_SHARE of the
# elements (the two forwards round alike: skipped blocks add exact zeros).
DENSITY_ATOL = 1e-4
ZERO_MAP_SHARE = 1e-6
# The captured densities and modeled cycles are held to the paper's
# scenario ordering, DC >= IN >= IN_OUT >= IN_OUT_WR in total cycles.
SCENARIO_ORDER = ("DC", "IN", "IN_OUT", "IN_OUT_WR")


def launches_of(fn, *args, **kw):
    """(fn's result, the kernel launches it made): counts reset just before
    and read just after."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = fn(*args, **kw)
    return out, kernels.launch_counts()


def check_path_kernels(path, launches, names):
    for name in names:
        check(launches[name] > 0,
              f"{path} path launched {name} ({launches[name]} times)")


def new_net(dev, net, image_size=224, width=1.0, num_classes=1000,
            batch=8):
    """``net``'s model, its weights (seed 0; BN drawn off its init, see
    BN_SCALE_SD) and the first batch its training step takes."""
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn

    model = build_cnn(net, image_size=image_size, width=width,
                      num_classes=num_classes)
    params = model.init(0, device=dev)
    if net in BN_NETS:
        perturb_batchnorm(params, 1)
    img, labels = image_batch(0, 0, batch=batch, image_size=image_size,
                              num_classes=num_classes, device=dev)
    return model, params, img, labels


def network_step(dev, net, image_size=224, width=1.0, num_classes=1000,
                 batch=8):
    """One full-width IN_OUT_WR step of ``net`` through the kernels, held
    against the dense xla_ref step (and, in a BN net, a float64 step) by
    the gradient rules of phases 4-5; returns its launch counts."""
    import torch
    from repro_torch.cnn_training import train_steps

    model, params, img, labels = new_net(dev, net, image_size, width,
                                         num_classes, batch)
    init = clone_params(params)
    torch.cuda.reset_peak_memory_stats(dev)
    run, launches = launches_of(
        train_steps, net=net, steps=1, image_size=image_size, width=width,
        num_classes=num_classes, batch=batch, policy="IN_OUT_WR",
        kernel_impl="pallas", params=params, keep_first_grads=True,
        device=dev)
    rec = run["steps"][0]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    tag = f"{net} IN_OUT_WR step 0"
    print(f"{tag}: loss {rec['loss']:.6f} {rec['seconds'] * 1e3:.1f} ms "
          f"(the step's first, build and warm-up included) counts "
          f"{rec['counts']} launches {rec['launches']}; peak memory "
          f"{peak_gb:.2f} GiB", flush=True)
    c = rec["counts"]
    launch_contract(rec, "IN_OUT_WR", tag)
    check(c.get("conv:dense_fallback", 0) == 0,
          f"{tag}: conv:dense_fallback == 0")
    check(_sum(c, "gemm:") == _sum(c, "gemm:compact:") > 0,
          f"{tag}: every GEMM dispatch is gemm:compact:* ({c})")
    check_path_kernels(net, launches, STEP_KERNELS)

    bn = net in BN_NETS
    held = hold_first_step(net, model, init, img, labels, rec["loss"],
                           run["first_grads"], False,
                           bn)
    if bn:
        # Every conv layer's leaves under the float64 rule, wherever the
        # flips fell: each fault must fail that rule itself.
        grads_x, g64, order, _ = held
        run_controls(net, model, init, img, labels, False,
                     (grads_x, g64, order, len(order) - 1),
                     BN_CONTROL_LAYER[net])
    return launches


def capture_phase(dev):
    """(b) Every network captured at the full geometry under IN_OUT_WR
    through the kernels; VGG16 and ResNet-18 also under DC from the same
    weights and batches, after the steps and with none.  Returns the
    full-geometry Capture and the path's launches."""
    import dataclasses
    import numpy as np
    from repro_torch.benchmarks.common import GEOMETRIES, capture_run
    from repro_torch.benchmarks.figures import NETS

    full = dataclasses.replace(GEOMETRIES["full"], device=str(dev))

    def captures():
        runs = {}
        for net in NETS:
            t0 = time.perf_counter()
            runs[net] = capture_run(net, full)
            steps = [round(r["seconds"] * 1e3, 1) for r in runs[net].steps]
            nbytes = sum(a.nbytes for a in runs[net].acts.values())
            print(f"capture {net} ({full}): step ms {steps} (the first "
                  f"with warm-up), {time.perf_counter() - t0:.1f} s in all, "
                  f"{nbytes / 2 ** 30:.2f} GiB of activations on the host; "
                  f"density " + json.dumps(
                      {k: round(v, 4) for k, v in runs[net].dens.items()}),
                  flush=True)
        for net in ("vgg16", "resnet18"):
            dc = capture_run(net, dataclasses.replace(full, policy="DC"))
            wr_d = runs[net].dens
            worst = max(abs(dc.dens[k] - wr_d[k]) for k in wr_d)
            check(set(dc.dens) == set(wr_d) and worst <= DENSITY_ATOL,
                  f"capture {net}: per-layer density IN_OUT_WR vs DC within "
                  f"{DENSITY_ATOL:g} (worst {worst:.2e})")
            zero = {p: capture_run(net, dataclasses.replace(
                full, policy=p, train_steps=0)).acts
                for p in ("IN_OUT_WR", "DC")}
            diff = sum(int(np.count_nonzero((a == 0) != (zero["DC"][k] == 0)))
                       for k, a in zero["IN_OUT_WR"].items())
            total = sum(a.size for a in zero["IN_OUT_WR"].values())
            check(diff <= ZERO_MAP_SHARE * total,
                  f"capture {net} at train_steps=0: zero maps IN_OUT_WR vs "
                  f"DC differ in {diff} of {total} elements "
                  f"(<= {ZERO_MAP_SHARE:g})")
        return runs

    _, launches = launches_of(captures)
    check_path_kernels("captures", launches, CAPTURE_KERNELS)
    return full, launches


def ops_phase(dev, full):
    """(c) relu_bwd_masked and weight_grad_masked at VGG16 conv4's dX and
    WG shapes, with σ′ from the captured conv3 activation, against the same
    calls on CPU copies (the plain versions), with equal count dicts."""
    import torch
    from repro_torch.benchmarks.common import capture_traces
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.kernels import ops, stats

    acts, _ = capture_traces("vgg16", full)
    a3 = torch.as_tensor(acts["conv3"]).reshape(-1, acts["conv3"].shape[-1])
    sigma = (a3 != 0).to(torch.float32)                  # (100,352 x 128)
    gen = torch.Generator().manual_seed(2)
    dy = torch.relu(torch.randn(a3.shape[0], 9 * a3.shape[1],
                                generator=gen))          # (100,352 x 1,152)
    w_t = torch.randn(dy.shape[1], a3.shape[1], generator=gen) * 0.03
    x_t = a3.t().contiguous()                             # (128 x 100,352)
    spec = IN_OUT_WR.with_(kernel_impl="pallas").gemm_spec()

    def both(name, fn, *args):
        out = {}
        for d in ("cpu", dev):
            stats.reset()
            got = fn(*(t.to(d) for t in args), spec=spec)
            out[str(d)] = (got.cpu(), stats.counts())
        (plain, c_cpu), (card, c_gpu) = out["cpu"], out[str(dev)]
        err, rel, ok = rel_err(card, plain)
        print(f"op {name} {tuple(plain.shape)}: max|diff| {err:.3e} "
              f"({rel:.3e} of max|plain|); counts cpu {c_cpu} card {c_gpu}",
              flush=True)
        check(ok and c_cpu == c_gpu,
              f"op {name} on the card matches its plain version, with "
              f"equal count dicts")
        return card

    def run():
        d_pre = both("relu_bwd_masked", ops.relu_bwd_masked, dy, w_t, sigma)
        both("weight_grad_masked", ops.weight_grad_masked, x_t, d_pre)

    _, launches = launches_of(run)
    check_path_kernels("ops", launches, OPS_KERNELS)
    return launches


def tables_phase(full):
    """(d) Every table of the port's benchmarks from the full-geometry
    captures; the modeled totals in the paper's scenario order."""
    import traceback
    from repro_torch.benchmarks.common import network_totals
    from repro_torch.benchmarks.figures import ALL_FIGURES, NETS
    from repro_torch.benchmarks.run import TABLES

    from repro_torch.kernels import autotune

    def run():
        for name, fn in TABLES.items():
            t0 = time.perf_counter()
            try:
                _, derived = fn(full)
            except Exception:  # a table that raises fails the run
                traceback.print_exc()
                check(False, f"table {name} ran")
                continue
            # The figures past fig03 (captured sparsity) report the cost
            # model: modeled for the paper's accelerator, not card times.
            what = " [modeled, paper's accelerator at 667 MHz]" \
                if name in ALL_FIGURES and name != "fig03_sparsity" else ""
            print(f"table {name} ({time.perf_counter() - t0:.1f} s){what}: "
                  f"{derived}", flush=True)
        autotune.reset()      # autotune_audit leaves its session's cache
        for net in NETS:
            totals = network_totals(net, full)
            cyc = [totals[sc]["total_cycles"] for sc in SCENARIO_ORDER]
            print(f"modeled total cycles {net} (paper's accelerator, Table 1 "
                  f"at 667 MHz, traces from this card): " + json.dumps(
                      dict(zip(SCENARIO_ORDER, cyc))), flush=True)
            check(all(a >= b for a, b in zip(cyc, cyc[1:])),
                  f"{net}: modeled total cycles DC >= IN >= IN_OUT >= "
                  f"IN_OUT_WR")

    _, launches = launches_of(run)
    check_path_kernels("tables", launches, TABLE_KERNELS)
    return launches


def experiment_phase(dev):
    """Phase 6: returns the launches of each of its paths."""
    from repro_torch.benchmarks.common import clear_captures

    t0 = time.perf_counter()
    by_path = {net: network_step(dev, net) for net in NEW_NETS}
    full, by_path["captures"] = capture_phase(dev)
    by_path["ops"] = ops_phase(dev, full)
    by_path["tables"] = tables_phase(full)
    clear_captures()
    print(f"phase 6 (three networks, captures, ops, tables): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 7: guarded LM training and the autotuner
# ---------------------------------------------------------------------------

# SmolLM-360M as ``python -m repro_torch.launch.train --arch smollm-360m``
# runs it: batch 8 x 128 tokens, f32 params, AdamW.
LM_ARCH, LM_BATCH, LM_SEQ, LM_STEPS, LM_CUT = "smollm-360m", 8, 128, 6, 3
# The first step against the same step in float64 (the port's own code,
# every upcast at float64): the loss within LM_LOSS_RTOL relative, every
# gradient leaf within LM_GRAD_RTOL in relative L2 norm.  Each planted
# fault must fail the rule and the clean step must pass it.
LM_LOSS_RTOL, LM_GRAD_RTOL = 1e-5, 1e-4
LM_CONTROLS = ("none", "causal_mask_dropped", "ffn_output_scaled")
LM_CONTROL_LAYER, LM_CONTROL_SCALE = 7, 1 + 1e-3
# The resumed run against the uninterrupted one, when not bit-equal.
LM_RESUME_RTOL = 1e-6
# Phase 4's geometry.
AUTOTUNE_GEOM = dict(image_size=224, width=1.0, num_classes=1000, batch=8)


def without_remat(cfg, tag=None):
    """``cfg`` at ``remat=False``, printed under ``tag`` (a rank of a pool
    passes None but on rank 0): the LM phases 7-13 time their steps
    without the recomputation, as the runs before ``cfg.remat`` did, so
    their rows compare with those (phase 14 times both)."""
    if tag is not None:
        print(f"{tag}: remat=False", flush=True)
    return cfg.with_(remat=False)


def lm_first_step_rule(dev, cfg, tcfg):
    """The first step's loss and gradients against float64, and the rule
    against its LM_CONTROLS faults."""
    import torch
    from repro_torch import tree
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import attention, common
    from repro_torch.models.transformer import lm_init, lm_loss

    params = lm_init(tcfg.seed, cfg, dtype=torch.float32, device=dev)
    batch = lm_batch(tcfg.seed, 0, batch=LM_BATCH, seq_len=LM_SEQ,
                     vocab=cfg.vocab_size, device=dev)

    def step(p, dtype, control="none"):
        leaves = [x.detach().to(dtype).requires_grad_(True)
                  for x in tree.leaves(p)]
        tp = tree.unflatten_like(p, leaves)
        if control == "ffn_output_scaled":
            w = tp["layers"]["b0"]["ffn"]["w_down"]
            scale = torch.ones(w.shape[0], 1, 1, dtype=dtype, device=dev)
            scale[LM_CONTROL_LAYER] = LM_CONTROL_SCALE
            tp["layers"]["b0"]["ffn"]["w_down"] = w * scale
        real = attention.blockwise_attention
        if control == "causal_mask_dropped":
            attention.blockwise_attention = \
                lambda *a, **kw: real(*a, **{**kw, "causal": False})
        try:
            with common.upcast(dtype):
                loss = lm_loss(tp, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            attention.blockwise_attention = real
        return float(loss), grads

    loss64, g64 = step(params, torch.float64)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    verdicts = {}
    for control in LM_CONTROLS:
        loss32, g32 = step(params, torch.float32, control)
        loss_rel = abs(loss32 - loss64) / abs(loss64)
        rels = [float((a.double() - b).norm() / b.norm().clamp_min(1e-300))
                for a, b in zip(g32, g64)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        passed = loss_rel <= LM_LOSS_RTOL and rels[worst] <= LM_GRAD_RTOL
        verdicts[control] = passed
        print(f"smollm-360m first step vs float64 [{control}]: loss "
              f"{loss32:.7f} vs {loss64:.7f} (rel {loss_rel:.2e}); worst "
              f"gradient leaf {paths[worst]} rel L2 {rels[worst]:.2e}; "
              f"{'passes' if passed else 'fails'} the rule", flush=True)
    check(verdicts["none"], f"smollm-360m first step within "
          f"{LM_LOSS_RTOL} (loss) and {LM_GRAD_RTOL} (every gradient leaf, "
          f"relative L2) of float64")
    for control in LM_CONTROLS[1:]:
        check(not verdicts[control],
              f"the float64 rule rejects the planted {control}")


def lm_phase(dev):
    """(a) guarded SmolLM-360M training at full width: run A (6 steps, a
    StepGuard, no checkpoints), run B (3 steps into a checkpoint dir), run
    C (resumed from it to step 6); (b) the first step against float64.
    Returns the kernel launches of (a)."""
    import shutil
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels, tree
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.guards import StepGuard

    cfg = without_remat(ARCHS[LM_ARCH], LM_ARCH)
    tcfg = TrainConfig(total_steps=LM_STEPS, checkpoint_every=0,
                       keep_checkpoints=1, seed=0)
    ckdir = os.path.join(HERE, "build", "smoke_lm_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)

    def run(steps, ckpt_dir=None):
        guard = StepGuard()
        stamps = []
        t0 = time.perf_counter()
        out = train_loop(cfg, tcfg, batch_size=LM_BATCH, seq_len=LM_SEQ,
                         steps=steps, ckpt_dir=ckpt_dir, log_every=0,
                         guard=guard, device=dev,
                         on_metrics=lambda i, m: stamps.append(
                             (i, time.perf_counter(), m["loss"])))
        torch.cuda.synchronize(dev)
        return out, guard, [t0] + [t for _, t, _ in stamps], \
            time.perf_counter()

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    a, guard_a, ts_a, _ = run(LM_STEPS)
    n_params = sum(x.numel() for x in tree.leaves(a["params"]))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses_a = a["losses"]
    del a
    torch.cuda.empty_cache()
    b, guard_b, ts_b, end_b = run(LM_CUT, ckdir)
    save_s = end_b - ts_b[-1]
    del b
    torch.cuda.empty_cache()
    size_gb = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckdir) for f in fs) / 1e9
    saves = []
    with final_save_counted(saves):
        c, guard_c, ts_c, _ = run(LM_STEPS, ckdir)
    launches = kernels.launch_counts()
    # restore alone: the checkpoint into the resumed run's tree
    tmpl = {"params": c["params"], "opt": c["opt_state"]}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step, _ = ckpt.restore(ckdir, tmpl)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    del tmpl
    losses_c, resumed = c["losses"], c["resumed_from"]
    del c
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()

    step_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(ts_a, ts_a[1:])]
    med = statistics.median(step_ms[2:6])
    MEASURED["SmolLM-360M step"] = (cfg, path_shape(LM_SEQ, LM_BATCH,
                                                    "train"), "float32", med)
    print(f"{LM_ARCH}: {n_params / 1e6:.1f} M params, batch {LM_BATCH} x "
          f"{LM_SEQ}; run A losses {losses_a}; step ms {step_ms}; median "
          f"of steps 2-5 {med:.1f} ms; peak memory {peak_gb:.2f} GiB",
          flush=True)
    print(f"{LM_ARCH}: checkpoint of step {LM_CUT} {size_gb:.2f} GB, save "
          f"{save_s:.2f} s (the final save of run B), restore {restore_s:.2f}"
          f" s (step {step}); run C resumed from step {resumed}, losses "
          f"{losses_c}; its final save (step {saves}) counted, not written",
          flush=True)
    check(saves == [LM_STEPS], f"{LM_ARCH}: run C reached its final save")
    # run C's guard resumes run B's state, its verdict history included
    verdicts = [v for _, v in guard_a.verdicts + guard_b.verdicts] + \
        [v for s_, v in guard_c.verdicts if s_ >= LM_CUT]
    check(len(verdicts) == LM_STEPS + LM_CUT + (LM_STEPS - LM_CUT)
          and set(verdicts) == {"ok"},
          f"{LM_ARCH}: every guarded step's verdict is ok ({verdicts})")
    check(all(math.isfinite(x) for x in losses_a + losses_c),
          f"{LM_ARCH}: finite losses")
    tail = losses_a[LM_CUT:]
    equal = tail == losses_c
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses_c, tail))
    print(f"{LM_ARCH}: resumed losses {'bit-equal to' if equal else 'differ from'}"
          f" the uninterrupted run's (max rel {rel:.2e})", flush=True)
    check(resumed == LM_CUT and len(losses_c) == len(tail)
          and (equal or rel <= LM_RESUME_RTOL),
          f"{LM_ARCH}: run C's losses for steps {LM_CUT}-{LM_STEPS - 1} "
          f"equal run A's (bit-equal, or within {LM_RESUME_RTOL})")
    check(sum(launches.values()) == 0,
          f"{LM_ARCH}: the dense decoder launches none of the sparse "
          f"kernels ({launches})")
    lm_first_step_rule(dev, cfg, tcfg)
    return launches


def chaos_phase(dev):
    """(c) the port's chaos matrix on the card; returns its launches."""
    from repro_torch.runtime import faults
    rows, launches = launches_of(faults.run_matrix, device=dev)
    for r in rows:
        print(f"chaos {'PASS' if r.ok else 'FAIL'} {r.fault}: detected="
              f"{r.detected} survived={r.survived} via {r.guard_key}; "
              f"{r.detail}", flush=True)
        check(r.ok, f"chaos case {r.fault} detected and survived on the card")
    check(len(rows) == 8, f"{len(rows)} of 8 chaos cases ran")
    return launches


def d2h_and_syncs(fn):
    """Device-to-host copies and stream/device synchronizations in ``fn``,
    from the profiler's trace."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    copies = syncs = 0
    for e in prof.key_averages():
        if "Memcpy DtoH" in e.key:
            copies += e.count
        if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += e.count
    return copies, syncs


def autotune_phase(dev):
    """(d) VGG16 IN_OUT_WR with ``autotune=True`` at phase 4's geometry:
    five steps, then one step with every dispatch held against its plain
    version, the decision log, the step time beside phase 4's, and the
    device-to-host copies and syncs of a step with autotune off and on."""
    import collections
    from repro_torch import kernels
    from repro_torch.cnn_training import train_steps
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.data.pipeline import image_batch
    from repro_torch.kernels import autotune, stats

    geom = dict(net="vgg16", device=dev, **AUTOTUNE_GEOM)
    autotune.reset()
    stats.reset()
    kernels.reset_launch_counts()
    run = train_steps(steps=5, policy="IN_OUT_WR", kernel_impl="pallas",
                      autotune_gemms=True, **geom)
    launches = kernels.launch_counts()
    for i, rec in enumerate(run["steps"]):
        print(f"vgg16 autotune step {i}: loss {rec['loss']:.6f} "
              f"{rec['seconds'] * 1e3:.1f} ms counts {rec['counts']} "
              f"launches {rec['launches']}", flush=True)
    rows = autotune.log_rows()
    events = collections.Counter(r["event"] for r in rows)
    chosen = collections.Counter((r["event"], r["schedule"], r["block"],
                                  r["shape"]) for r in rows
                                 if r["event"] != "hit")
    print(f"vgg16 autotune decision log: {len(rows)} rows; events "
          f"{dict(events)}", flush=True)
    for (event, sched, block, shape), n in sorted(chosen.items()):
        print(f"  {event}: {sched} block {block} shape {shape} ({n}x)",
              flush=True)
    check(events.get("measured", 0) + events.get("retune", 0) > 0,
          "vgg16 autotune made measured decisions in five steps")
    check(all(math.isfinite(r["loss"]) for r in run["steps"]),
          "vgg16 autotune: finite losses")
    step_ms = statistics.median(r["seconds"] * 1e3
                                for r in run["steps"][2:])
    print(f"vgg16 IN_OUT_WR step ms, median of steps 3-5: autotune on "
          f"{step_ms:.1f}; phase 4 (autotune off, steps 2-3) "
          f"{STEP_MS.get('vgg16', float('nan')):.1f}", flush=True)

    model, params = run["model"], run["params"]
    img, labels = image_batch(0, 5, batch=geom["batch"],
                              image_size=geom["image_size"],
                              num_classes=geom["num_classes"], device=dev)
    report, detail = REPORTERS
    held = audit_step(dev, "vgg16", report, detail,
                      policy=IN_OUT_WR.with_(kernel_impl="pallas",
                                             autotune=True),
                      state=(model, params, img, labels))
    print(f"vgg16 autotune audit step: dispatches by (schedule, block) "
          f"{held}", flush=True)

    # With autotune on from the warm cache, then off from a fresh one (as
    # phase 4 runs it: no spec of an autotune resolution, so no telemetry).
    per = {}
    for on in (True, False):
        autotune.fold_pending()      # the audited step's samples
        if not on:
            autotune.reset()
        per[on] = d2h_and_syncs(lambda: train_steps(
            steps=1, policy="IN_OUT_WR", kernel_impl="pallas",
            autotune_gemms=on, params=params, **geom))
        print(f"vgg16 step with autotune {'on' if on else 'off'}: "
              f"{per[on][0]} device-to-host copies, {per[on][1]} stream/"
              f"device syncs (profiler)", flush=True)
    check(per[True][0] - per[False][0] <= 1
          and per[True][1] - per[False][1] <= 1,
          "autotune adds at most one device-to-host copy and one sync a "
          "step")
    autotune.reset()
    stats.reset()
    return launches


def guarded_lm_phase(dev):
    """Phase 7: guarded LM training and the autotuner."""
    t0 = time.perf_counter()
    by_path = {"lm_smollm360m": lm_phase(dev),
               "chaos_matrix": chaos_phase(dev),
               "vgg16_autotune": autotune_phase(dev)}
    print(f"phase 7 (guarded LM training, chaos, autotune): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 8: encoder-decoder, frontend and mixture-of-experts LMs
# ---------------------------------------------------------------------------

# The batch the reference's registry.train_input_specs lays out at batch 8
# and 512 positions (data.pipeline.train_batch): seamless and internvl2
# take 256 frontend embeddings and 257 tokens, deepseek 513 tokens.
FAM_BATCH, FAM_SEQ = 8, 512
SEAMLESS, INTERNVL2, DEEPSEEK = ("seamless-m4t-medium", "internvl2-1b",
                                 "deepseek-v2-lite-16b")
# deepseek at full width cut to its dense prefix and two MoE layers: 1.67 B
# params, ~27 GB with AdamW in f32.
DEEPSEEK_LAYERS = 3
SEAMLESS_STEPS, SEAMLESS_CUT = 5, 3
INTERNVL2_STEPS = 3
DEEPSEEK_STEPS, DEEPSEEK_CUT = 5, 3
# Faults each new path's float64 rule must reject: the encoder's memory cut
# to its first half; the middle encoder layer made causal;
# the projected frontend embeddings put after the tokens; one expert's
# output (DEEPSEEK_FAULT_EXPERT, first MoE layer) zeroed in the combine;
# the MoE aux loss dropped.
SEAMLESS_FAULTS = ("memory_halved", "encoder_layer_causal")
INTERNVL2_FAULTS = ("frontend_after_tokens",)
DEEPSEEK_FAULTS = ("expert_output_zeroed", "aux_loss_dropped")
DEEPSEEK_FAULT_EXPERT = 0
FFN_KERNELS = ("relu_encode", "queue_builder", "compact_gemm")


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(the real one)`` inside the
    block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def hooked(setter, fn):
    """A module's test hook (``set_*_hook``) installed inside the block."""
    prev = setter(fn)
    try:
        yield
    finally:
        setter(prev)


@contextlib.contextmanager
def final_save_counted(saves):
    """``checkpoint.save`` recorded in ``saves`` (its step) instead of
    written, for a resumed ``train_loop`` run: its final save writes the
    whole state again (26.7 GB for deepseek at 3 layers), with the code
    the interrupted run's final save already ran; the script keeps its
    disk writes under 40 GB."""
    from repro_torch import checkpoint as ckpt
    with patched(ckpt, "save", lambda real: (
            lambda path, step, tree, **kw: saves.append(step))):
        yield


def lm_grads(cfg, params, batch, dtype, *plants):
    """(loss, gradient leaves) of ``lm_loss`` at ``params`` and ``batch``
    cast to ``dtype``, every upcast at ``dtype`` (PR 17's float64 rule
    takes the same step at float64), inside the context managers
    ``plants`` (hooks, planted faults)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import common
    from repro_torch.models.transformer import lm_loss

    leaves = [x.detach().to(dtype).requires_grad_(True)
              for x in tree.leaves(params)]
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch.items()}
    with contextlib.ExitStack() as stack:
        for cm in plants:
            stack.enter_context(cm)
        stack.enter_context(common.upcast(dtype))
        loss = lm_loss(tree.unflatten_like(params, leaves), b, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss), grads


def f64_verdict(tag, what, paths, loss, grads, loss64, g64,
                grad_rtol=None):
    """Phase 7's rule: the loss within LM_LOSS_RTOL relative and every
    gradient leaf within LM_GRAD_RTOL (or ``grad_rtol``: one bound, or a
    list with one per leaf) in relative L2 norm of float64."""
    from repro_torch.conditioning import leaf_rels

    grad_rtol = grad_rtol or LM_GRAD_RTOL
    per_leaf = isinstance(grad_rtol, list)
    bounds = grad_rtol if per_leaf else [grad_rtol] * len(g64)
    loss_rel = abs(loss - loss64) / abs(loss64)
    rels = leaf_rels(grads, g64)
    order = sorted(range(len(rels)), key=lambda i: rels[i] / bounds[i],
                   reverse=True)
    passed = loss_rel <= LM_LOSS_RTOL and all(
        r <= b for r, b in zip(rels, bounds))
    print(f"{tag} first step vs float64 [{what}]: loss {loss:.7f} vs "
          f"{loss64:.7f} (rel {loss_rel:.2e}); worst gradient leaves "
          + ", ".join(f"{paths[i]} rel L2 {rels[i]:.2e}"
                      + (f" (bound {bounds[i]:.2e})" if per_leaf else "")
                      for i in order[:3])
          + f"; {'passes' if passed else 'fails'} the rule (leaves "
          + (f"per leaf, reading/bound at most "
             f"{rels[order[0]] / bounds[order[0]]:.3f})" if per_leaf
             else f"{grad_rtol:g})"), flush=True)
    return passed


def faults_fail(tag, faults, run, paths, loss64, g64, grad_rtol=None):
    """Each planted fault's first step (``run(fault)``) must fail the
    float64 rule."""
    for fault in faults:
        loss, grads = run(fault)
        check(not f64_verdict(tag, fault, paths, loss, grads, loss64, g64,
                              grad_rtol),
              f"the float64 rule rejects {tag}'s planted {fault}")
        del grads


def timed_steps(dev, cfg, params, n, cut=None, ckdir=None):
    """``n`` AdamW steps of ``make_train_step`` from ``params`` on
    ``train_batch`` batches 0..n-1, each timed between device syncs, the
    launch counters reset before and read after; with ``cut``, the state
    after ``cut`` steps saved to ``ckdir``.  Returns (losses, step ms, save
    s, launches, peak GiB, (params, opt state, step function))."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels
    from repro_torch.data.pipeline import train_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import OptConfig, adamw_init

    step_fn = make_train_step(cfg, OptConfig())
    opt = adamw_init(params)
    losses, ms, save_s = [], [], None
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(n):
        batch = train_batch(cfg, 0, i, batch=FAM_BATCH, seq_len=FAM_SEQ,
                            device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if cut is not None and i + 1 == cut:
            t0 = time.perf_counter()
            ckpt.save(ckdir, cut, {"params": params, "opt": opt}, keep=1)
            save_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return losses, ms, save_s, launches, peak, (params, opt, step_fn)


def n_params(params):
    from repro_torch import tree
    return sum(x.numel() for x in tree.leaves(params))


def report_steps(tag, cfg, n, losses, ms, peak):
    """Print the steps' losses, times (the median of steps 2 on) and
    memory peak."""
    med = statistics.median(ms[1:])
    print(f"{tag}: {n / 1e6:.1f} M params, {cfg.n_layers} decoder "
          f"layers, batch {FAM_BATCH} x {FAM_SEQ} positions; losses "
          f"{losses}; step ms {[round(x, 2) for x in ms]}; median of steps "
          f"2-{len(ms)} {med:.1f} ms; peak memory {peak:.2f} GiB",
          flush=True)
    check(all(math.isfinite(x) for x in losses), f"{tag}: finite losses")


def seamless_phase(dev):
    """seamless-m4t-medium at full width and depth with its ReLU FFN under
    IN_OUT_WR (``sparse_ffn_scenario``: the masked plain path, as in the
    reference): the first step against float64 under the f32 step's own
    ReLU masks, against the dense step, and with two planted faults; five
    AdamW steps with a checkpoint after three and a resume.  Returns (the
    steps' launches, decoder layer 0's FFN input, weights and output
    gradient in the first step)."""
    import shutil
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import ffn, transformer
    from repro_torch.models.transformer import lm_init

    tag = SEAMLESS
    cfg = without_remat(ARCHS[SEAMLESS], tag).with_(
        sparse_ffn_scenario="IN_OUT_WR")
    dense = cfg.with_(sparse_ffn_scenario=None)
    params = lm_init(0, cfg, dtype=torch.float32, device=dev)
    batch = train_batch(cfg, 0, 0, batch=FAM_BATCH, seq_len=FAM_SEQ,
                        device=dev)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    cap = {}

    def capture(real):
        calls = [0]

        def ffn_apply(p, x, fc):
            y = real(p, x, fc)
            if calls[0] == cfg.n_enc_layers:          # decoder layer 0
                cap["x"] = x.detach().reshape(-1, x.shape[-1]).clone()
                cap["p"] = {k: v.detach() for k, v in p.items()}
                y.register_hook(lambda g: cap.__setitem__(
                    "dy", g.reshape(-1, g.shape[-1]).clone()))
            calls[0] += 1
            return y
        return ffn_apply

    def record(into):
        return hooked(ffn.set_relu_mask_hook,
                      lambda h: into.append(h > 0))

    masks32, masks64 = [], []
    loss32, g32 = lm_grads(cfg, params, batch, torch.float32,
                           record(masks32),
                           patched(transformer, "ffn_apply", capture))
    loss64u, g64u = lm_grads(dense, params, batch, torch.float64,
                             record(masks64))
    flips = sum(int((a != b).sum()) for a, b in zip(masks32, masks64))
    total = sum(a.numel() for a in masks32)
    del masks64
    replay = iter(masks32)
    loss64, g64 = lm_grads(dense, params, batch, torch.float64,
                           hooked(ffn.set_relu_mask_hook,
                                  lambda h: next(replay)))
    moved = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-300)),
                     paths[i]) for i, (a, b) in enumerate(zip(g64u, g64))),
                   reverse=True)
    n_moved = sum(r > 0 for r, _ in moved)
    del g64u, masks32
    print(f"{tag}: {flips} of {total} sigma-prime flips between the f32 and "
          f"float64 forwards ({flips / total:.2e}); the float64 step under "
          f"the f32 step's masks differs from the unmasked one in {n_moved} "
          f"of {len(moved)} leaves (largest {moved[0][0]:.2e} at "
          f"{moved[0][1]}; loss {loss64u:.9f} vs {loss64:.9f})", flush=True)
    check(flips <= FLIP_SHARE * total,
          f"{tag}: sigma-prime flips within {FLIP_SHARE} of the ReLU "
          f"activations")
    check(f64_verdict(tag, "IN_OUT_WR", paths, loss32, g32, loss64, g64),
          f"{tag} IN_OUT_WR first step within {LM_LOSS_RTOL} (loss) and "
          f"{LM_GRAD_RTOL} (every gradient leaf, relative L2) of float64 "
          f"under its own ReLU masks")
    loss_d, g_d = lm_grads(dense, params, batch, torch.float32)
    same = sum(torch.equal(a, b) for a, b in zip(g32, g_d))
    print(f"{tag}: dense f32 step loss {loss_d:.9f} vs IN_OUT_WR "
          f"{loss32:.9f}; {same} of {len(g_d)} gradient leaves bit-equal",
          flush=True)
    check(f64_verdict(tag, "IN_OUT_WR against the dense f32 step", paths,
                      loss32, g32, loss_d, [g.double() for g in g_d]),
          f"{tag}: the IN_OUT_WR step equals the dense step within the "
          f"rule (lossless)")
    del g_d, g32

    def causal_layer(real):
        calls = [0]

        def block_apply(p, x, c, kind, use_moe=False, *, causal=True,
                        memory=None):
            if not causal:                            # an encoder layer
                causal = calls[0] == cfg.n_enc_layers // 2
                calls[0] += 1
            return real(p, x, c, kind, use_moe, causal=causal,
                        memory=memory)
        return block_apply

    plants = {
        "memory_halved": lambda: patched(
            transformer, "encode", lambda real: lambda p, fe, c: (
                lambda m: m[:, :m.shape[1] // 2])(real(p, fe, c))),
        "encoder_layer_causal": lambda: patched(transformer, "block_apply",
                                                causal_layer)}
    faults_fail(tag, SEAMLESS_FAULTS, lambda f: lm_grads(
        cfg, params, batch, torch.float32, plants[f]()), paths, loss64, g64)
    del g64
    torch.cuda.empty_cache()

    ckdir = os.path.join(HERE, "build", "smoke_seamless_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    losses, ms, save_s, launches, peak, (p_end, o_end, step_fn) = \
        timed_steps(dev, cfg, params, SEAMLESS_STEPS, SEAMLESS_CUT, ckdir)
    report_steps(tag, cfg, n_params(params), losses, ms, peak)
    size_gb = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckdir) for f in fs) / 1e9
    tmpl = {"params": p_end, "opt": o_end}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step, state = ckpt.restore(ckdir, tmpl)
    torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    del tmpl, p_end, o_end
    p, o = state["params"], state["opt"]
    resumed = []
    for i in range(step, SEAMLESS_STEPS):
        p, o, m = step_fn(p, o, train_batch(cfg, 0, i, batch=FAM_BATCH,
                                            seq_len=FAM_SEQ, device=dev))
        resumed.append(float(m["loss"]))
    del p, o, state
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{tag}: checkpoint of step {step} (the encoder's "
          f"{len(params['encoder']['layers'])} layers a list) {size_gb:.2f} "
          f"GB, save {save_s:.2f} s, restore {restore_s:.2f} s; resumed "
          f"losses {resumed} vs {losses[SEAMLESS_CUT:]}", flush=True)
    check(step == SEAMLESS_CUT and resumed == losses[SEAMLESS_CUT:],
          f"{tag}: the losses resumed from the checkpoint are bit-equal to "
          f"the uninterrupted run's")
    check(sum(launches.values()) == 0,
          f"{tag}: sparse_ffn_scenario runs the masked plain path, as in "
          f"the reference: no kernel launched ({launches})")
    return launches, cap


def ffn_kernels_phase(dev, cap):
    """seamless decoder layer 0's FFN on the first step's input and output
    gradient (8 x 256 rows, 1,024 -> 4,096 -> 1,024) through ``ffn_apply``
    under IN_OUT_WR with the kernels (K1, K2, K3 and the split-K reduce)
    against the plain dense FFN under the kernel path's own ReLU mask (its
    up-projection sums on the tensor cores, so a hidden unit within
    rounding of 0 may take the other side of the ReLU than in f32 FMA: a
    σ′ flip, counted and held to FLIP_SHARE); then every kernel call held
    against its plain version, with the live-tile shares of each GEMM and
    the kernels' times beside torch.matmul's.  Returns the launches."""
    import torch
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.kernel_times import event_ms
    from repro_torch.kernels import stats
    from repro_torch.models import ffn
    from repro_torch.models.ffn import FFNConfig, ffn_apply

    x, p, dy = cap["x"], cap["p"], cap["dy"]
    d, f = p["w_up"].shape
    FFN_CAPTURE.update(x=x.cpu().numpy(), w_up=p["w_up"].cpu().numpy(),
                       w_down=p["w_down"].cpu().numpy(),
                       dy=dy.cpu().numpy())

    def run(policy):
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        y = ffn_apply(w, xi, FFNConfig(d, f, "relu", policy))
        return (y.detach(),) + torch.autograd.grad(
            y, [w["w_up"], w["w_down"], xi], grad_outputs=dy)

    kern = IN_OUT_WR.with_(kernel_impl="pallas")
    plain = IN_OUT_WR.with_(kernel_impl="xla_ref")
    stats.reset()
    own = []                   # the kernel path's σ′, read by the hook
    with hooked(ffn.set_relu_mask_hook, lambda h: own.append(h > 0)):
        got, launches = launches_of(run, kern)
    counts = stats.counts()
    stats.reset()
    with hooked(ffn.set_relu_mask_hook, lambda h: own[0]):
        want = run(None)
    flips = int((own[0] != (x.reshape(-1, d) @ p["w_up"] > 0)).sum())
    check(len(own) == 1 and flips <= FLIP_SHARE * own[0].numel(),
          f"seamless decoder layer 0 FFN: {flips} σ′ flips against the "
          f"plain up-projection <= {FLIP_SHARE:g} x {own[0].numel()}")
    for name, a, b in zip(("output", "dW_up", "dW_down", "dX"), got, want):
        err, rel, ok = rel_err(a, b)
        check(ok, f"seamless decoder layer 0 FFN {name} through the kernels "
              f"within {KERNEL_RTOL} of the plain dense FFN under the "
              f"kernel path's ReLU mask ({rel:.2e} of max|plain|)")
    print(f"seamless decoder layer 0 FFN: {x.shape[0]} x {d} -> {f} -> {d}; "
          f"the kernel path's counts {counts}; launches {launches}",
          flush=True)
    check_path_kernels("lm_ffn_kernels", launches, FFN_KERNELS)
    report, detail = REPORTERS
    stats.reset()
    with held_against_plain(dev, "seamless dec0 ffn", report, detail) as (
            held, schedules, shares):
        run(kern)
    c = ran_counts(stats.counts(), stats.elided())
    stats.reset()
    for case, out_live, a_live, b_live, flop_share in shares:
        print(f"  live tiles {case}: output {out_live:.3f}, A "
              f"{'-' if a_live is None else f'{a_live:.3f}'}, B "
              f"{'-' if b_live is None else f'{b_live:.3f}'}; "
              f"{flop_share:.3f} of the dense FLOPs", flush=True)
    check(held["gemm"] == _sum(c, "gemm:") > 0
          and held["queue"] == c.get("queue:prefix_sum", 0)
          and held["encode"] == c.get("encode:act") > 0,
          f"lm_ffn_kernels held every dispatch, queue and encode against "
          f"its plain version ({held}; {schedules})")

    def dense_ffn():
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        y = torch.relu(xi @ w["w_up"]) @ w["w_down"]
        return torch.autograd.grad(y, [w["w_up"], w["w_down"], xi],
                                   grad_outputs=dy)
    print(f"seamless decoder layer 0 FFN forward + backward: kernels "
          f"{event_ms(lambda: run(kern)):.3f} ms, plain path "
          f"{event_ms(lambda: run(plain)):.3f} ms, torch.matmul dense "
          f"{event_ms(dense_ffn):.3f} ms (hidden ReLU live share "
          f"{float((x @ p['w_up'] > 0).float().mean()):.3f})", flush=True)
    return launches


def internvl2_phase(dev):
    """internvl2-1b at full width and depth: the first step against
    float64 and with the frontend put after the tokens; three AdamW
    steps.  Returns the steps' launches."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models import transformer
    from repro_torch.models.transformer import lm_init

    tag = INTERNVL2
    cfg = without_remat(ARCHS[INTERNVL2], tag)
    params = lm_init(0, cfg, dtype=torch.float32, device=dev)
    batch = train_batch(cfg, 0, 0, batch=FAM_BATCH, seq_len=FAM_SEQ,
                        device=dev)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    loss64, g64 = lm_grads(cfg, params, batch, torch.float64)
    loss32, g32 = lm_grads(cfg, params, batch, torch.float32)
    check(f64_verdict(tag, "clean", paths, loss32, g32, loss64, g64),
          f"{tag} first step within {LM_LOSS_RTOL} (loss) and "
          f"{LM_GRAD_RTOL} (every gradient leaf, relative L2) of float64")
    del g32
    after = lambda real: lambda fe, x: torch.cat([x, fe.to(x.dtype)], dim=1)
    faults_fail(tag, INTERNVL2_FAULTS, lambda f: lm_grads(
        cfg, params, batch, torch.float32,
        patched(transformer, "prepend_frontend", after)),
        paths, loss64, g64)
    del g64
    torch.cuda.empty_cache()
    losses, ms, _, launches, peak, _ = timed_steps(dev, cfg, params,
                                                   INTERNVL2_STEPS)
    report_steps(tag, cfg, n_params(params), losses, ms, peak)
    MEASURED["internvl2-1b step"] = (cfg, path_shape(FAM_SEQ, FAM_BATCH,
                                                     "train"), "float32",
                                     statistics.median(ms[1:]))
    check(sum(launches.values()) == 0,
          f"{tag}: the GLU FFN launches none of the sparse kernels")
    torch.cuda.empty_cache()
    return launches


def deepseek_phase(dev):
    """deepseek-v2-lite-16b at full width, 3 layers (the dense prefix, 2
    MoE layers with MLA): the first step against float64 under the f32
    step's own routing and with two planted faults, the tokens each MoE
    layer drops; then guarded ``train_loop`` runs as phase 7's: A (five
    steps), B (three into a checkpoint), C (resumed from it to five).
    Returns the launches of A."""
    import shutil
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch.train import train_loop
    from repro_torch.models import moe, transformer
    from repro_torch.models.transformer import lm_init
    from repro_torch.runtime.guards import StepGuard

    tag = f"{DEEPSEEK} ({DEEPSEEK_LAYERS} layers)"
    cfg = without_remat(ARCHS[DEEPSEEK], tag).with_(
        n_layers=DEEPSEEK_LAYERS)
    tcfg = TrainConfig(total_steps=DEEPSEEK_STEPS, checkpoint_every=0,
                       keep_checkpoints=1, seed=0)
    params = lm_init(tcfg.seed, cfg, dtype=torch.float32, device=dev)
    batch = lm_batch(tcfg.seed, 0, batch=FAM_BATCH, seq_len=FAM_SEQ,
                     vocab=cfg.vocab_size, device=dev)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    size = n_params(params)
    routing = []
    loss32, g32 = lm_grads(cfg, params, batch, torch.float32, hooked(
        moe.set_routing_hook,
        lambda name, t: routing.append((name, t)) or t))
    keeps = [t for name, t in routing if name == "keep"]
    print(f"{tag}: (token, choice) pairs dropped per MoE layer "
          f"{[int((~k).sum()) for k in keeps]} of {keeps[0].numel()} "
          f"(capacity {moe.capacity_of(keeps[0].shape[0], cfg.moe)} a "
          f"expert)", flush=True)
    replay = iter(routing)

    def play(name, t):
        name0, t0 = next(replay)
        assert name0 == name, (name0, name)
        return t0
    loss64, g64 = lm_grads(cfg, params, batch, torch.float64,
                           hooked(moe.set_routing_hook, play))
    del routing, keeps
    check(f64_verdict(tag, "clean", paths, loss32, g32, loss64, g64),
          f"{tag} first step within {LM_LOSS_RTOL} (loss) and "
          f"{LM_GRAD_RTOL} (every gradient leaf, relative L2) of float64 "
          f"under its own routing")
    del g32

    def expert_zeroed(real):
        calls = [0]

        def expert_ffn(p, xs, c):
            ys = real(p, xs, c)
            if calls[0] == 0:                         # first MoE layer
                keep = torch.ones(ys.shape[0], 1, 1, dtype=ys.dtype,
                                  device=ys.device)
                keep[DEEPSEEK_FAULT_EXPERT] = 0
                ys = ys * keep
            calls[0] += 1
            return ys
        return expert_ffn

    plants = {
        "expert_output_zeroed": lambda: patched(moe, "_expert_ffn",
                                                expert_zeroed),
        "aux_loss_dropped": lambda: patched(
            transformer, "moe_apply", lambda real: lambda *a, **kw: (
                lambda y, aux: (y, aux * 0))(*real(*a, **kw)))}
    faults_fail(tag, DEEPSEEK_FAULTS, lambda f: lm_grads(
        cfg, params, batch, torch.float32, plants[f]()), paths, loss64, g64)
    del g64, params
    torch.cuda.empty_cache()

    ckdir = os.path.join(HERE, "build", "smoke_deepseek_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)

    def run(steps, ckpt_dir=None):
        guard, stamps = StepGuard(), []
        t0 = time.perf_counter()
        out = train_loop(cfg, tcfg, batch_size=FAM_BATCH, seq_len=FAM_SEQ,
                         steps=steps, ckpt_dir=ckpt_dir, log_every=0,
                         guard=guard, device=dev,
                         on_metrics=lambda i, m: stamps.append(
                             time.perf_counter()))
        torch.cuda.synchronize(dev)
        losses, n = out["losses"], out["resumed_from"]
        del out
        torch.cuda.empty_cache()
        return losses, n, guard, [t0] + stamps, time.perf_counter()

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    losses_a, _, guard_a, ts_a, _ = run(DEEPSEEK_STEPS)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _, _, guard_b, ts_b, end_b = run(DEEPSEEK_CUT, ckdir)
    size_gb = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckdir) for f in fs) / 1e9
    saves = []
    with final_save_counted(saves):
        losses_c, resumed, guard_c, ts_c, _ = run(DEEPSEEK_STEPS, ckdir)
    shutil.rmtree(ckdir, ignore_errors=True)
    ms = [(t1 - t0) * 1e3 for t0, t1 in zip(ts_a, ts_a[1:])]
    report_steps(tag, cfg, size, losses_a, ms, peak)
    print(f"{tag}: checkpoint of step {DEEPSEEK_CUT} (the prefix a list) "
          f"{size_gb:.2f} GB, save {end_b - ts_b[-1]:.2f} s (the final save "
          f"of run B); run C resumed from step {resumed}: restore and first "
          f"step {ts_c[1] - ts_c[0]:.2f} s; losses {losses_c}; its final "
          f"save (step {saves}) counted, not written", flush=True)
    check(saves == [DEEPSEEK_STEPS], f"{tag}: run C reached its final save")
    verdicts = [v for _, v in guard_a.verdicts + guard_b.verdicts] + \
        [v for s_, v in guard_c.verdicts if s_ >= DEEPSEEK_CUT]
    check(len(verdicts) == 2 * DEEPSEEK_STEPS and set(verdicts) == {"ok"},
          f"{tag}: every guarded step's verdict is ok ({verdicts})")
    check(resumed == DEEPSEEK_CUT
          and losses_c == losses_a[DEEPSEEK_CUT:],
          f"{tag}: run C's losses for steps {DEEPSEEK_CUT}-"
          f"{DEEPSEEK_STEPS - 1} bit-equal to run A's")
    check(sum(launches.values()) == 0,
          f"{tag}: MoE, MLA and GLU FFNs launch none of the sparse kernels")
    return launches


def lm_families_phase(dev):
    """Phase 8: the encoder-decoder, frontend and MoE LMs at full width."""
    t0 = time.perf_counter()
    by_path = {}
    by_path["lm_seamless"], cap = seamless_phase(dev)
    by_path["lm_ffn_kernels"] = ffn_kernels_phase(dev, cap)
    del cap
    by_path["lm_internvl2"] = internvl2_phase(dev)
    by_path["lm_deepseek3"] = deepseek_phase(dev)
    print(f"phase 8 (seamless, its FFN on the kernels, internvl2, deepseek): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 9: sliding windows, Mamba, xLSTM, bf16 and serving
# ---------------------------------------------------------------------------

GEMMA3, XLSTM, JAMBA = "gemma3-12b", "xlstm-350m", "jamba-1.5-large-398b"
# ServeEngine at launch/serve.py's defaults.
SERVE = dict(slots=4, requests=8, prompt=6, tokens=12, max_len=256)
GEMMA3_PERIOD = 6                    # one period, LLLLLG
GEMMA3_DECODE_T = 1100               # past the window of 1,024: the ring wraps
GEMMA3_TRAIN_T, GEMMA3_STEPS = 4096, 3
XLSTM_BATCH, XLSTM_SEQ, XLSTM_STEPS, XLSTM_CUT = 8, 512, 5, 3
# The train_loop's depth, cut from 24 so that the script keeps its time
# with phase 12's dry runs after phase 11 (its two runs took ~150 s of
# the 24-layer stack; the sLSTM time loop is host-bound), and from 12 to
# make room for phase 13.
XLSTM_TRAIN_LAYERS = 6
# Past two mLSTM chunks of 64; the parallel forward needs a multiple of the
# chunk (the reference asserts it), so 192 rather than 160.
XLSTM_DECODE = (2, 192)
JAMBA_T, JAMBA_DECODE_T = 2048, 512  # 8 chunks of 256; 2 chunks
DEEPSEEK_DECODE = (2, 16)
# deepseek's decode also in f32, at full width cut to its dense prefix and
# three MoE layers (the f32 model at full depth, 62.8 GB, leaves no room).
DEEPSEEK_F32 = f"{DEEPSEEK} (f32, 4 layers)"
DEEPSEEK_F32_LAYERS = 4
# Decode against the parallel forward: the last position's logits (an SSM
# block's every output), max|decode - parallel| <= bound * max|parallel|.
# Each bound sits between the clean reading and the planted fault's (an
# H100 80GB HBM3 at 700 W): gemma3 (bf16, 1,100 tokens) 1.13e-2 against
# 7.01e-2 with the ring slot off by one; xlstm (f32, 24 layers) 1.43e-3
# against 1.44 with the mLSTM state dropped; jamba's SSM 7.1e-6 against
# 0.269 with the state dropped; deepseek (bf16, 27 layers) 6.17e-2
# against 0.647 with the latent slot off by one.  The f32 decode at 4
# layers, held to the reference's own MoE tolerance
# (tests/test_torch_serving.py), separates bf16 rounding from a fault of
# the absorbed decode.
DECODE_BOUND = {GEMMA3: 5e-2, XLSTM: 1e-2, JAMBA: 2e-3, DEEPSEEK: 0.2,
                DEEPSEEK_F32: 5e-3}
# gemma3's first bf16 step against an f32 step from the same bf16 values,
# on tokens drawn from a seeded generator (lm_batch's x' = a·x + c mod V
# collapses for an even a at a power-of-two V: one token filled 3,870 of
# 4,096 positions): the loss and every gradient leaf within
# BF16_STEP_BOUND in relative L2.  On an H100 80GB HBM3 at 700 W the worst
# leaf reads 2.73e-2, the planted faults' worst leaves 1.13 (the window
# dropped from the L layers) and 0.838 (the G layer windowed).
BF16_STEP_BOUND = 0.1
GEMMA3_FAULTS = ("window_dropped_from_L", "G_layer_windowed")
XLSTM_FAULTS = ("mlstm_carry_reset", "slstm_recurrence_zeroed")
# xlstm's first step against float64: phase 7's rule at XLSTM_F64_DEPTH
# layers (full width, 8 x 512).  At full depth this random-weight stack is
# ill-conditioned (phase 7's 1e-4 reads 0.148 at the worst leaf, the
# mLSTM input-gate bias of layer 0): a float64 step from params one f32
# rounding off already moves that leaf by 2.6e-2, and an f32 step rounds
# every op.  So there each leaf is held within XLSTM_ULP_RATIO times the
# farthest of XLSTM_ULP_DRAWS such float64 steps from the float64 step, or
# LM_GRAD_RTOL.  On an H100 80GB HBM3 at 700 W the clean step reads at
# most 7.9 times that spread (final_norm's scale), the planted faults at
# least 7,000 times; tests/test_torch_xlstm.py holds both packages' f32
# steps by the same rule on the CPU (at most 5.2 there).
XLSTM_F64_DEPTH, XLSTM_ULP_DRAWS, XLSTM_ULP_RATIO = 4, 2, 16.0


def param_gb(params):
    from repro_torch import tree
    return sum(x.numel() * x.element_size() for x in tree.leaves(params)) / 1e9


def free(dev):
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def decode_reading(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def serve_phase(dev, tag, cfg, params):
    """``ServeEngine`` at the serve CLI's defaults: SERVE['requests']
    prompts of SERVE['prompt'] tokens from a seeded generator, each
    answered with SERVE['tokens']; every tick timed.  Returns the median
    tick ms."""
    import torch
    from repro_torch.benchmarks.roofline import path_row
    from repro_torch.serving.engine import GenRequest, ServeEngine

    gb = param_gb(params)
    eng = ServeEngine(cfg, params, batch_slots=SERVE["slots"],
                      max_len=SERVE["max_len"])
    gen = torch.Generator().manual_seed(1)
    for rid in range(SERVE["requests"]):
        eng.submit(GenRequest(rid, torch.randint(
            0, cfg.vocab_size, (SERVE["prompt"],), generator=gen).tolist(),
            max_tokens=SERVE["tokens"]))
    torch.cuda.synchronize(dev)
    ticks = []
    t_run = time.perf_counter()
    while eng.active and eng.index < eng.max_len:
        t0 = time.perf_counter()
        eng.step()                    # reads the next tokens: a sync
        ticks.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_run
    done = eng.done
    n_tok = sum(len(v) for v in done.values())
    med = statistics.median(ticks)
    # the tick's analytic bound at its own shape: a token for each slot
    # over caches of max_len positions (launch.flops, the H100's peaks)
    dtype = str(params["embed"].dtype).replace("torch.", "")
    shape = path_shape(SERVE["max_len"], SERVE["slots"], "decode")
    MEASURED[f"{tag} tick"] = (cfg, shape, dtype, med)
    row = path_row(f"{tag} tick", cfg, shape, med, dtype=dtype)
    print(f"{tag} serving: {len(done)}/{SERVE['requests']} requests, "
          f"{len(ticks)} ticks, {n_tok} tokens; tick ms median {med:.2f} "
          f"(min {min(ticks):.2f}, first {ticks[0]:.1f}); {n_tok / run_s:.1f} "
          f"tokens/s; weights {gb:.2f} GB; tick bound {row['bound_ms']:.2f} "
          f"ms ({row['dominant']}: {row['bytes']:.3e} B, {row['flops']:.3e} "
          f"FLOPs); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB",
          flush=True)
    check(len(done) == SERVE["requests"]
          and all(len(v) == SERVE["tokens"] for v in done.values())
          and all(0 <= t < cfg.vocab_size for v in done.values() for t in v),
          f"{tag}: ServeEngine answered every request with "
          f"{SERVE['tokens']} tokens in the vocabulary")
    del eng
    return med


def decode_vs_parallel(tag, cfg, params, toks, plant=None):
    """The last logits of decode_step over ``toks`` (B, T) against
    lm_hidden -> head; returns the reading."""
    import torch
    from repro_torch.models import transformer as tr

    b, t = toks.shape
    with torch.inference_mode():
        with plant() if plant else contextlib.nullcontext():
            # one slot to spare: a planted slot fault may write past t;
            # f32 caches and the head made once, as ServeEngine has them
            caches = tr.init_caches(cfg, b, t + 1, torch.float32,
                                    device=toks.device)
            head = tr.decode_head(params, cfg)
            for i in range(t):
                logits, caches = tr.decode_step(params, toks[:, i], caches,
                                                i, cfg, head=head)
        h, _ = tr.lm_hidden(params, toks, cfg)
        want = h[:, -1].float() @ tr.lm_head_weight(params, cfg).float()
    del caches, head
    return decode_reading(logits, want)


def decode_check(tag, cfg, params, toks, fault_name, plant):
    bound = DECODE_BOUND[tag]
    clean = decode_vs_parallel(tag, cfg, params, toks)
    faulted = decode_vs_parallel(tag, cfg, params, toks, plant)
    print(f"{tag} decode_step vs the parallel forward at {tuple(toks.shape)}"
          f": clean {clean:.3e}, {fault_name} {faulted:.3e} (bound "
          f"{bound:g} of max|logit|)", flush=True)
    check(clean <= bound, f"{tag}: decode within {bound:g} of the parallel "
          f"forward")
    check(faulted > bound, f"{tag}: the decode check rejects {fault_name}")


def gemma3_phase(dev):
    """gemma3-12b: served at full width and depth in bf16; then cut to one
    period (6 layers) at full width: decode across the ring's wrap, the
    first bf16 step against f32 with two planted window faults, three
    AdamW steps at 1 x 4,096."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention, transformer
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.optim.optimizer import OptConfig, adamw_init

    cfg = without_remat(ARCHS[GEMMA3], GEMMA3)
    free(dev)
    params = lm_init(0, cfg, dtype=torch.bfloat16, device=dev)
    print(f"{GEMMA3}: {n_params(params) / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers {cfg.pattern} (window "
          f"{cfg.sliding_window}), bf16", flush=True)
    tick = serve_phase(dev, GEMMA3, cfg, params)
    del params
    free(dev)

    cfg = cfg.with_(n_layers=GEMMA3_PERIOD)
    params = lm_init(0, cfg, dtype=torch.bfloat16, device=dev)
    tag = f"{GEMMA3} ({GEMMA3_PERIOD} layers)"
    toks = torch.randint(0, cfg.vocab_size, (1, GEMMA3_DECODE_T),
                         generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)

    def slot_off_by_one():
        return patched(attention, "ring_positions", lambda real: (
            lambda index, s_len, window, device: (
                lambda slot, valid: ((slot + 1) % s_len if window else slot,
                                     valid))(*real(index, s_len, window,
                                                   device))))
    t0 = time.perf_counter()
    decode_check(GEMMA3, cfg, params, toks, "ring slot off by one",
                 slot_off_by_one)
    print(f"{tag}: two {GEMMA3_DECODE_T}-token decodes and forwards "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def seeded_batch(seed):
        return {"tokens": torch.randint(
            0, cfg.vocab_size, (1, GEMMA3_TRAIN_T + 1), dtype=torch.int32,
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)}
    batch = seeded_batch(5)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    counts = batch["tokens"][0, :-1].unique(return_counts=True)[1]
    print(f"{tag}: the first batch's most frequent token fills "
          f"{int(counts.max())} of its {GEMMA3_TRAIN_T} input positions",
          flush=True)

    def grads(p, plant=None):
        leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
        with plant() if plant else contextlib.nullcontext():
            loss = lm_loss(tree.unflatten_like(p, leaves), batch, cfg)
        g = torch.autograd.grad(loss, leaves)
        return float(loss), [x.float() for x in g]

    plants = {
        "window_dropped_from_L": lambda: patched(
            transformer, "_block_attn_cfg",
            lambda real: lambda c, kind: c.attn_config(window=None)),
        "G_layer_windowed": lambda: patched(
            transformer, "_block_attn_cfg",
            lambda real: lambda c, kind: c.attn_config(
                window=c.sliding_window))}
    p32 = tree.tree_map(lambda x: x.float(), params)
    loss32, g32 = grads(p32)
    del p32
    free(dev)

    def verdict(what, loss, g):
        rels = [rel_l2(a, b) for a, b in zip(g, g32)]
        order = sorted(range(len(rels)), key=rels.__getitem__, reverse=True)
        loss_rel = abs(loss - loss32) / abs(loss32)
        print(f"{tag} first bf16 step vs f32 [{what}]: loss {loss:.6f} vs "
              f"{loss32:.6f} (rel {loss_rel:.2e}); worst leaves "
              + ", ".join(f"{paths[i]} {rels[i]:.3e}" for i in order[:4]),
              flush=True)
        return loss_rel <= BF16_STEP_BOUND and max(rels) <= BF16_STEP_BOUND

    loss16, g16 = grads(params)
    check(verdict("clean", loss16, g16), f"{tag}: the first bf16 step "
          f"within {BF16_STEP_BOUND} of f32 (loss, every leaf rel L2)")
    del g16
    for fault in GEMMA3_FAULTS:
        loss_f, g_f = grads(params, plants[fault])
        check(not verdict(fault, loss_f, g_f),
              f"{tag}: the bf16-vs-f32 rule rejects {fault}")
        del g_f
    del g32
    free(dev)

    step_fn = make_train_step(cfg, OptConfig())
    opt = adamw_init(params)
    losses, ms = [], []
    for i in range(GEMMA3_STEPS):
        b = seeded_batch(6 + i)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"{tag}: {n_params(params) / 1e9:.3f} B params, bf16 with f32 "
          f"master and moments; {GEMMA3_STEPS} AdamW steps at 1 x "
          f"{GEMMA3_TRAIN_T}: losses {losses}; step ms "
          f"{[round(x, 1) for x in ms]}, median of steps 2-{GEMMA3_STEPS} "
          f"{statistics.median(ms[1:]):.1f}; peak memory {peak:.2f} GiB",
          flush=True)
    check(all(math.isfinite(x) for x in losses)
          and params["embed"].dtype == torch.bfloat16,
          f"{tag}: finite bf16 training losses")
    del params, opt, step_fn
    free(dev)
    return tick


def xlstm_phase(dev):
    """xlstm-350m at full width, f32: five ``train_loop`` steps with a
    checkpoint after three and a resume at XLSTM_TRAIN_LAYERS layers; the
    first step against float64 with two planted faults at 4 layers and at
    full depth; serving and decode at full depth against the parallel
    forward."""
    import shutil
    import torch
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch import conditioning
    from repro_torch.launch.train import train_loop
    from repro_torch.models import transformer, xlstm
    from repro_torch.models.transformer import lm_init

    cfg = without_remat(ARCHS[XLSTM], XLSTM)
    tag = XLSTM
    free(dev)
    tcfg = TrainConfig(total_steps=XLSTM_STEPS, checkpoint_every=XLSTM_CUT,
                       keep_checkpoints=2, seed=0)
    ckdir = os.path.join(HERE, "build", "smoke_xlstm_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    stamps = [t0]
    cut = cfg.with_(n_layers=XLSTM_TRAIN_LAYERS)
    out = train_loop(cut, tcfg, batch_size=XLSTM_BATCH, seq_len=XLSTM_SEQ,
                     steps=XLSTM_STEPS, ckpt_dir=ckdir, log_every=0,
                     device=dev, on_metrics=lambda i, m: stamps.append(
                         time.perf_counter()))
    losses_a = out["losses"]
    size = n_params(out["params"])
    del out
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # between metric reads (each a sync); the interval after step 3 holds
    # its checkpoint save
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    print(f"{tag}: {size / 1e6:.1f} M params, {cut.n_layers} layers "
          f"{cut.pattern}, f32; train_loop {XLSTM_STEPS} steps at "
          f"{XLSTM_BATCH} x {XLSTM_SEQ}: losses {losses_a}; step ms "
          f"{[round(x, 1) for x in ms]}, median of steps 2-{XLSTM_STEPS} "
          f"{statistics.median(ms[1:]):.1f}; peak memory {peak:.2f} GiB; "
          f"run with its saves {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(os.path.join(ckdir, f"step_{XLSTM_STEPS:08d}"))
    saves = []
    free(dev)
    with final_save_counted(saves):
        out = train_loop(cut, tcfg, batch_size=XLSTM_BATCH,
                         seq_len=XLSTM_SEQ, steps=XLSTM_STEPS,
                         ckpt_dir=ckdir, log_every=0, device=dev)
    shutil.rmtree(ckdir, ignore_errors=True)
    check(out["resumed_from"] == XLSTM_CUT
          and out["losses"] == losses_a[XLSTM_CUT:]
          and all(math.isfinite(x) for x in losses_a),
          f"{tag}: resumed from step {out['resumed_from']}, losses "
          f"{out['losses']} bit-equal to the uninterrupted run's")
    del out
    free(dev)

    def carry_reset(real):
        def chunk(carry, *a):
            c, n, m = carry
            return real((torch.zeros_like(c), torch.zeros_like(n),
                         torch.full_like(m, xlstm.NEG_INIT)), *a)
        return chunk
    plants = {"mlstm_carry_reset": lambda: patched(
                  xlstm, "_mlstm_chunk", carry_reset),
              "slstm_recurrence_zeroed": lambda: patched(
                  xlstm, "_recurrent", lambda real: lambda p: real(p) * 0)}
    batch = lm_batch(0, 0, batch=XLSTM_BATCH, seq_len=XLSTM_SEQ,
                     vocab=cfg.vocab_size, device=dev)

    def ulp_bounds(sub, c, params, g64, paths):
        """Per leaf, XLSTM_ULP_RATIO times the farthest that a float64 step
        from params each moved by one f32 rounding
        (``conditioning.rounding_spreads``) lies from the float64 step, or
        LM_GRAD_RTOL."""
        spread = [max(s) for s in zip(*conditioning.rounding_spreads(
            c, params, batch, g64, XLSTM_ULP_DRAWS))]
        order = sorted(range(len(spread)), key=spread.__getitem__,
                       reverse=True)
        print(f"{sub}: float64 steps from params one f32 rounding off "
              f"({XLSTM_ULP_DRAWS} draws), farthest leaves "
              + ", ".join(f"{paths[i]} rel L2 {spread[i]:.2e}"
                          for i in order[:3]), flush=True)
        return [max(LM_GRAD_RTOL, XLSTM_ULP_RATIO * x) for x in spread]

    for depth in (XLSTM_F64_DEPTH, cfg.n_layers):
        c = cfg.with_(n_layers=depth)
        sub = f"{tag} ({depth} layers)"
        params = lm_init(0, c, dtype=torch.float32, device=dev)
        paths = [p for p, _ in tree.leaves_with_paths(params)]
        t0 = time.perf_counter()
        loss32, g32 = lm_grads(c, params, batch, torch.float32)
        t32 = time.perf_counter() - t0
        loss64, g64 = lm_grads(c, params, batch, torch.float64)
        print(f"{sub}: first step forward + backward {t32 * 1e3:.0f} ms "
              f"(f32), {(time.perf_counter() - t0 - t32) * 1e3:.0f} ms "
              f"(float64)", flush=True)
        if depth == XLSTM_F64_DEPTH:
            rtol, rule = LM_GRAD_RTOL, f"{LM_GRAD_RTOL:g}"
        else:
            rtol = ulp_bounds(sub, c, params, g64, paths)
            rule = (f"{XLSTM_ULP_RATIO:g} x that float64 spread, or "
                    f"{LM_GRAD_RTOL:g}")
        check(f64_verdict(sub, "clean", paths, loss32, g32, loss64, g64,
                          rtol),
              f"{sub} first step within {LM_LOSS_RTOL} (loss) and {rule} "
              f"(every gradient leaf, relative L2) of float64")
        del g32
        faults_fail(sub, XLSTM_FAULTS, lambda f: lm_grads(
            c, params, batch, torch.float32, plants[f]()), paths, loss64,
            g64, rtol)
        del g64
        free(dev)

    tick = serve_phase(dev, tag, cfg, params)
    b, t = XLSTM_DECODE
    toks = torch.randint(0, cfg.vocab_size, (b, t),
                         generator=torch.Generator(device=dev).manual_seed(3),
                         device=dev)

    def state_dropped():
        real = xlstm.mlstm_decode

        def dec(p, x, cache, c):
            for k, v in xlstm.mlstm_init_cache(c, x.shape[0],
                                               x.device).items():
                cache[k].copy_(v)
            return real(p, x, cache, c)
        return patched(transformer, "mlstm_decode", lambda r: dec)
    decode_check(XLSTM, cfg, params, toks, "mLSTM state not carried",
                 state_dropped)
    del params
    free(dev)
    return tick


def jamba_phase(dev):
    """jamba-1.5-large's layer 0 (Mamba + its dense SiLU-GLU FFN) at full
    width as a unit: forward and backward against float64 with the chunk
    carry reset planted; ``ssm_decode`` against ``ssm_apply`` with the
    state not carried planted."""
    import torch
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.models import common, ssm
    from repro_torch.models.transformer import block_apply, block_init

    cfg = ARCHS[JAMBA]
    tag = f"{JAMBA} layer 0 (M + FFN)"
    kind = cfg.layer_kinds()[0]
    assert kind == "M" and not cfg.layer_uses_moe(0)
    free(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = block_init(gen, cfg, kind, False, dtype=torch.float32)
    x = torch.randn((1, JAMBA_T, cfg.d_model), generator=gen, device=dev)
    r = torch.randn((1, JAMBA_T, cfg.d_model), generator=gen, device=dev)
    paths = ["x"] + [q for q, _ in tree.leaves_with_paths(p)]
    scfg = cfg.ssm_config()
    print(f"{tag}: {n_params(p) / 1e9:.3f} B params; d_inner "
          f"{scfg.d_inner}, d_state {scfg.d_state}, dt_rank {scfg.rank}, "
          f"chunk {scfg.chunk}; d_ff {cfg.d_ff}; 1 x {JAMBA_T}", flush=True)

    def run(dtype, plant=None, timed=False):
        leaves = [t.detach().to(dtype).requires_grad_(True)
                  for t in [x] + tree.leaves(p)]
        with contextlib.ExitStack() as st:
            st.enter_context(common.upcast(dtype))
            if plant:
                st.enter_context(plant())
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y, _ = block_apply(tree.unflatten_like(p, leaves[1:]), leaves[0],
                               cfg, kind, False)
            loss = (y * r.to(dtype)).sum()
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            g = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
        if timed:
            print(f"{tag}: forward {(t1 - t0) * 1e3:.1f} ms, backward (with "
                  f"the chunks recomputed) {(t2 - t1) * 1e3:.1f} ms, peak "
                  f"memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f}"
                  f" GiB", flush=True)
        return float(loss), g

    run(torch.float32)
    torch.cuda.reset_peak_memory_stats(dev)
    loss32, g32 = run(torch.float32, timed=True)
    loss64, g64 = run(torch.float64)
    check(f64_verdict(tag, "clean", paths, loss32, g32, loss64, g64),
          f"{tag}: forward and backward within {LM_LOSS_RTOL} and "
          f"{LM_GRAD_RTOL} (every leaf and dx, relative L2) of float64")
    del g32

    def reset(real):
        return lambda h0, *a: real(torch.zeros_like(h0), *a)
    faults_fail(tag, ("chunk_carry_reset",), lambda f: run(
        torch.float32, lambda: patched(ssm, "_chunk_body", reset)),
        paths, loss64, g64)
    del g64
    free(dev)

    sp = p["ssm"]
    xs = x[:, :JAMBA_DECODE_T]

    def decode(plant=False):
        with torch.inference_mode():
            cache = ssm.ssm_init_cache(scfg, 1, torch.float32, dev)
            ys = []
            for i in range(JAMBA_DECODE_T):
                if plant:
                    cache["h"].zero_()
                y, cache = ssm.ssm_decode(sp, xs[:, i:i + 1], cache, scfg)
                ys.append(y)
            return torch.cat(ys, dim=1)
    with torch.inference_mode():
        want = ssm.ssm_apply(sp, xs, scfg)
    clean, faulted = decode_reading(decode(), want), \
        decode_reading(decode(True), want)
    bound = DECODE_BOUND[JAMBA]
    print(f"{JAMBA} ssm_decode vs ssm_apply at 1 x {JAMBA_DECODE_T} (every "
          f"output): clean {clean:.3e}, state not carried {faulted:.3e} "
          f"(bound {bound:g} of max|y|)", flush=True)
    check(clean <= bound, f"{JAMBA}: ssm_decode within {bound:g} of "
          f"ssm_apply")
    check(faulted > bound, f"{JAMBA}: the decode check rejects the state "
          f"not carried")
    del p, sp, x, r, xs, want
    free(dev)


def deepseek_serve_phase(dev):
    """deepseek-v2-lite-16b at full width and depth in bf16: served, and
    decode (MLA's absorbed form over the latent cache) against the
    parallel forward with the capacity raised so no pair drops; that
    decode again at 4 layers, in bf16 (a reading) and in f32."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import attention
    from repro_torch.models.transformer import lm_init

    cfg = ARCHS[DEEPSEEK]
    free(dev)
    params = lm_init(0, cfg, dtype=torch.bfloat16, device=dev)
    print(f"{DEEPSEEK}: {n_params(params) / 1e9:.3f} B params, "
          f"{cfg.n_layers} layers (MLA, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared), bf16",
          flush=True)
    tick = serve_phase(dev, DEEPSEEK, cfg, params)
    wide = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    b, t = DEEPSEEK_DECODE
    toks = torch.randint(0, cfg.vocab_size, (b, t),
                         generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev)

    def latent_slot_off_by_one():
        def mla(real):
            return lambda p, x, cache, index, c: real(p, x, cache,
                                                      index + 1, c)
        return patched(attention, "_mla_decode", mla)
    decode_check(DEEPSEEK, wide, params, toks, "latent slot off by one",
                 latent_slot_off_by_one)
    del params
    free(dev)
    cut = wide.with_(n_layers=DEEPSEEK_F32_LAYERS)
    for dtype in (torch.bfloat16, torch.float32):
        params = lm_init(0, cut, dtype=dtype, device=dev)
        if dtype == torch.float32:
            decode_check(DEEPSEEK_F32, cut, params, toks,
                         "latent slot off by one", latent_slot_off_by_one)
        else:
            print(f"{DEEPSEEK} (bf16, {DEEPSEEK_F32_LAYERS} layers) "
                  f"decode_step vs the parallel forward: "
                  f"{decode_vs_parallel(DEEPSEEK, cut, params, toks):.3e}",
                  flush=True)
        del params
        free(dev)
    return tick


def serve_cli_phase():
    """``python -m repro_torch.launch.serve`` at its defaults, on the
    card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    last = proc.stdout.strip().splitlines()[-1:] or [proc.stderr[-400:]]
    print(f"launch.serve CLI: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s: {last[0]}", flush=True)
    check(proc.returncode == 0 and "served 8/8 requests" in last[0]
          and "on cuda" in last[0],
          "python -m repro_torch.launch.serve answered 8/8 on the card")


def slice9_phase(dev):
    """Phase 9: gemma3, xlstm, jamba's layer 0, deepseek served, the
    CLI.  Returns each path's launches of the port's kernels (none)."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    by_path = {}
    for name, fn in (("lm_gemma3", gemma3_phase), ("lm_xlstm", xlstm_phase),
                     ("lm_jamba_layer0", jamba_phase),
                     ("lm_deepseek_serve", deepseek_serve_phase)):
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        fn(dev)
        by_path[name] = kernels.launch_counts()
        print(f"phase 9 {name}: {time.perf_counter() - t1:.1f} s", flush=True)
        check(sum(by_path[name].values()) == 0,
              f"{name}: launches none of the sparse kernels")
    serve_cli_phase()
    print(f"phase 9 (windows, Mamba, xLSTM, bf16, serving): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 10: data-parallel training over two ranks on the one card
# ---------------------------------------------------------------------------

# NCCL refuses two ranks on one GPU, so the ranks of this phase are gloo
# ranks sharing cuda:0 (gloo all-reduces CUDA tensors through host
# memory); one NCCL world of one rank runs the same reduce through NCCL.
# The two ranks' kernels run on one card one after the other, so their
# step times are the sum of both ranks' work, not a two-card step.
DP_RANKS = 2
DP_JOIN_S, DP_CALL_S = 180, 900        # a rank that takes longer is killed
# (a): VGG16 conv13's weight gradient as a 2-D view (3·3·512 × 512) at
# the wire block (128, 128), the same block pattern on both ranks; the sum
# within DP_RTOL relative of the numpy sum.  An uncorrelated pair (each
# rank's blocks live at DP_UNCORR, a union of ~64 % > the 0.5 cutoff) must
# fall back on both ranks.
DP_SHAPE, DP_GRAN, DP_LIVE, DP_UNCORR = (4608, 512), (128, 128), \
    (0.25, 1.0), 0.4
DP_RTOL = 1e-6
DP_REPS = 5
# (c): SmolLM-360M over 2 ranks at phase 7's batch, AdamW at its learning
# rate from the first step (warmup 1, so that a fault moves the losses).
# The first step within phase 7's rule of the single-process step; steps
# 2-3's losses within DP_LM_LOSS_RTOL relative of the single-process
# loop's, a bound the planted fault (rank 1 applying its own gradient, not
# the reduced one) must break.  The SmolLM smoke config on the CPU gave
# ≤ 1.5e-7 clean and 2.9e-4 / 5.3e-5 with the fault (steps 2 / 3).
DP_LM_STEPS, DP_LM_CUT, DP_LM_LOSS_RTOL = 3, 2, 1e-5
DP_VGG16_GEOM = dict(image_size=224, width=1.0, num_classes=1000)


def correlated_stack(n, m, k, gran, live, seed):
    """(n, m, k) data and (n, mb, kb) bitmaps with one block pattern on
    every rank (the dW regime), ``live`` of the blocks live."""
    import numpy as np
    g0, g1 = gran
    mb, kb = -(-m // g0), -(-k // g1)
    rng = np.random.default_rng(seed)
    bm = np.zeros(mb * kb, np.int32)
    bm[rng.permutation(mb * kb)[:max(1, round(live * mb * kb))]] = 1
    bm = bm.reshape(mb, kb)
    expand = np.repeat(np.repeat(bm, g0, 0), g1, 1)[:m, :k]
    data = rng.standard_normal((n, m, k)).astype(np.float32) \
        * expand[None].astype(np.float32)
    return data, np.broadcast_to(bm, (n, mb, kb)).copy()


def uncorrelated_stack(n, m, k, gran, live, seed):
    import numpy as np
    g0, g1 = gran
    rng = np.random.default_rng(seed)
    bits = (rng.random((n, m // g0, k // g1)) < live).astype(np.int32)
    data = rng.standard_normal((n, m, k)).astype(np.float32) * np.repeat(
        np.repeat(bits, g0, 1), g1, 2).astype(np.float32)
    return data, bits


def dp_mesh(dev):
    from repro_torch.launch.mesh import init_mesh
    return init_mesh((DP_RANKS,), ("data",), backend="gloo", device=dev)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_ms(fn, dev, reps=DP_REPS):
    """Median ms of ``reps`` calls of ``fn``, each between device syncs."""
    ms = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def peak_gb(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else float("nan")


def timed_reduce(collectives, dev, log):
    """``collectives.psum_grads`` with each call's ms appended to
    ``log``."""
    real = collectives.psum_grads

    def timed(*a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = real(*a, **kw)
        sync(dev)
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    return timed


def reduce_case(mesh, dev, data, bits, cutoff=0.5):
    """sparse_psum of this rank's slice: (max rel err against the numpy
    sum, counts, wire bytes, compressed ms, dense ms)."""
    import numpy as np
    import torch
    from repro_torch.kernels import stats
    from repro_torch.sharding import collectives
    x = torch.from_numpy(data[mesh.rank]).to(dev)
    b = torch.from_numpy(bits[mesh.rank]).to(dev)
    want = data.astype(np.float64).sum(0)
    stats.reset()
    collectives.reset_wire_bytes()
    out = collectives.sparse_psum(x, b, DP_GRAN, mesh=mesh,
                                  axis_name="data", cutoff=cutoff)
    sync(dev)
    counts, wire = stats.counts(), collectives.wire_bytes()
    err = float(np.abs(out.cpu().numpy() - want).max()
                / max(np.abs(want).max(), 1e-30))
    prev = stats.set_runtime_counting(False)
    try:
        ms = timed_ms(lambda: collectives.sparse_psum(
            x, b, DP_GRAN, mesh=mesh, axis_name="data", cutoff=cutoff), dev)
        dense_ms = timed_ms(lambda: collectives.dense_psum(
            x, "data", mesh=mesh), dev)
    finally:
        stats.set_runtime_counting(prev)
    return {"err": err, "counts": counts, "wire": wire, "ms": ms,
            "dense_ms": dense_ms, "dense_wire": x.numel() * 4}


def dp_collectives_rank(device, shape):
    """(a) and (d) in one rank: sparse_psum at each live fraction, the
    uncorrelated pair, and the chaos matrix's collective case on this
    world."""
    import torch
    from repro_torch.runtime import faults
    dev = torch.device(device)
    mesh = dp_mesh(dev)
    out = {}
    for live in DP_LIVE:
        out[live] = reduce_case(mesh, dev, *correlated_stack(
            DP_RANKS, *shape, DP_GRAN, live, seed=3))
    out["uncorrelated"] = reduce_case(mesh, dev, *uncorrelated_stack(
        DP_RANKS, *shape, DP_GRAN, DP_UNCORR, seed=9))
    (row,) = faults.run_matrix(["collective"], device=dev)
    out["drop"] = (row.ok, row.detail)
    return out


def dp_nccl_world_of_one(dev):
    """The same reduce through NCCL, on a world of one rank in this
    process: each result equals the input bit for bit."""
    import torch
    from repro_torch.kernels import stats
    from repro_torch.launch.mesh import close_mesh, free_port, init_mesh
    from repro_torch.sharding import collectives
    mesh = init_mesh((1,), ("data",), backend="nccl", device=dev, rank=0,
                     world_size=1,
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        for live in DP_LIVE:
            data, bits = correlated_stack(1, *DP_SHAPE, DP_GRAN, live, 3)
            x = torch.from_numpy(data[0]).to(dev)
            stats.reset()
            out = collectives.sparse_psum(
                x, torch.from_numpy(bits[0]).to(dev), DP_GRAN, mesh=mesh,
                axis_name="data")
            c = stats.counts()
            key = "collective:compressed" if live <= 0.5 \
                else "collective:dense_fallback"
            print(f"phase 10 nccl world of one, live {live}: counts {c}",
                  flush=True)
            check(torch.equal(out, x) and c.get(key) == 1,
                  f"NCCL world of one: sparse_psum at live {live} returns "
                  f"its input through {key}")
        # phase 12: the event names NCCL gives the profiler
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.launch import hlo_analysis
        collectives.reset_wire_bytes()
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            collectives.dense_psum(x, "data", mesh=mesh)
            torch.cuda.synchronize(dev)
        events = hlo_analysis.trace_events(prof)
        NCCL_TRACE.update(
            bytes=hlo_analysis.collective_bytes(events),
            wire=collectives.wire_bytes(),
            names=sorted({e.name() for e in events
                          if "nccl" in e.name().lower()
                          or e.name().startswith("c10d::")}))
    finally:
        close_mesh()


def dp_collectives_phase(pool, dev, shape=DP_SHAPE):
    rows = pool.run(dp_collectives_rank, str(dev), shape, timeout=DP_CALL_S)
    for live in DP_LIVE + ("uncorrelated",):
        rs = [r[live] for r in rows]
        summed = {k: sum(r["counts"].get(k, 0) for r in rs)
                  for k in ("collective:compressed",
                            "collective:dense_fallback")}
        for rank, r in enumerate(rs):
            print(f"phase 10 sparse_psum {shape} at {DP_GRAN}, live "
                  f"{live}, rank {rank}: rel err {r['err']:.2e}; wire "
                  f"{r['wire']} B vs dense {r['dense_wire']} B; "
                  f"{r['ms']:.3f} ms vs dense_psum {r['dense_ms']:.3f} ms "
                  f"(gloo, 2 ranks on one card); counts {r['counts']}",
                  flush=True)
            check(r["err"] <= DP_RTOL and
                  r["counts"].get("collective:bitmap_psum") == 1,
                  f"rank {rank}: sparse_psum at live {live} equals the sum "
                  f"of the ranks' inputs within {DP_RTOL}")
        want = "collective:compressed" if live == 0.25 \
            else "collective:dense_fallback"
        check(summed[want] == DP_RANKS and sum(summed.values()) == DP_RANKS,
              f"live {live}: {want} on every rank ({summed})")
    for rank, r in enumerate(rows):
        ok, detail = r["drop"]
        print(f"phase 10 chaos collective-drop-contrib, rank {rank}: "
              f"{detail}", flush=True)
        check(ok, f"rank {rank}: the dropped contribution is detected by "
              f"probe_emit and the dense reduce is exact under it")
    if dev.type == "cuda":
        dp_nccl_world_of_one(dev)


def vgg16_spmd_rank(device, geom):
    """(b) in one rank: VGG16 IN_OUT_WR's data-parallel gradient over the
    global batch of 8, its counts and launches, then one more step held
    call by call against the plain versions; rank 0 also takes the
    single-process step on the same 8 images and holds the two apart."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.core.policy import SCENARIOS
    from repro_torch.data.pipeline import image_batch
    from repro_torch.kernels import stats
    from repro_torch.models.cnn import build_cnn
    from repro_torch.sharding import collectives, spmd_step

    set_full_precision()
    dev = torch.device(device)
    mesh = dp_mesh(dev)
    model = build_cnn("vgg16", **geom)
    params = model.init(0, device=dev)
    batch = image_batch(0, 0, batch=8, image_size=geom["image_size"],
                        num_classes=geom["num_classes"], device=dev)
    pol = SCENARIOS["IN_OUT_WR"].with_(kernel_impl="pallas")

    def loss_fn(p, b):
        return model.loss(p, b[0], b[1], pol)

    grad_fn = spmd_step.make_spmd_grad_fn(loss_fn, mesh)
    reduce_ms = []
    real = collectives.psum_grads
    collectives.psum_grads = timed_reduce(collectives, dev, reduce_ms)
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stats.reset()
        collectives.reset_wire_bytes()
        sync(dev)
        # The main path: every launch counter is 0 just before, read just
        # after.
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = grad_fn(params, batch)
        sync(dev)
        step_ms = [(time.perf_counter() - t0) * 1e3]
        launches = kernels.launch_counts()
        counts, wire = stats.counts(), collectives.wire_bytes()
        elided = stats.elided()
        for _ in range(2):
            step_ms.append(timed_ms(lambda: grad_fn(params, batch), dev, 1))
    finally:
        collectives.psum_grads = real
    out = {"loss": float(loss), "counts": counts, "elided": elided,
           "launches": launches, "step_ms": step_ms, "reduce_ms": reduce_ms, "wire": wire,
           "peak_gb": peak_gb(dev)}
    # One more step, apart from the counted one, with every K1 encode, K2
    # queue and GEMM dispatch (K3 with its split-K reduce and NaN fix-up)
    # held against its plain version at this rank's shapes.
    first = len(FAILURES)
    stats.reset()
    with held_against_plain(dev, f"vgg16_spmd rank {mesh.rank}") as (
            held, _, _):
        grad_fn(params, batch)
    out["held"] = (held, ran_counts(stats.counts(), stats.elided()),
                   FAILURES[first:])
    if mesh.rank == 0:
        stats.reset()
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss1 = loss_fn(tree.unflatten_like(params, leaves), batch)
        grads1 = torch.autograd.grad(loss1, leaves)
        out["single_counts"] = stats.counts()
        out["single_loss"] = float(loss1.detach())
        # σ′ flips: each rank's forward on its rows against the whole
        # batch's forward on the same rows (phase 4's rule).
        caps, flips = {}, {}
        n = batch[0].shape[0] // mesh.size
        with torch.no_grad():
            model.apply(params, batch[0], pol, capture=caps)
            for r in range(mesh.size):
                part = {}
                model.apply(params, batch[0][r * n:(r + 1) * n], pol,
                            capture=part)
                for k, v in part.items():
                    flips[k] = flips.get(k, 0) + int(
                        ((v > 0) != (caps[k][r * n:(r + 1) * n] > 0)).sum())
        order = list(caps)
        flipped = [order.index(k) for k, f in flips.items() if f]
        top = max(flipped) if flipped else -1
        out["flips"] = (flips, sum(v.numel() for v in caps.values()),
                        order[top] if flipped else None)
        del caps
        rows = []
        for (path, _), a, b in zip(tree.leaves_with_paths(params),
                                   tree.leaves(grads), grads1):
            ratio = float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
            close = bool(torch.allclose(a, b, atol=1e-3, rtol=1e-3))
            layer = path.split("'")[1]
            below = layer in order and order.index(layer) <= top
            rows.append((path, ratio, close,
                         STEP_RTOL_FLIPPED if below else KERNEL_RTOL))
        out["leaves"] = rows
    return out


def vgg16_spmd_phase(pool, dev, geom=DP_VGG16_GEOM):
    rows = pool.run(vgg16_spmd_rank, str(dev), geom, timeout=DP_CALL_S)
    r0 = rows[0]
    single = r0["single_counts"]
    for rank, r in enumerate(rows):
        print(f"phase 10 vgg16 IN_OUT_WR data-parallel, rank {rank} of "
              f"{DP_RANKS} (4 of the 8 images): loss {r['loss']:.7f}; step "
              f"ms {[round(x, 1) for x in r['step_ms']]} (the first with "
              f"warm-up); all-reduce ms {[round(x, 1) for x in r['reduce_ms']]}"
              f"; wire {r['wire']} B; peak {r['peak_gb']:.2f} GiB; counts "
              f"{r['counts']}; launches {r['launches']}", flush=True)
        c = r["counts"]
        check(abs(r["loss"] - r0["single_loss"]) <= 1e-5,
              f"rank {rank}: data-parallel loss {r['loss']:.7f} within 1e-5 "
              f"of the single-process step's {r0['single_loss']:.7f}")
        check(not any(k.startswith("scan") for k in c),
              f"rank {rank}: no scan:* keys")
        trace = {k: v for k, v in c.items()
                 if not k.startswith("collective:")}
        check(trace == single, f"rank {rank}: its trace-time counts equal "
              f"the single-process step's ({single})")
        check(c.get("collective:bitmap_psum", 0) == 0
              and c.get("collective:dense") == 14,
              f"rank {rank}: every leaf reduces dense (14 collective:dense, "
              f"no bitmap: the head's WG has no operand mask, as in the "
              f"reference)")
        check(r["launches"] == r0["launches"],
              f"rank {rank}: the same kernel launches as rank 0")
        held, hc, fails = r["held"]
        print(f"phase 10 vgg16_spmd rank {rank} audit step: {held}; its "
              f"counts {hc}", flush=True)
        check(not fails
              and held["gemm"] == _sum(hc, "gemm:")
              == _sum(ran_counts(c, r["elided"]), "gemm:") > 0
              and held["queue"] == hc.get("queue:prefix_sum", 0)
              == ran_counts(c, r["elided"]).get("queue:prefix_sum", 0)
              and held["encode"] == hc.get("encode:act")
              == c.get("encode:act"),
              f"rank {rank}: every dispatch, queue and encode of a "
              f"data-parallel step at this rank's shapes held against its "
              f"plain version, as many as the counted step's ({len(fails)} "
              f"failed)")
    flips, n_act, top = r0["flips"]
    print(f"phase 10 vgg16 ReLU sign flips, each rank's forward vs the whole "
          f"batch's on the same rows: {sum(flips.values())} of {n_act} "
          f"{flips}; highest flipped layer {top}", flush=True)
    check(sum(flips.values()) <= FLIP_SHARE * n_act,
          f"vgg16 data-parallel sign flips <= {FLIP_SHARE} x {n_act}")
    for path, ratio, close, rtol in r0["leaves"]:
        print(f"phase 10 vgg16 data-parallel grad {path}: max|Δ|/max|g| "
              f"{ratio:.3e} (rule {rtol:g}); allclose(1e-3, 1e-3) {close}",
              flush=True)
        check(close and ratio <= rtol,
              f"vgg16 data-parallel grad {path} within atol = rtol = 1e-3 "
              f"and max|Δ| <= {rtol:g} max|g| of the single-process step "
              f"({'at or below' if rtol > KERNEL_RTOL else 'above'} the "
              f"highest flip)")
    if dev.type == "cuda":
        check_path_kernels("vgg16_spmd", r0["launches"], STEP_KERNELS)
    return r0["launches"]


def lm_spmd_rank(device, smoke, ckdir):
    """(c) in one rank: SmolLM-360M's first step against the
    single-process step (rank 0), then guarded ``train_loop(mesh,
    spmd=True)`` runs: A, 3 steps; B, 2 steps into ``ckdir``; C, resumed
    from it to 3 (its final save counted, not written); F, A with the
    planted fault; rank 0 then runs the single-process loop."""
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels, tree
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch.train import train_loop
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.runtime.guards import StepGuard
    from repro_torch.sharding import collectives, spmd_step

    set_full_precision()
    dev = torch.device(device)
    mesh = dp_mesh(dev)
    cfg = without_remat((SMOKE_ARCHS if smoke else ARCHS)[LM_ARCH],
                        f"lm_spmd {LM_ARCH}" if mesh.rank == 0 else None)
    seq = 32 if smoke else LM_SEQ
    tcfg = TrainConfig(total_steps=DP_LM_STEPS, warmup_steps=1,
                       checkpoint_every=0, keep_checkpoints=1, seed=0)
    out = {}

    # the first step's gradients against the single-process step
    params = lm_init(tcfg.seed, cfg, dtype=torch.float32, device=dev)
    batch = lm_batch(tcfg.seed, 0, batch=LM_BATCH, seq_len=seq,
                     vocab=cfg.vocab_size, device=dev)
    grad_fn = spmd_step.make_spmd_grad_fn(lambda p, b: lm_loss(p, b, cfg),
                                          mesh)
    # phase 12: this step's collectives from the profiler's trace, beside
    # the bytes the collectives layer counted
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import hlo_analysis
    collectives.reset_wire_bytes()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        loss, grads = grad_fn(params, batch)
    events = hlo_analysis.trace_events(prof)
    out["trace"] = (hlo_analysis.collective_bytes(events,
                                                  group_size=mesh.size),
                    collectives.wire_bytes(),
                    sorted({e.name() for e in events
                            if e.name().startswith(("gloo:", "nccl:"))}))
    del events
    del prof
    if mesh.rank == 0:
        leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
        loss1 = lm_loss(tree.unflatten_like(params, leaves), batch, cfg)
        grads1 = torch.autograd.grad(loss1, leaves)
        rels = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(tree.leaves(grads), grads1)]
        out["first"] = (float(loss), float(loss1.detach()), max(rels))
        del grads1, leaves, loss1
    del params, grads, loss

    commits = []
    prev_hook = ckpt.set_crash_hook(
        lambda name: commits.append(name)
        if name == "checkpoint:pre_commit" else None)
    reduce_ms = []
    real = collectives.psum_grads

    def run(steps, ckpt_dir=None):
        guard = StepGuard()
        stamps = [time.perf_counter()]
        res = train_loop(cfg, tcfg, batch_size=LM_BATCH, seq_len=seq,
                         steps=steps, ckpt_dir=ckpt_dir, log_every=0,
                         guard=guard, device=dev, mesh=mesh, spmd=True,
                         on_metrics=lambda i, m: stamps.append(
                             time.perf_counter()))
        sync(dev)
        host = [p.detach().cpu() for p in tree.leaves(res["params"])]
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return res["losses"], [v for _, v in guard.verdicts], host, ms, \
            res["resumed_from"]

    try:
        collectives.psum_grads = timed_reduce(collectives, dev, reduce_ms)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        collectives.reset_wire_bytes()
        kernels.reset_launch_counts()
        a = run(DP_LM_STEPS)
        out["launches"] = kernels.launch_counts()
        out["peak_gb"] = peak_gb(dev)
        out["wire_per_step"] = collectives.wire_bytes() / DP_LM_STEPS
        out["reduce_ms"] = reduce_ms
        collectives.psum_grads = real
        t0 = time.perf_counter()
        b = run(DP_LM_CUT, ckdir)
        out["b_s"] = time.perf_counter() - t0
        out["commits_b"] = len(commits)
        saves = []
        with patched(ckpt, "save", lambda real_save: (
                lambda path, step, tree_, **kw: saves.append(step))):
            c = run(DP_LM_STEPS, ckdir)
        out["saves_c"] = saves

        def planted(g, **kw):
            res = real(g, **kw)
            n = mesh.size
            return tree.tree_map(lambda x: x * n, g) if mesh.rank == 1 \
                else res

        collectives.psum_grads = planted
        f = run(DP_LM_STEPS)
    finally:
        collectives.psum_grads = real
        ckpt.set_crash_hook(prev_hook)
    out.update(
        losses_a=a[0], verdicts_a=a[1], step_ms=a[3], losses_b=b[0],
        losses_c=c[0], resumed=c[4], verdicts_c=c[1], losses_f=f[0],
        bit_equal=all(torch.equal(x, y) for x, y in zip(a[2], c[2])),
        param_diff=max(float((x - y).abs().max()) for x, y in zip(a[2], c[2])),
        n_params=sum(x.numel() for x in a[2]))
    if mesh.rank == 0:
        single = train_loop(cfg, tcfg, batch_size=LM_BATCH, seq_len=seq,
                            steps=DP_LM_STEPS, log_every=0, device=dev)
        out["losses_single"] = single["losses"]
    return out


def lm_spmd_phase(pool, dev, smoke=False, ckdir=None):
    """(c) on the pool's ranks; the checkpoint goes to ``ckdir`` (default
    a new temporary directory), removed after."""
    import shutil
    import tempfile
    ckdir = ckdir or tempfile.mkdtemp(prefix="smoke_lm_spmd_")
    try:
        rows = pool.run(lm_spmd_rank, str(dev), smoke, ckdir,
                        timeout=DP_CALL_S)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    DP_TRACE[:] = [r["trace"] for r in rows]
    r0 = rows[0]
    loss_dp, loss1, worst = r0["first"]
    print(f"phase 10 {LM_ARCH} data-parallel first step: loss {loss_dp:.7f} "
          f"vs single-process {loss1:.7f}; worst gradient leaf rel L2 "
          f"{worst:.2e}", flush=True)
    check(abs(loss_dp - loss1) <= LM_LOSS_RTOL * abs(loss1)
          and worst <= LM_GRAD_RTOL,
          f"{LM_ARCH} data-parallel first step within {LM_LOSS_RTOL} (loss) "
          f"and {LM_GRAD_RTOL} (every leaf, relative L2) of the "
          f"single-process step")
    single = r0["losses_single"]

    def rel(losses):
        return [abs(x - y) / abs(y) for x, y in zip(losses, single)]

    for rank, r in enumerate(rows):
        print(f"phase 10 {LM_ARCH} train_loop(spmd=True), rank {rank} of "
              f"{DP_RANKS}, {r['n_params'] / 1e6:.1f} M params, global batch "
              f"{LM_BATCH} x {LM_SEQ}: losses {r['losses_a']} (single-process"
              f" {single}); step ms {[round(x, 1) for x in r['step_ms']]}; "
              f"all-reduce ms {[round(x, 1) for x in r['reduce_ms']]} for "
              f"{r['wire_per_step']:.0f} B a step (gloo through host "
              f"memory; both ranks on one card); peak {r['peak_gb']:.2f} "
              f"GiB; run B {r['b_s']:.1f} s with its save; planted fault "
              f"losses {r['losses_f']} (rel {rel(r['losses_f'])})",
              flush=True)
        check(r["verdicts_a"] == ["ok"] * DP_LM_STEPS,
              f"rank {rank}: every guarded step's verdict is ok")
        check(r["losses_a"] == rows[0]["losses_a"],
              f"rank {rank}: the same losses as rank 0")
        check(max(rel(r["losses_a"])) <= DP_LM_LOSS_RTOL,
              f"rank {rank}: losses within {DP_LM_LOSS_RTOL} relative of "
              f"the single-process loop's ({rel(r['losses_a'])})")
        check(max(rel(r["losses_f"])[1:]) > DP_LM_LOSS_RTOL,
              f"rank {rank}: the bound rejects the planted fault "
              f"(rank 1 applying its own gradient)")
        tail = r["losses_a"][DP_LM_CUT:]
        resume_rel = max(abs(x - y) / abs(y)
                         for x, y in zip(r["losses_c"], tail))
        print(f"phase 10 {LM_ARCH} rank {rank}: resumed step "
              f"{DP_LM_STEPS} loss {r['losses_c']} vs {tail} uninterrupted; "
              f"params bit-equal: {r['bit_equal']} (max |Δ| "
              f"{r['param_diff']:.3e})", flush=True)
        check(r["resumed"] == DP_LM_CUT
              and r["losses_b"] == r["losses_a"][:DP_LM_CUT]
              and (r["losses_c"] == tail or resume_rel <= LM_RESUME_RTOL),
              f"rank {rank}: resumed at step {DP_LM_CUT}, its step "
              f"{DP_LM_STEPS} loss equal to the uninterrupted run's "
              f"(bit-equal, or within {LM_RESUME_RTOL})")
        check(r["commits_b"] == (1 if rank == 0 else 0)
              and r["saves_c"] == ([DP_LM_STEPS] if rank == 0 else []),
              f"rank {rank}: {'only this rank' if rank == 0 else 'nothing'} "
              f"wrote the checkpoint")
        check(sum(r["launches"].values()) == 0,
              f"rank {rank}: the dense decoder launches none of the sparse "
              f"kernels")
    return r0["launches"]


def dp_phase(dev):
    """Phase 10: (a) sparse_psum on the card over two gloo ranks and one
    NCCL world, (b) VGG16 IN_OUT_WR data-parallel, (c) SmolLM-360M through
    train_loop(mesh, spmd=True), (d) the chaos case on the two ranks (the
    matrix's other cases run in phase 7).  A rank's exception, or a rank
    that hangs past its timeout, fails the phase."""
    from repro_torch.launch.mesh import RankError, RankPool
    t0 = time.perf_counter()
    by_path = {}
    try:
        with RankPool(DP_RANKS, backend="gloo", device=str(dev),
                      timeout=DP_JOIN_S) as pool:
            print(f"phase 10: {DP_RANKS} gloo ranks on {dev} joined in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for name, fn in (("collectives", dp_collectives_phase),
                             ("vgg16_spmd", vgg16_spmd_phase),
                             ("lm_spmd", lm_spmd_phase)):
                t1 = time.perf_counter()
                res = fn(pool, dev)
                if res is not None:
                    by_path[name] = res
                print(f"phase 10 {name}: {time.perf_counter() - t1:.1f} s",
                      flush=True)
    except RankError as e:
        check(False, f"phase 10: {e}")
    print(f"phase 10 (data-parallel over {DP_RANKS} ranks): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 11: the bitmap-contract verifier on the card
# ---------------------------------------------------------------------------

# Every kernel of the table: the sweep must launch each one.
SWEEP_KERNELS = ("relu_encode", "queue_builder", "compact_gemm",
                 "predicated_gemm", "splitk_reduce", "queue_member",
                 "emit_nan_fixup", "bitmap_scan", "masked_matmul_2d",
                 "compact_masked_matmul_2d")
# The kernels of one IN_OUT_WR step (phase 4's paths without the IN_OUT
# step, which alone launches predicated_gemm).
AUDIT_KERNELS = {net: tuple(k for k in PATHS[net][3] if k != "predicated_gemm")
                 for net in ("vgg16", "mobilenet")}
# Each planted fault and the code that must catch it (the capacity below
# the live count must be absorbed by the overflow fallback: no code).
SWEEP_PLANTS = {"short_output": "STORE_OOB", "duplicate_slot": "DOUBLE_WRITE",
                "extra_split": "ACC_READ_BEFORE_WRITE",
                "queue_short": "QUEUE_WRITE_OOB",
                "tiles_overstated": "DUMP_SLOT_LEAK",
                "capacity_below_live": None}


def audited_step(dev, net, image_size=224, width=1.0, num_classes=1000,
                 batch=8):
    """(a) One full-width IN_OUT_WR step of ``net`` through the kernels,
    unaudited and then under the trace audit: zero violations, the audited
    loss and gradients equal to the unaudited ones bit for bit, one encode
    region per ``encode:act`` count (and one scan region per
    ``scan_pallas:act``); returns the audited step's launches."""
    import torch
    from repro_torch.analysis import trace_audit
    from repro_torch.core.policy import SCENARIOS
    from repro_torch.data.pipeline import image_batch
    from repro_torch.kernels import stats
    from repro_torch.models.cnn import build_cnn

    _, scan, bn_seed, _ = PATHS[net]
    model = build_cnn(net, image_size=image_size, width=width,
                      num_classes=num_classes)
    params = model.init(0, device=dev)
    if bn_seed is not None:
        perturb_batchnorm(params, bn_seed)
    img, labels = image_batch(0, 0, batch=batch, image_size=image_size,
                              num_classes=num_classes, device=dev)
    pol = SCENARIOS["IN_OUT_WR"].with_(kernel_impl="pallas",
                                       scan_signed_inputs=scan)
    step = trace_audit.grad_step(lambda p: model.loss(p, img, labels, pol),
                                 params)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    step()                                   # warm-up
    (loss, grads), plain_ms = timed(step)
    # The recorder's first call pays one-time work of its own (PyTorch's
    # Python dispatch tables): timed apart, then the counted call.
    _, first_ms = timed(lambda: trace_audit.trace_fn(step))
    stats.reset()
    (res, audit_ms), launches = launches_of(
        timed, lambda: trace_audit.trace_fn(step))
    (loss_a, grads_a), trace = res
    counts = stats.counts()
    t0 = time.perf_counter()
    vs = trace_audit.audit_trace(trace, workload=net)
    check_s = time.perf_counter() - t0
    regions = trace.region_counts()
    tag = f"phase 11 {net} audit"
    print(f"{tag}: step {plain_ms:.1f} ms unaudited, {audit_ms:.1f} ms "
          f"under the recorder (its first call {first_ms:.1f} ms); checks "
          f"{check_s * 1e3:.0f} ms over "
          f"{len(trace.ops)} ops; regions {regions}; "
          f"{len(trace.gemm_specs)} GemmSpecs", flush=True)
    for v in vs:
        print(f"  {v}", flush=True)
    check(vs == [], f"{tag}: zero violations ({len(vs)})")
    check(torch.equal(loss, loss_a) and len(grads) == len(grads_a)
          and all(torch.equal(g, h) for g, h in zip(grads, grads_a)),
          f"{tag}: audited loss and gradients bit-equal to the unaudited "
          f"step's")
    check(regions.get("encode", 0) == counts.get("encode:act", -1) > 0,
          f"{tag}: encode regions {regions.get('encode', 0)} == encode:act "
          f"{counts.get('encode:act')}")
    check(regions.get("scan", 0) == counts.get("scan_pallas:act", 0),
          f"{tag}: scan regions {regions.get('scan', 0)} == scan_pallas:act "
          f"{counts.get('scan_pallas:act', 0)}")
    check(regions.get("gemm", 0) == len(trace.gemm_specs) > 0,
          f"{tag}: one gemm region per dispatch "
          f"({regions.get('gemm', 0)}, {len(trace.gemm_specs)})")
    check_path_kernels(f"audit_{net}", launches, AUDIT_KERNELS[net])
    return launches


def audit_plants(dev):
    """(b) Faults planted on the card, each caught by the audit: a second
    bitmap_scan of dy (RESCAN), a torch.matmul on the path (DENSE_GEMM), a
    hand-built GemmSpec (SPEC_UNRESOLVED); and the five standard workloads
    clean."""
    import torch
    from repro_torch.analysis import trace_audit
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(64, 64, generator=gen, device=dev)
    w = torch.randn(64, 64, generator=gen, device=dev)

    def rescan(dy):
        b1 = ops.bitmap_scan(dy, block=(8, 8), kind="grad")
        b2 = ops.bitmap_scan(dy, block=(8, 8), kind="grad")
        return b1.sum() + b2.sum()

    def dense(a, b):
        return torch.matmul(torch.relu(a), b).sum()

    def adhoc(a, b):
        spec = ops.GemmSpec(block=(8, 8, 8), schedule="predicated")
        bm = ops.bitmap_scan(a, block=(8, 8), kind="act")
        return ops.sparse_gemm(a, b, (bm, None), spec).sum()

    for fn, args, code in ((rescan, (x,), "RESCAN"),
                           (dense, (x, w), "DENSE_GEMM"),
                           (adhoc, (x, w), "SPEC_UNRESOLVED")):
        codes = sorted({v.code for v in trace_audit.audit_fn(
            fn, *args, workload="plant")})
        print(f"phase 11 audit plant {fn.__name__}: {codes}", flush=True)
        check(code in codes, f"phase 11: planted {fn.__name__} caught as "
                             f"{code} on the card ({codes})")
    t0 = time.perf_counter()
    vs, launches = launches_of(trace_audit.audit_workloads, device=dev)
    print(f"phase 11 standard workloads {sorted(trace_audit.WORKLOADS)}: "
          f"{len(vs)} violations, {time.perf_counter() - t0:.1f} s",
          flush=True)
    for v in vs:
        print(f"  {v}", flush=True)
    check(vs == [], "phase 11: the five standard workloads audit clean")
    return launches


def sanitizer_phase(dev):
    """(c) The kernel sweep on the card, clean and planted, and whether
    compute-sanitizer can run here."""
    from repro_torch.analysis import kernel_sanitizer as ks
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load(shadow=True)
    print(f"phase 11 shadow build: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    plain = ks.sweep(dev, shadow=False)
    guard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw = ks.sweep(dev)
    both_s = time.perf_counter() - t0
    print(f"phase 11 sweep: guard bands and poison {guard_s:.2f} s "
          f"({len(plain.violations)} violations); with the shadow build's "
          f"store counts {both_s:.2f} s ({len(sw.violations)} violations); "
          f"launches {dict(sw.launches)}", flush=True)
    for v in sw.violations + plain.violations:
        print(f"  {v}", flush=True)
    check(sw.violations == [] and plain.violations == [],
          "phase 11: the kernel sweep is clean on the card")
    bad = sw.bad_errors()
    check(not bad, f"phase 11: every swept kernel equals its plain version "
                   f"({bad or len(sw.errors)} cases)")
    for name in SWEEP_KERNELS:
        check(sw.launches[name] > 0,
              f"phase 11: the sweep launched {name} ({sw.launches[name]})")
    for name, code in SWEEP_PLANTS.items():
        t0 = time.perf_counter()
        got = ks.plant(name, dev)
        codes = sorted({v.code for v in got.violations})
        print(f"phase 11 sweep plant {name}: {codes} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        if code is None:
            check(codes == [] and not got.bad_errors()
                  and got.queue is not None and got.queue[2] == 16
                  and list(got.queue[0]) == [0, 0, 0, 0, 1],
                  f"phase 11: plant {name} absorbed by the overflow "
                  f"fallback (n_live 16, ii [0, 0, 0, 0, 1])")
        else:
            check(code in codes, f"phase 11: plant {name} caught as {code}")
    t0 = time.perf_counter()
    status = ks.compute_sanitizer_status()
    print(f"phase 11 compute-sanitizer (memcheck, racecheck, initcheck): "
          f"{status} ({time.perf_counter() - t0:.1f} s); "
          + ("not used by the sweep" if status == "usable"
             else "left out of the sweep"), flush=True)


def analysis_phase(dev):
    """Phase 11: returns the launches of each of its paths."""
    from repro_torch.analysis import lint

    t0 = time.perf_counter()
    by_path = {f"audit_{net}": audited_step(dev, net) for net in PATHS}
    by_path["audit_workloads"] = audit_plants(dev)
    sanitizer_phase(dev)
    t1 = time.perf_counter()
    vs = lint.lint_paths([os.path.join(SRC, "repro_torch")])
    print(f"phase 11 lint of src/repro_torch: {len(vs)} violations "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    for v in vs:
        print(f"  {v}", flush=True)
    check(vs == [], "phase 11: src/repro_torch lints clean")
    print(f"phase 11 (the verifier): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 13: tensor parallelism and FSDP
# ---------------------------------------------------------------------------

# Four gloo ranks share cuda:0 (NCCL refuses two ranks on one GPU) as a
# ("data", "model") = (2, 2) mesh, params and optimizer state DTensors
# placed by the partition rules.  Their kernels run on one card one after
# another, so a step's time is the four ranks' work, and what the layout
# saves (memory per card) cannot show: the bytes a rank holds are checked
# against the specs instead.  The first step's loss within LM_LOSS_RTOL
# relative and every leaf after a run within LM_GRAD_RTOL relative L2 of
# the single-process loop's (phase 7's path); each planted fault must
# break that rule after one step.  A checkpoint saved by the FSDP layout
# resumes on the spmd layout (phase 10's) and in the single-process loop,
# each resumed step's loss within DP_LM_LOSS_RTOL of the uninterrupted
# run's.
TP_RANKS, TP_MESH, TP_AXES = 4, (2, 2), ("data", "model")
TP_STEPS, TP_CUT = 3, 2
# Each collective of gloo on a shared card moves through host memory while
# four processes take turns on the card, and a TP step issues ~10 a layer,
# so the script trains TP_LAYERS of SmolLM-360M's 32 layers at full width
# (PERF.md §6); ``tp_phase(dev, layers=32)`` runs the whole depth.
TP_LAYERS = 4
TP_FAULTS = ("shard_row_off", "grad_reduce_dropped")
TP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single",
                  "dtensor all_gather", "dtensor reduce_scatter",
                  "dtensor all_to_all", "dtensor all_reduce")
# The captured input of seamless decoder layer 0's FFN (phase 8), on the
# host for phase 13's ranks; without it (phase 13 alone) the same shapes
# are drawn from a seed.
FFN_CAPTURE = {}
FFN_TP_ROWS, FFN_TP_DIMS = 2048, (1024, 4096)


def tp_mesh(dev):
    from repro_torch.launch.mesh import init_mesh
    return init_mesh(TP_MESH, TP_AXES, backend="gloo", device=dev)


def tp_probe_rank(device):
    """Each collective DTensor may issue, once on a CUDA tensor of this
    rank over the world, then each through a DTensor redistribution on
    the mesh's ``DeviceMesh`` (a host mesh under gloo: see
    ``launch.mesh.Mesh.device_mesh``): "ok", "wrong" or why it was
    refused."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=dev)
    wants = {
        "all_reduce": torch.full((4,), n * (n + 1) / 2),
        "all_gather_into_tensor": torch.arange(1, n + 1).float()
        .repeat_interleave(4),
        "reduce_scatter_tensor": torch.arange(4 * r, 4 * r + 4).float() * n
        + n * (n - 1) / 2,
        "all_to_all_single": torch.arange(n).float() * 0 + r * 10
        + torch.arange(n).float()}

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return t

    def all_gather():
        t = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(t, x)
        return t

    def reduce_scatter():
        t = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(
            t, torch.arange(4 * n, device=dev).float() + r)
        return t

    def all_to_all():
        t = torch.empty(n, device=dev)
        dist.all_to_all_single(t, torch.arange(n, device=dev).float() * 10
                               + r)
        return t

    def placed(src, dst):
        """A DTensor of the (2, 2) mesh's DeviceMesh moved from ``src`` to
        ``dst`` placements (DTensor's own functional collectives)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        pl = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1),
              "P": Partial()}
        dm = tp_mesh(dev).device_mesh()
        t = torch.arange(16.0, device=dev).reshape(4, 4)
        d = DTensor.from_local(t, dm, [pl[k] for k in src], run_check=False)
        return d.redistribute(placements=[pl[k] for k in dst]).full_tensor()

    full = torch.arange(16.0).reshape(4, 4)
    wants.update({"dtensor all_gather": full.repeat(4, 1),
                  "dtensor reduce_scatter": full * 2,
                  "dtensor all_to_all": full.repeat(2, 1),
                  "dtensor all_reduce": full * 4})
    cases = (all_reduce, all_gather, reduce_scatter, all_to_all,
             lambda: placed(("S0", "S0"), ("R", "R")),
             lambda: placed(("P", "R"), ("S0", "R")),
             lambda: placed(("S0", "R"), ("S1", "R")),
             lambda: placed(("P", "P"), ("R", "R")))
    out = {}
    for name, fn in zip(TP_COLLECTIVES, cases):
        try:
            got = fn()
            sync(dev)
            out[name] = "ok" if torch.equal(got.cpu(), wants[name]) \
                else f"wrong: {got.cpu().tolist()}"
        except Exception as e:                  # noqa: BLE001
            out[name] = f"refused: {type(e).__name__}: " \
                f"{str(e).strip().splitlines()[0][:200]}"
    return out


def tp_probe(pool, dev):
    rows = pool.run(tp_probe_rank, str(dev), timeout=DP_JOIN_S)
    for rank, r in enumerate(rows):
        print(f"phase 13 probe, gloo on {dev.type} tensors, rank {rank}: "
              f"{r}", flush=True)
    return rows[0]


def _local_bytes(tree_):
    from repro_torch import tree
    from repro_torch.sharding import partition
    return sum(partition.local(x).numel() * x.element_size()
               for x in tree.leaves(tree_))


def _plant(fault, mesh, leaf_shape):
    """A context planting ``fault`` for the first leaf of ``leaf_shape``:
    its param shard taken one row off on rank 1 (rolled by one along its
    first split dim), or its gradient's reduction over the data axes
    dropped on every rank (each rank's partial sum taken as the sum: a
    collective left out on one rank alone would hang its peers)."""
    from repro_torch.launch import steps
    from repro_torch.sharding import partition
    state = {"done": False}

    def hit(shape):
        if tuple(shape) != leaf_shape or state["done"]:
            return False
        if fault == "shard_row_off":
            state["done"] = True
            return mesh.rank == 1
        return True

    if fault == "shard_row_off":
        def wrap(real):
            def local_slice(self, full):
                x = real(self, full)
                if hit(full.shape):
                    d = next(i for i, e in enumerate(self.spec) if e)
                    x = x.roll(1, dims=d)
                return x
            return local_slice
        return patched(partition.NamedSharding, "local_slice", wrap)

    def wrap(real):
        def pin(x, rule, **kw):
            if partition.is_placed(x) and hit(x.shape):
                from torch.distributed.tensor import DTensor, Replicate
                x = DTensor.from_local(
                    x.to_local(), x.device_mesh,
                    [Replicate() if p.is_partial() else p
                     for p in x.placements],
                    run_check=False, shape=x.shape, stride=x.stride())
            return real(x, rule, **kw)
        return pin
    return patched(steps, "with_sharding_constraint", wrap)


def lm_tp_rank(device, smoke, fsdp, ckdir, layers=None):
    """One rank of ``lm_tp`` (or, with ``fsdp``, ``lm_fsdp``): the clean
    run, each planted fault after one step, the single-process loops on
    rank 0, and with ``fsdp`` a save at step TP_CUT resumed on the spmd
    layout and (rank 0) by the single-process loop."""
    import shutil
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch import kernels, tree
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding import partition

    set_full_precision()
    dev = torch.device(device)
    mesh = tp_mesh(dev)
    name = "lm_fsdp" if fsdp else "lm_tp"
    cfg = without_remat((SMOKE_ARCHS if smoke else ARCHS)[LM_ARCH],
                        f"{name} {LM_ARCH}" if mesh.rank == 0 else None)
    if smoke:
        cfg = cfg.with_(vocab_size=49152)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    seq = 32 if smoke else LM_SEQ
    tcfg = TrainConfig(total_steps=TP_STEPS, warmup_steps=1,
                       checkpoint_every=0, keep_checkpoints=1, seed=0)

    def run(steps, mesh_=mesh, ckpt_dir=None, spmd=False, gather=True,
            cfg=cfg):
        stamps = [time.perf_counter()]
        res = train_loop(cfg, tcfg, batch_size=LM_BATCH, seq_len=seq,
                         steps=steps, ckpt_dir=ckpt_dir, log_every=0,
                         device=dev, mesh=mesh_, fsdp=fsdp and not spmd
                         and mesh_ is not None, spmd=spmd,
                         on_metrics=lambda i, m: stamps.append(
                             time.perf_counter()))
        sync(dev)
        leaves = [partition.full(x).cpu() for x in
                  tree.leaves(res["params"])] if gather else None
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return res, leaves, ms

    out = {}
    kernels.reset_launch_counts()
    res, leaves, ms = run(TP_STEPS)
    out["launches"] = kernels.launch_counts()
    state = {"params": res["params"], "opt": res["opt_state"]}
    specs = {"params": partition.params_pspecs(res["params"], mesh,
                                               fsdp=fsdp),
             "opt": partition.opt_state_pspecs(res["opt_state"],
                                               res["params"], mesh,
                                               fsdp=fsdp)}
    out.update(losses=res["losses"], step_ms=ms, peak_gb=peak_gb(dev),
               layers=cfg.n_layers, seq=seq,
               held_bytes=_local_bytes(state),
               spec_bytes=dryrun.spec_bytes(state, specs, mesh),
               full_bytes=sum(x.numel() * x.element_size()
                              for x in tree.leaves(state)),
               n_params=sum(x.numel() for x in leaves))
    shapes = [tuple(x.shape) for x in leaves]
    fault_shape = next(s for p, s in zip(
        [p for p, _ in tree.leaves_with_paths(res["params"])], shapes)
        if p.endswith("['ffn']['w_down']"))
    del res, state
    # the same steps at remat=True: DTensor params under the checkpoint,
    # its recomputation on autograd's device thread
    rres, rleaves, rms = run(TP_STEPS, cfg=cfg.with_(remat=True))
    out["remat"] = (rres["losses"], rms,
                    rleaves if mesh.rank == 0 else None)
    del rres, rleaves
    out["faults"] = {}
    for fault in TP_FAULTS:
        with _plant(fault, mesh, fault_shape):
            fres, fleaves, _ = run(1)
        out["faults"][fault] = (fres["losses"], fleaves
                                if mesh.rank == 0 else None)
        del fres
    if fsdp:
        run(TP_CUT, ckpt_dir=ckdir, gather=False)
        mesh.barrier()
        with patched(ckpt, "save", lambda real_save: (
                lambda path, step, tree_, **kw: None)):
            cres, _, _ = run(TP_STEPS, ckpt_dir=ckdir, spmd=True,
                             gather=False)
        out["resumed_spmd"] = (cres["losses"], cres["resumed_from"])
        del cres
        mesh.barrier()
    if mesh.rank == 0:
        out["leaves"] = leaves
        single = {}
        for steps in (1, TP_STEPS):
            sres, sleaves, _ = run(steps, mesh_=None)
            single[steps] = (sres["losses"], sleaves)
            del sres
        out["single"] = single
        if fsdp:
            sub = ckdir + "_single"
            shutil.copytree(ckdir, sub)
            with patched(ckpt, "save", lambda real_save: (
                    lambda path, step, tree_, **kw: None)):
                rres, _, _ = run(TP_STEPS, mesh_=None, ckpt_dir=sub,
                                 gather=False)
            out["resumed_single"] = (rres["losses"], rres["resumed_from"])
            shutil.rmtree(sub, ignore_errors=True)
    return out


def _leaf_rels(got, want):
    return [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


def lm_tp_path(pool, dev, fsdp, smoke=False, ckdir=None, layers=None):
    import shutil
    import tempfile
    name = "lm_fsdp" if fsdp else "lm_tp"
    ckdir = ckdir or tempfile.mkdtemp(prefix="smoke_lm_fsdp_")
    try:
        rows = pool.run(lm_tp_rank, str(dev), smoke, fsdp, ckdir, layers,
                        timeout=DP_CALL_S)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    r0 = rows[0]
    s1, s3 = r0["single"][1], r0["single"][TP_STEPS]

    def verdict(losses, leaves, single):
        first = abs(losses[0] - single[0][0]) / abs(single[0][0])
        worst = max(_leaf_rels(leaves, single[1]))
        return first, worst, first <= LM_LOSS_RTOL and worst <= LM_GRAD_RTOL

    first, worst, ok = verdict(r0["losses"], r0["leaves"], s3)
    for rank, r in enumerate(rows):
        steady = statistics.median(r["step_ms"][1:])
        print(f"phase 13 {name} {LM_ARCH} ({r['layers']} layers) on mesh "
              f"{TP_MESH} {TP_AXES}, rank {rank} of {TP_RANKS}, "
              f"{r['n_params'] / 1e6:.1f} M params, global batch "
              f"{LM_BATCH} x {r['seq']}: losses {r['losses']} "
              f"(single-process {s3[0]}); step ms "
              f"{[round(x, 1) for x in r['step_ms']]} (median of steps 2-"
              f"{TP_STEPS}: {steady:.1f}; gloo through host memory, four "
              f"ranks on one card); params + optimizer state held "
              f"{r['held_bytes']} B, spec_bytes {r['spec_bytes']} B, "
              f"replicated {r['full_bytes']} B; peak {r['peak_gb']:.2f} GiB",
              flush=True)
        check(r["held_bytes"] == r["spec_bytes"],
              f"{name} rank {rank}: the bytes it holds equal "
              f"dryrun.spec_bytes of the same tree and mesh")
        check(r["losses"] == r0["losses"],
              f"{name} rank {rank}: the same losses as rank 0")
        check(sum(r["launches"].values()) == 0,
              f"{name} rank {rank}: the dense decoder launches none of the "
              f"sparse kernels")
    print(f"phase 13 {name}: first-step loss rel {first:.2e}, worst leaf "
          f"after step {TP_STEPS} rel L2 {worst:.2e}", flush=True)
    r_losses, r_ms, r_leaves = r0["remat"]
    print(f"phase 13 {name} remat=True: losses {r_losses} (remat=False "
          f"{r0['losses']}); rank 0's step ms {[round(x, 1) for x in r_ms]}",
          flush=True)
    check(all(r["remat"][0] == r["losses"] for r in rows)
          and leaf_rule(name, f"params after {TP_STEPS} steps, remat=True "
                        f"vs remat=False", r_leaves, r0["leaves"]),
          f"{name}: {TP_STEPS} steps at remat=True on every rank give "
          f"remat=False's losses, and rank 0's params within "
          f"{REMAT_LEAF_RTOL} of them")
    check(ok, f"{name}: first-step loss within {LM_LOSS_RTOL} and every "
          f"leaf within {LM_GRAD_RTOL} (relative L2) of the single-process "
          f"loop's")
    for fault, (losses, leaves) in r0["faults"].items():
        f_first, f_worst, f_ok = verdict(losses, leaves, s1)
        print(f"phase 13 {name} planted {fault}: first-step loss rel "
              f"{f_first:.2e}, worst leaf after step 1 rel L2 "
              f"{f_worst:.2e}", flush=True)
        check(not f_ok, f"{name}: the rule rejects the planted {fault}")
    if fsdp:
        tail = r0["losses"][TP_CUT:]
        for how in ("resumed_spmd", "resumed_single"):
            losses, frm = r0[how]
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses, tail))
            print(f"phase 13 {name} saved at step {TP_CUT}, {how}: losses "
                  f"{losses} vs {tail} uninterrupted (rel {rel:.2e})",
                  flush=True)
            check(frm == TP_CUT and rel <= DP_LM_LOSS_RTOL,
                  f"{name}: {how} from step {TP_CUT}, within "
                  f"{DP_LM_LOSS_RTOL} of the uninterrupted run")
    return r0["launches"]


# One attention layer of SmolLM-360M's width under the TP rules: its own
# 15/5 heads of 64, which the 2-way model axis does not divide (the heads
# run replicated over ``model``), and 16/4 heads of 60, which it divides
# (each model rank keeps its own heads).  Small: SMOKE-like widths.
ATTN_HEADS = ((15, 5), (16, 4))
ATTN_SMALL = (48, ((3, 1), (4, 2)))


def attn_heads_rank(device, small):
    """attn_apply forward and backward on the TP mesh for each head count
    of ATTN_HEADS: the collectives this rank issued in them (calls and
    bytes by kind, through ``torch.distributed``; the pending reductions
    of the output and the weights' gradients, alike for both, are left
    out), the output's and gradients' largest max|Δ|/max|single| against
    the single-process call, and the median ms of the two."""
    import torch
    import torch.distributed as dist
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.configs import ARCHS
    from repro_torch.models.attention import AttnConfig, attn_apply, \
        attn_init
    from repro_torch.sharding import context, partition

    set_full_precision()
    dev = torch.device(device)
    mesh = tp_mesh(dev)
    d, heads = ATTN_SMALL if small else (ARCHS[LM_ARCH].d_model,
                                         ATTN_HEADS)
    batch, seq = (4, 16) if small else (LM_BATCH, LM_SEQ)
    rules = {**partition.activation_rules(mesh), "__mesh__": mesh}
    out = {}
    for hq, hk in heads:
        cfg = AttnConfig(d, hq, hk, d // hq)
        g = torch.Generator(device=dev).manual_seed(0)
        full = dict(attn_init(g, cfg))
        full["x"] = torch.randn(batch, seq, d, generator=g, device=dev)
        full["dy"] = torch.randn(batch, seq, d, generator=g, device=dev)
        lay = {k: partition.NamedSharding(mesh, partition.param_spec(
            f"layers/attn/{k}", tuple(v.shape), mesh)) for k, v in
            full.items()}
        lay["x"] = lay["dy"] = partition.NamedSharding(
            mesh, partition.P("data", None, None))

        def call(placed):
            t = {k: (lay[k].shard(v) if placed else v.clone())
                 for k, v in full.items()}
            ins = [t[k].requires_grad_(True) for k in t if k != "dy"]
            with context.sharding_rules(rules if placed else None), \
                    partition.placed_scope(ins):
                y = attn_apply({k: t[k] for k in t if k[0] == "w"},
                               t["x"], cfg)
                return [v.detach() for v in (y, *torch.autograd.grad(
                    (y * t["dy"]).sum(), ins))]

        want = call(False)
        tally = {}

        def counted(kind):
            def wrap(real):
                def fn(*args, **kw):
                    x = args[1] if kind != "all_reduce" else args[0]
                    calls, nbytes = tally.get(kind, (0, 0))
                    tally[kind] = (calls + 1,
                                   nbytes + x.numel() * x.element_size())
                    return real(*args, **kw)
                return fn
            return wrap

        with patched(dist, "all_reduce", counted("all_reduce")), \
                patched(dist, "all_gather_into_tensor",
                        counted("all_gather")), \
                patched(dist, "reduce_scatter_tensor",
                        counted("reduce_scatter")):
            got = call(True)
        sync(dev)
        out[(hq, hk)] = (tally, max(rel_err(partition.full(a), b)[1]
                                    for a, b in zip(got, want)),
                         timed_ms(lambda: call(True), dev, 3))
    return out


def attn_heads_path(pool, dev, small=False):
    """Which collectives the head split adds: one attention layer's
    forward and backward with heads the model axis does not divide
    against heads it divides, at the same width."""
    rows = pool.run(attn_heads_rank, str(dev), small, timeout=DP_CALL_S)
    odd, even = ATTN_SMALL[1] if small else ATTN_HEADS
    for rank, r in enumerate(rows):
        for (hq, hk), (tally, rel, ms) in r.items():
            print(f"phase 13 attn_heads rank {rank}: {hq}/{hk} heads, one "
                  f"attention layer forward + backward issued {tally} "
                  f"(calls, bytes), {ms:.3f} ms (four ranks on one card); "
                  f"max|Δ|/max|single| {rel:.2e}", flush=True)
            check(rel <= KERNEL_RTOL,
                  f"attn_heads rank {rank} {hq}/{hk} heads: output and "
                  f"gradients within {KERNEL_RTOL} of the single-process "
                  f"call")
        total = {h: sum(b for _, b in r[h][0].values()) for h in (odd, even)}
        check(total[even] == 0 < total[odd],
              f"attn_heads rank {rank}: heads the model axis divides stay "
              f"split and issue no collective ({total[even]} B), heads it "
              f"does not divide are gathered ({total[odd]} B)")
    return rows[0]


def ffn_tp_rank(device, cap, small):
    """seamless decoder layer 0's ReLU FFN under IN_OUT_WR with the kernels
    on the (2, 2) mesh against the single-process call: output and
    gradients, counts, and every kernel call held against its plain
    version at this rank's shard shapes."""
    import torch
    from repro_torch import kernels
    from repro_torch.cnn_training import set_full_precision
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.core.sparse_linear import matmul as sparse_matmul
    from repro_torch.kernels import stats
    from repro_torch.models.ffn import (FFNConfig, ffn_apply,
                                        set_relu_mask_hook)
    from repro_torch.sharding import partition

    set_full_precision()
    dev = torch.device(device)
    mesh = tp_mesh(dev)
    if cap:
        x, w_up, w_down, dy = (torch.as_tensor(cap[k]).to(dev) for k in
                               ("x", "w_up", "w_down", "dy"))
    else:
        rows, (d, f) = (64, (64, 128)) if small else (FFN_TP_ROWS,
                                                      FFN_TP_DIMS)
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(rows, d, generator=g, device=dev)
        w_up = torch.randn(d, f, generator=g, device=dev) * d ** -0.5
        w_down = torch.randn(f, d, generator=g, device=dev) * f ** -0.5
        dy = torch.randn(rows, d, generator=g, device=dev)
    d, f = w_up.shape
    kern = IN_OUT_WR.with_(kernel_impl="pallas")
    cfg = FFNConfig(d, f, "relu", kern)
    P, NS = partition.P, partition.NamedSharding
    lay = {"w_up": NS(mesh, P(None, "model")),
           "w_down": NS(mesh, P("model", None)),
           "x": NS(mesh, P("data", None)), "dy": NS(mesh, P("data", None))}
    full = {"w_up": w_up, "w_down": w_down, "x": x, "dy": dy}

    def call(placed, ffn_cfg=cfg):
        t = {k: (lay[k].shard(v) if placed else v.clone()) for k, v in
             full.items()}
        for k in ("w_up", "w_down", "x"):
            t[k].requires_grad_(True)
        with partition.placed_scope([t["w_up"]]):
            y = ffn_apply({"w_up": t["w_up"], "w_down": t["w_down"]},
                          t["x"], ffn_cfg)
            grads = torch.autograd.grad((y * t["dy"]).sum(),
                                        [t["w_up"], t["w_down"], t["x"]])
            return [partition.full(v).detach() for v in (y, *grads)]

    stats.reset()
    want = call(False)
    single_counts = stats.counts()
    stats.reset()
    got, launches = launches_of(call, True)
    counts = stats.counts()
    # Each rank's K3 sums its own block in its own split plan, so a hidden
    # unit within rounding of 0 may take the other side of the ReLU than
    # in the single-process call (a σ′ flip, phase 4's rule).  The σ′ of
    # every rank's forward is its block through the same kernel call; the
    # plain dense FFN under those masks is what the gradients are held to.
    x2 = x.reshape(-1, d)
    rb, cb = x2.shape[0] // TP_MESH[0], f // TP_MESH[1]
    with torch.no_grad():
        own = torch.cat([torch.cat([sparse_matmul(
            x2[i * rb:(i + 1) * rb],
            w_up[:, j * cb:(j + 1) * cb].contiguous(), kern)
            for j in range(TP_MESH[1])], dim=1)
            for i in range(TP_MESH[0])]) > 0
        flips = int(((sparse_matmul(x2, w_up, kern) > 0) != own).sum())
    with hooked(set_relu_mask_hook, lambda h: own):
        want_own = call(False, FFNConfig(d, f, "relu", None))
    errs = [rel_err(a, b) for a, b in zip(got, want_own)]
    single_rel = [rel_err(a, b)[1] for a, b in zip(got, want)]
    stats.reset()
    first = len(FAILURES)
    stats.reset()
    # each rank's GEMMs sum its blocks in their own split plans: a cell of
    # real data may cancel to exactly 0 on one side and not on the other
    # (one a block at most, counted in held["zeros_apart"])
    with held_against_plain(dev, f"ffn_tp rank {mesh.rank}") as (held, _,
                                                                 _):
        call(True)
    held_counts = ran_counts(stats.counts(), stats.elided())
    ms = timed_ms(lambda: call(True), dev, 3)
    single_ms = timed_ms(lambda: call(False), dev, 3) \
        if mesh.rank == 0 else None
    return {"errs": [(e, r, bool(ok)) for e, r, ok in errs],
            "single_rel": single_rel, "flips": (flips, own.numel()),
            "counts": counts, "single_counts": single_counts,
            "launches": launches, "held": (held, held_counts,
                                           FAILURES[first:]),
            "ms": ms, "single_ms": single_ms,
            "shape": (x.numel() // d, d, f)}


def ffn_tp_path(pool, dev, small=False):
    cap = {} if small else {k: v for k, v in FFN_CAPTURE.items()}
    rows = pool.run(ffn_tp_rank, str(dev), cap, small, timeout=DP_CALL_S)
    r0 = rows[0]
    m, d, f = r0["shape"]
    print(f"phase 13 ffn_tp: seamless decoder layer 0 FFN {m} x {d} -> {f} "
          f"-> {d} ({'captured in phase 8' if cap else 'seeded draws'}), "
          f"IN_OUT_WR with the kernels on mesh {TP_MESH}: each model rank "
          f"{f // TP_MESH[1]} ff columns, each data rank {m // TP_MESH[0]} "
          f"rows; single-process forward + backward {r0['single_ms']:.3f} "
          f"ms", flush=True)
    for rank, r in enumerate(rows):
        held, hc, fails = r["held"]
        print(f"phase 13 ffn_tp rank {rank}: forward + backward "
              f"{r['ms']:.3f} ms (four ranks on one card); counts "
              f"{r['counts']}; launches {r['launches']}; held {held}",
              flush=True)
        flips, n = r["flips"]
        print(f"phase 13 ffn_tp rank {rank}: ReLU sign flips against the "
              f"single-process forward {flips} of {n}; max|Δ|/max|single| "
              f"{[f'{x:.2e}' for x in r['single_rel']]} (output, dW_up, "
              f"dW_down, dX)", flush=True)
        check(flips <= FLIP_SHARE * n,
              f"ffn_tp rank {rank}: sign flips <= {FLIP_SHARE} x {n}")
        for name, (err, rel, ok) in zip(("output", "dW_up", "dW_down",
                                         "dX"), r["errs"]):
            check(ok, f"ffn_tp rank {rank}: {name} within {KERNEL_RTOL} of "
                  f"the plain dense FFN under the ranks' own ReLU masks "
                  f"({rel:.2e} of max|plain|)")
        check(r["counts"] == r["single_counts"],
              f"ffn_tp rank {rank}: its counts equal the single-process "
              f"call's ({r['single_counts']})")
        check(not fails and held["gemm"] == _sum(hc, "gemm:") > 0
              and held["queue"] == hc.get("queue:prefix_sum", 0)
              and held["encode"] == hc.get("encode:act") > 0,
              f"ffn_tp rank {rank}: every dispatch, queue and encode at "
              f"its shard's shapes held against its plain version ({held}; "
              f"{len(fails)} failed)")
    if dev.type == "cuda":
        check_path_kernels("ffn_tp", r0["launches"], FFN_KERNELS)
    return r0["launches"]


def tp_phase(dev, small=False, layers=TP_LAYERS):
    """Phase 13: the gloo probe, then ``lm_tp``, ``lm_fsdp`` and
    ``ffn_tp`` on four gloo ranks sharing the card, SmolLM-360M at full
    width and ``layers`` deep, and the collectives of one attention layer
    by head count (``attn_heads``).  ``small`` runs the SMOKE SmolLM (its
    vocabulary at 49,152, so that the embedding passes the FSDP rule) and
    a small FFN, as the CPU rehearsal does."""
    from repro_torch.launch.mesh import RankError, RankPool
    t0 = time.perf_counter()
    by_path = {}
    try:
        with RankPool(TP_RANKS, backend="gloo", device=str(dev),
                      timeout=DP_JOIN_S) as pool:
            print(f"phase 13: {TP_RANKS} gloo ranks on {dev} joined in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            probe = tp_probe(pool, dev)
            check(all(v == "ok" for v in probe.values()),
                  f"phase 13: gloo runs every collective DTensor issues on "
                  f"{dev.type} tensors ({probe})")
            depth = None if small else layers
            for name, fn in (("lm_tp", lambda: lm_tp_path(
                                 pool, dev, False, small, layers=depth)),
                             ("lm_fsdp", lambda: lm_tp_path(
                                 pool, dev, True, small, layers=depth)),
                             ("ffn_tp", lambda: ffn_tp_path(
                                 pool, dev, small))):
                t1 = time.perf_counter()
                by_path[name] = fn()
                print(f"phase 13 {name}: {time.perf_counter() - t1:.1f} s",
                      flush=True)
            t1 = time.perf_counter()
            attn_heads_path(pool, dev, small)
            print(f"phase 13 attn_heads: {time.perf_counter() - t1:.1f} s",
                  flush=True)
    except RankError as e:
        check(False, f"phase 13: {e}")
    print(f"phase 13 (tensor parallelism and FSDP over {TP_RANKS} ranks): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 14: per-period rematerialisation (cfg.remat)
# ---------------------------------------------------------------------------

# Each path runs REMAT_STEPS AdamW steps at remat=False and again at
# remat=True from the same params and batches (phase 8's and phase 7's);
# the two runs' first-step gradient leaves and final params and moments
# agree within REMAT_LEAF_RTOL relative L2 (bit-equal expected), and a
# fault planted in the recomputation only (REMAT_PLANT added to one
# element of the input of the first decoder period recomputed) breaks
# that rule.  seamless's ReLU FFN runs on the kernels (REMAT_KERNELS),
# whose launches at remat=True are remat=False's plus the recomputed
# forward's: those of one forward of the loss, a step.
REMAT_STEPS, REMAT_LEAF_RTOL, REMAT_PLANT = 3, 1e-6, 1.0
REMAT_KERNELS = ("relu_encode", "queue_builder", "compact_gemm",
                 "splitk_reduce", "emit_nan_fixup")
REMAT_SMALL = (2, 16)


@contextlib.contextmanager
def ffn_on_kernels():
    """The ``IN_OUT_WR`` scenario's policy on the kernels
    (``kernel_impl="pallas"``) inside the block: a config with
    ``sparse_ffn_scenario="IN_OUT_WR"`` then runs its ReLU FFNs through
    K1-K3 (outside it, the masked plain path, as in the reference)."""
    from repro_torch.core import policy
    prev = policy.SCENARIOS["IN_OUT_WR"]
    policy.SCENARIOS["IN_OUT_WR"] = prev.with_(kernel_impl="pallas")
    try:
        yield
    finally:
        policy.SCENARIOS["IN_OUT_WR"] = prev


def planted_in_recompute():
    """The recomputation hook of REMAT_PLANT: the first decoder period
    recomputed (the last one; a period's inputs are (x, layers, memory))
    gets REMAT_PLANT added to one element of its input."""
    import torch
    from repro_torch.kernels import stats
    done = []

    def hook(args):
        if done or not isinstance(args[0], torch.Tensor):
            return args
        done.append(True)
        d = torch.zeros_like(args[0])
        d.view(-1)[d.numel() // 3] = REMAT_PLANT
        return (args[0] + d,) + tuple(args[1:])
    return hooked(stats.set_recompute_hook, hook)


def remat_run(dev, cfg, params, batches, keep_on_host):
    """REMAT_STEPS steps of ``make_train_step`` from a copy of ``params``:
    (losses, step ms, peak GiB or None, launches, count dict, the leaves
    of the final params and optimizer state).  ``keep_on_host`` moves
    them to the host, so that the next run's peak holds none of them."""
    import torch
    from repro_torch import kernels, tree
    from repro_torch.kernels import stats
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import OptConfig, adamw_init

    p = tree.tree_map(lambda x: x.detach().clone(), params)
    o = adamw_init(p)
    step_fn = make_train_step(cfg, OptConfig())
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stats.reset()
    kernels.reset_launch_counts()
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, b)
        if cuda:
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = kernels.launch_counts()
    counts = stats.counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    state = [x.detach().cpu() if keep_on_host else x.detach()
             for x in tree.leaves({"params": p, "opt": o})]
    del p, o
    if cuda:
        torch.cuda.empty_cache()
    return losses, ms, peak, launches, counts, state


def leaf_rule(tag, what, got, want):
    """Does every floating-point leaf of ``got`` lie within
    REMAT_LEAF_RTOL relative L2 of ``want``'s, and every integer leaf (the
    optimizer's step) equal it?  Prints the worst leaf and max |delta|."""
    import torch
    from repro_torch.conditioning import leaf_rels
    ints = [(a, b) for a, b in zip(got, want) if not b.is_floating_point()]
    got, want = zip(*[(a, b) for a, b in zip(got, want)
                      if b.is_floating_point()])
    rels = leaf_rels(got, want)
    delta = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, want))
    worst = max(rels)
    passed = worst <= REMAT_LEAF_RTOL and all(torch.equal(a, b)
                                              for a, b in ints)
    print(f"{tag} {what}: {len(rels)} leaves, worst relative L2 "
          f"{worst:.3e}, max |delta| {delta:.3e}, "
          f"{sum(r == 0 for r in rels)} of {len(rels)} with rel 0; "
          f"{'passes' if passed else 'fails'} the rule "
          f"({REMAT_LEAF_RTOL:g})", flush=True)
    return passed


def plain_rule(tag, loss, grads, masks, cfg, params, batch):
    """The kernel path's first step (its ``loss``, ``grads`` and the ReLU
    ``masks`` its FFNs took) against the plain step of ``cfg``'s dense FFN
    (bit-equal to the IN_OUT_WR plain path's, phase 8; only the dense FFN
    takes a replaced mask) under those masks, as phase 8 holds the step
    against float64: the
    two forwards' GEMMs sum in different orders, so a few pre-activations
    within rounding of 0 take the other side of the ReLU, and each such
    flip moves the gradient leaves below it by up to ~1e-3 relative L2.
    Phase 7's rule: the loss within LM_LOSS_RTOL, each gradient leaf
    within LM_GRAD_RTOL relative L2; and phase 8's: one mask an FFN, the
    flips against the plain step's own masks within FLIP_SHARE.  Prints
    the flips and the worst leaf."""
    import torch
    from repro_torch.conditioning import leaf_rels
    from repro_torch.models import ffn

    dense = cfg.with_(sparse_ffn_scenario=None)
    own = []
    lm_grads(dense, params, batch, torch.float32, hooked(
        ffn.set_relu_mask_hook, lambda h: own.append(h > 0)))
    flips = sum(int((a != b).sum()) for a, b in zip(masks, own))
    total = sum(a.numel() for a in masks)
    same_masks = len(masks) == len(own) > 0
    del own
    replay = iter(masks)
    loss_p, grads_p = lm_grads(dense, params, batch, torch.float32, hooked(
        ffn.set_relu_mask_hook, lambda h: next(replay)))
    rels = leaf_rels(grads, grads_p)
    worst = max(range(len(rels)), key=rels.__getitem__)
    a, b = grads[worst], grads_p[worst]
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    print(f"{tag} first step at remat=True, kernels against the plain "
          f"step under their {len(masks)} ReLU masks ({flips} of {total} "
          f"sigma-prime flips against its own): loss rel "
          f"{loss_rel:.2e}; {len(rels)} "
          f"leaves, worst relative L2 {rels[worst]:.3e} (leaf {worst}, "
          f"max|delta| {float((a - b).abs().max() / b.abs().max()):.3e} "
          f"of max|plain|)", flush=True)
    return (same_masks and flips <= FLIP_SHARE * total
            and loss_rel <= LM_LOSS_RTOL and rels[worst] <= LM_GRAD_RTOL)


def remat_path(dev, tag, cfg, params, batches, kernel_names=(),
               lower_peak=False):
    """One path of phase 14, its ReLU FFNs on the kernels
    (``ffn_on_kernels``): the first step's gradients at remat=False and
    True (with ``kernel_names``, every kernel call of the remat=True step
    held against its plain version and the step against the plain path's)
    and with the planted fault, then REMAT_STEPS steps at each setting (on
    the card each of ``kernel_names`` launched, and with ``lower_peak``
    the peak lower at remat=True).  Returns the launches of the remat=True
    run."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import stats
    from repro_torch.models import ffn
    from repro_torch.models.transformer import lm_loss

    off, on = cfg.with_(remat=False), cfg.with_(remat=True)
    with ffn_on_kernels():
        with torch.no_grad():
            stats.reset()
            _, fwd = launches_of(lm_loss, params, batches[0], on)
            c_fwd = ran_counts(stats.counts(), stats.elided())
        _, g_off = lm_grads(off, params, batches[0], torch.float32)
        stats.reset()
        if not kernel_names:
            _, g_on = lm_grads(on, params, batches[0], torch.float32)
        else:
            # the first forward's dispatches, queues and encodes, and the
            # recomputation's (one forward's, uncounted in the count dict)
            masks = []
            with held_against_plain(dev, tag) as (
                    held, _, _):
                loss_on, g_on = lm_grads(on, params, batches[0],
                                         torch.float32, hooked(
                                             ffn.set_relu_mask_hook,
                                             lambda h: masks.append(h > 0)))
            c = ran_counts(stats.counts(), stats.elided())
            stats.reset()
            want = {"gemm": _sum(c, "gemm:") + _sum(c_fwd, "gemm:"),
                    "queue": c.get("queue:prefix_sum", 0)
                    + c_fwd.get("queue:prefix_sum", 0),
                    "encode": c.get("encode:act", 0)
                    + c_fwd.get("encode:act", 0)}
            check(all(held[k] == want[k] for k in want)
                  and want["gemm"] > 0 and want["encode"] > 0,
                  f"{tag}: the remat=True step held every dispatch, queue "
                  f"and encode of its forward, recomputation and backward "
                  f"against its plain version ({held}; the step's counts "
                  f"with one forward's {want})")
            check(plain_rule(tag, loss_on, g_on, masks, on, params,
                             batches[0]),
                  f"{tag}: the remat=True step on the kernels within "
                  f"{LM_LOSS_RTOL} (loss) and {LM_GRAD_RTOL} (each leaf, "
                  f"relative L2) of the plain step's under its ReLU masks, "
                  f"one mask an FFN, flips within {FLIP_SHARE}")
            del masks
        check(leaf_rule(tag, "first-step gradients, remat=True vs "
                        "remat=False", g_on, g_off),
              f"{tag}: remat=True's first-step gradients within "
              f"{REMAT_LEAF_RTOL} of remat=False's")
        del g_on
        _, g_bad = lm_grads(on, params, batches[0], torch.float32,
                            planted_in_recompute())
        check(not leaf_rule(tag, "first-step gradients with a fault "
                            "planted in the recomputation", g_bad, g_off),
              f"{tag}: the leaf rule rejects a period input perturbed in "
              f"the recomputation only")
        del g_bad, g_off
        stats.reset()
        runs = {}
        for remat, c in ((False, off), (True, on)):
            runs[remat] = remat_run(dev, c, params, batches,
                                    keep_on_host=not remat)
            losses, ms, peak, launches, counts, _ = runs[remat]
            print(f"{tag} remat={remat}: {REMAT_STEPS} steps, losses "
                  f"{losses}; step ms {[round(x, 2) for x in ms]}, median "
                  f"of steps 2-{REMAT_STEPS} "
                  f"{statistics.median(ms[1:]):.1f} ms; peak "
                  + ("not measured (CPU)" if peak is None
                     else f"{peak:.2f} GiB")
                  + f"; launches a step "
                  f"{ {k: launches[k] / REMAT_STEPS for k in REMAT_KERNELS} }"
                  f"; counts {counts}", flush=True)
    l_off, _, pk_off, la_off, c_off, s_off = runs[False]
    l_on, _, pk_on, la_on, c_on, s_on = runs[True]
    rels = [abs(a - b) / abs(b) for a, b in zip(l_on, l_off)]
    check(max(rels) <= REMAT_LEAF_RTOL,
          f"{tag}: every step's loss at remat=True within "
          f"{REMAT_LEAF_RTOL} of remat=False's ({rels})")
    check(leaf_rule(tag, f"params and AdamW moments after {REMAT_STEPS} "
                    f"steps", s_on, [x.to(dev) for x in s_off]),
          f"{tag}: params and moments after {REMAT_STEPS} steps at "
          f"remat=True within {REMAT_LEAF_RTOL} of remat=False's")
    check(c_on == c_off,
          f"{tag}: the count dicts at remat=True and remat=False are equal "
          f"({c_on} vs {c_off})")
    extra = {k: la_on[k] - la_off[k] for k in la_on}
    print(f"{tag}: launches at remat=True less remat=False {extra}; one "
          f"forward of the loss launches {fwd} (x {REMAT_STEPS} steps)",
          flush=True)
    check(all(la_on[k] == la_off[k] + REMAT_STEPS * fwd[k] for k in la_on),
          f"{tag}: each kernel's launches at remat=True are remat=False's "
          f"plus the recomputed forward's")
    del s_on, s_off
    if dev.type == "cuda":
        check_path_kernels(f"{tag} remat=True", la_on, kernel_names)
    if dev.type == "cuda" and lower_peak:
        check(pk_on < pk_off,
              f"{tag}: the peak at remat=True below remat=False's "
              f"({pk_on:.2f} vs {pk_off:.2f} GiB)")
    kernels.reset_launch_counts()
    return la_on


REMAT_PATHS = ("lm_remat_seamless", "lm_remat_smollm360m")


def remat_phase(dev, small=False, paths=REMAT_PATHS):
    """Phase 14: ``cfg.remat``'s checkpointed encoder layers and decoder
    periods against ``remat=False``: seamless-m4t-medium at full width and
    depth (``IN_OUT_WR``, its ReLU FFN on the kernels) on phase 8's batch
    and SmolLM-360M on phase 7's (``small``: their SMOKE configs at
    REMAT_SMALL, the CPU rehearsal; ``paths`` a part of REMAT_PATHS).
    Returns its launches by path."""
    import torch
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    from repro_torch.data.pipeline import train_batch
    from repro_torch.models.transformer import lm_init

    t0 = time.perf_counter()
    archs = SMOKE_ARCHS if small else ARCHS
    by_path = {}
    # SmolLM's peak at 8 x 128 is AdamW's, not its activations': no
    # peak rule there
    for path, arch, (b, t), names, lower_peak in (
            ("lm_remat_seamless", SEAMLESS, (FAM_BATCH, FAM_SEQ),
             REMAT_KERNELS, True),
            ("lm_remat_smollm360m", LM_ARCH, (LM_BATCH, LM_SEQ), (),
             False)):
        if path not in paths:
            continue
        t1 = time.perf_counter()
        if small:
            b, t = REMAT_SMALL
        cfg = archs[arch]
        if arch == SEAMLESS:
            cfg = cfg.with_(sparse_ffn_scenario="IN_OUT_WR")
        params = lm_init(0, cfg, dtype=torch.float32, device=dev)
        batches = [train_batch(cfg, 0, i, batch=b, seq_len=t, device=dev)
                   for i in range(REMAT_STEPS)]
        by_path[path] = remat_path(dev, arch, cfg, params, batches, names,
                                   lower_peak)
        del params, batches
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"phase 14 {path}: {time.perf_counter() - t1:.1f} s",
              flush=True)
    print(f"phase 14 (per-period rematerialisation): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return by_path


# ---------------------------------------------------------------------------
# Phase 15: the wall-clock harness (benchmarks.wallclock)
# ---------------------------------------------------------------------------

# The kernels the harness's rows launch: K4 (the predicated rows), K2 -> K3
# (the compact rows) and K5 (the emit table's gemm_scan variant).
WALLCLOCK_KERNELS = ("queue_builder", "compact_gemm", "predicated_gemm",
                     "bitmap_scan")
WALLCLOCK_COUNTERS = {"hits": 21, "misses": 3, "retunes": 6}


@contextlib.contextmanager
def first_calls_held(dev, wc):
    """Inside the block the first call (a warm-up) of every ``wc.measure``
    runs with each GEMM dispatch, K2 queue and K1 encode held against its
    plain version (``held_against_plain``) and each K5 scan against
    ``bitmap_scan_plain``; the other calls run untouched."""
    import torch
    from repro_torch.kernels import bitmap_scan as k5

    def scan_held(real):
        def scan(x, gran):
            got = real(x, gran)
            check(torch.equal(got, k5.bitmap_scan_plain(x, gran)),
                  f"bitmap_scan wallclock {tuple(x.shape)} gran {gran} "
                  f"matches its plain version")
            return got
        return scan

    def held(real_measure):
        def measure(call, **kw):
            first = [True]

            def once():
                if not first:
                    return call()
                first.clear()
                with held_against_plain(dev, "wallclock"), \
                        patched(k5, "bitmap_scan", scan_held):
                    return call()
            return real_measure(once, **kw)
        return measure

    with patched(wc, "measure", held):
        yield


def wallclock_claims(docs, wc):
    """(statement, held) for each claim the checkers hold on full-geometry
    documents: fused < gemm_scan per emit cell; bitmap < dense at each
    mesh's lowest live fraction; bitmap <= COLLECTIVE_FALLBACK_SLACK x
    dense past the cutoff."""
    out = []
    for doc in docs:
        cells = {}
        for r in doc["rows"]:
            if r["table"] == "emit":
                cells.setdefault((r["workload"], r["schedule"]), {})[
                    r["variant"]] = r["us_median"]
            elif r["table"] == "collective":
                cells.setdefault((r["mesh"], r["live_frac"]), {})[
                    r["variant"]] = (r["us_median"], r["cutoff"])
        if doc["bench"] == "BENCH_8":
            for (w, s), v in sorted(cells.items()):
                out.append((f"fused {v['fused']} us < gemm_scan "
                            f"{v['gemm_scan']} us on {w}/{s}",
                            v["fused"] < v["gemm_scan"]))
        elif doc["bench"] == "BENCH_9":
            lowest = {}
            for mesh, live in cells:
                lowest[mesh] = min(live, lowest.get(mesh, live))
            for (mesh, live), v in sorted(cells.items()):
                (bm, cutoff), (dn, _) = v["bitmap"], v["dense_psum"]
                if live == lowest[mesh]:
                    out.append((f"bitmap {bm} us < dense_psum {dn} us on "
                                f"{mesh}@{live}", bm < dn))
                if live > cutoff:
                    slack = wc.COLLECTIVE_FALLBACK_SLACK
                    out.append((f"bitmap {bm} us <= {slack} x dense_psum "
                                f"{dn} us on {mesh}@{live} (past the "
                                f"cutoff {cutoff})", bm <= dn * slack))
    return out


def wallclock_cell(r):
    """A row's table and cell, as phase 15 prints it."""
    if r["table"] == "collective":
        return (f"collective mesh {r['mesh']} live {r['live_frac']} "
                f"{r['variant']} {r['m']}x{r['n']} block {r['block']}")
    if r["table"] == "train_step":
        return (f"train_step {r['workload']} {r['schedule']} batch "
                f"{r['batch']}")
    variant = f" {r['variant']}" if r["table"] == "emit" else ""
    return (f"{r['table']} {r['workload']} {r['schedule']}{variant} "
            f"{r['m']}x{r['k']}x{r['n']} block {r['block']}")


def wallclock_phase(dev):
    """Phase 15: ``benchmarks.wallclock``'s three documents at full geometry
    on the card (the GEMM schedules, two train steps and the autotune
    session; the fused emit against GEMM-then-scan; the compressed against
    the dense all-reduce on COLLECTIVE_RANKS gloo ranks sharing the card),
    the first call of each timed row held against the plain versions.
    Every schema or coverage error fails the run; each claim is printed
    held or missed.  Returns the path's launches."""
    from repro_torch.benchmarks import wallclock as wc

    t0 = time.perf_counter()

    def run():
        with first_calls_held(dev, wc):
            docs = [wc.run_bench(device=dev), wc.run_emit_bench(device=dev)]
        return docs + [wc.run_collective_bench(device=dev)]

    docs, launches = launches_of(run)
    claim_errors = 0
    for doc in docs:
        for r in doc["rows"]:
            print(f"wallclock {doc['bench']} {wallclock_cell(r)}: median "
                  f"{r['us_median']} us, IQR {r['us_iqr']} us ({r['reps']} "
                  f"fenced calls after {r['warmup']})", flush=True)
        errs = wc._checker_for(doc)(doc)
        schema = [e for e in errs if not e.startswith("claim:")]
        for e in schema:
            print(f"  SCHEMA: {e}", flush=True)
        check(not schema and doc["geometry"] == "full",
              f"wallclock {doc['bench']} (full geometry, "
              f"{len(doc['rows'])} rows): schema and coverage clean")
        claim_errors += len(errs) - len(schema)
    claims = wallclock_claims(docs, wc)
    for statement, held in claims:
        print(f"claim {'held' if held else 'missed'}: {statement}",
              flush=True)
    check(sum(not h for _, h in claims) == claim_errors,
          "wallclock: the claims missed are the checkers' claim: errors")

    at = docs[0]["autotune"]
    sel, log, counters = wc.autotune_session(device="cpu")
    print(f"wallclock autotune on {dev}: counters {at['counters']}, "
          f"{len(at['log'])} decisions, schedules by step "
          f"{[s['schedule'] for s in at['selections']]}", flush=True)
    check(at["counters"] == WALLCLOCK_COUNTERS and at["selections"] == sel
          and at["log"] == log,
          f"wallclock autotune session on {dev} equals the CPU's "
          f"(selections, {len(log)} log rows, counters {counters})")
    check_path_kernels("wallclock", launches, WALLCLOCK_KERNELS)
    print(f"phase 15 (wall-clock harness): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the dry run, the analytic cost model and the roofline
# ---------------------------------------------------------------------------

# The dry runs start after the last timed phase, so that no step or tick
# that phases 4-11 time shares the host with them (beside phases 4-5 they
# slowed VGG16's step from 59.0 to 65.4 ms), and take the host's 8 cores:
# every SMOKE cell of the registry on 6 workers; at full width the
# decode_32k and long_500k cells of every architecture on one, and on one
# more the train_4k cells of the four architectures whose steps phases 7-8
# time or that they cut (4.5-16.3 s a trace on one core of the chip's
# host).  The other full-width train cells (10-37 s each; xlstm-350m's
# 137 s) and the 32k prefills (35-241 s) are left to the full run by hand
# (PERF.md §6).  Outputs under build/dryrun/.  Each run: (name,
# arguments, workers, records, long_500k skips); a record is a cell on
# one of the two meshes, and the 7 archs outside LONG_CONTEXT_OK skip
# long_500k on each.
DRY_RUNS = (("smoke", ["--smoke"], 6, 80, 14),
            ("full_decode", ["--shape", "decode_32k,long_500k"], 1, 40, 14),
            ("full_train", ["--shape", "train_4k", "--arch",
                            "smollm-360m,internvl2-1b,seamless-m4t-medium,"
                            "deepseek-v2-lite-16b"], 1, 8, 0))
DRY_WAIT_S = 300
BOUND_PATHS = ("SmolLM-360M step", "internvl2-1b step", "gemma3-12b tick",
               "deepseek-v2-lite-16b tick", "xlstm-350m tick")


def path_shape(seq_len, batch, kind):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(f"{kind}_{batch}x{seq_len}", seq_len, batch, kind)


def start_dryruns():
    """Start the dry runs of DRY_RUNS; returns [(name, process, JSONL path,
    log path, start)]."""
    out = os.path.join(HERE, "build", "dryrun")
    os.makedirs(out, exist_ok=True)
    runs = []
    for name, extra, jobs, _, _ in DRY_RUNS:
        path = os.path.join(out, f"chip_smoke_{name}.jsonl")
        if os.path.exists(path):
            os.remove(path)
        log = os.path.join(out, f"chip_smoke_{name}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--out", path, "--jobs", str(jobs)] + extra,
                cwd=HERE, env=dict(os.environ, PYTHONPATH=SRC),
                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
        runs.append((name, proc, path, log, time.perf_counter()))
    return runs


def stop_dryruns(runs):
    """Kill what is left of the dry runs (each in its own session, pool
    workers included)."""
    import signal
    for _, proc, _, _, _ in runs:
        if proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def dryrun_results(name, proc, path, log, t0):
    """Wait for one dry run (DRY_WAIT_S from its start at most); returns
    its records."""
    try:
        rc = proc.wait(timeout=max(DRY_WAIT_S - (time.perf_counter() - t0),
                                   1))
    except subprocess.TimeoutExpired:
        rc = None
    lines = open(log).read().splitlines()
    done = next((l for l in reversed(lines) if l.startswith("done:")), "")
    recs = [json.loads(l) for l in open(path)] if os.path.exists(path) \
        else []
    fails = [l for l in lines if l.startswith("[FAIL]")]
    print(f"phase 12 dry run ({name}): rc {rc}; {done}", flush=True)
    # a crash (no exit code of the dry run's own) shows its last lines
    for line in fails[:10] + ([] if rc in (0, 1) else lines[-3:]):
        print("  " + line, flush=True)
    check(rc == 0, f"phase 12: the {name} dry run exits 0 ({rc})")
    return recs


def cost_phase(dev, runs):
    """Phase 12: the dry runs' results (every SMOKE cell on both meshes;
    full-width cells of every architecture), the measured paths of phases
    7-9 against their analytic bounds, and phase 10's profiled steps
    against their collective bytes.  Returns its launches (none)."""
    import torch
    from repro_torch import kernels
    from repro_torch.benchmarks.roofline import path_row, paths_table
    from repro_torch.launch import flops

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    full = []
    for run, (name, _, _, n_recs, n_skips) in zip(runs, DRY_RUNS):
        recs = dryrun_results(*run)
        ok = [r for r in recs if r.get("ok")]
        skips = [r for r in recs if r.get("skipped")]
        errors = [f"{r['arch']} x {r['shape']}" for r in ok
                  if "count_error" in r]
        print(f"phase 12 {name} cells: {len(ok)} ok ({len(errors)} with "
              f"count_error {errors}), {len(recs) - len(ok) - len(skips)} "
              f"failed, {len(skips)} skipped", flush=True)
        check(len(recs) == n_recs and len(skips) == n_skips
              and len(ok) == n_recs - n_skips,
              f"phase 12: every {name} cell sized on both meshes, 0 failed, "
              f"{n_skips} long_500k skips")
        check(all(r["memory_source"] == "specs"
                  and r["sources"]["counted_flops"] == "meta trace"
                  for r in ok),
              f"phase 12: every {name} record names its sources")
        if name != "smoke":
            full += ok
    for r in full:
        if r["mesh"] == "16x16":
            print(f"phase 12 full width {r['arch']} x {r['shape']}: "
                  f"{r['params_b']:.3f} B params, counted "
                  f"{r.get('counted_flops', float('nan')):.4e} FLOPs "
                  f"({r['count_s']} s) vs analytic "
                  f"{r['analytic']['flops_per_device'] * r['n_chips']:.4e}; "
                  f"arguments {r['memory']['argument_size_in_bytes'] / 2**30:.2f}"
                  f" GiB a device, fits_hbm {r['memory']['fits_hbm']}",
                  flush=True)
    counted = sorted({r["arch"] for r in full if "counted_flops" in r})
    check(len(counted) == 10,
          f"phase 12: every architecture traced on meta at full width "
          f"({len(counted)}: {counted})")

    # bounds of the measured paths (their times are phases 7-9's)
    rows = [path_row(name, *MEASURED[name][:2], MEASURED[name][3],
                     dtype=MEASURED[name][2])
            for name in BOUND_PATHS if name in MEASURED]
    print("phase 12 roofline of the measured paths (launch.flops at each "
          "path's own shape on one card, at the remat it ran: False in "
          "phases 7-9; measured: phases "
          f"7-9's median step or tick, host clock; float32 peak with "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          "):\n" + paths_table(rows), flush=True)
    check(len(rows) == len(BOUND_PATHS),
          f"phase 12: a measured time for every path ({sorted(MEASURED)})")
    for r in rows:
        check(r["bound_ms"] <= r["measured_ms"],
              f"phase 12: {r['path']} bound {r['bound_ms']:.3f} ms "
              f"({r['dominant']}) <= measured {r['measured_ms']:.2f} ms")

    # collective bytes: phase 10's profiled step against wire_bytes()
    cfg, shape = MEASURED["SmolLM-360M step"][:2] \
        if "SmolLM-360M step" in MEASURED else (None, None)
    ar = flops.analytic_cost(cfg, shape, dp_n=DP_RANKS,
                             model_n=1).detail["coll_dp_ar"] if cfg else None
    check(len(DP_TRACE) == DP_RANKS, "phase 12: phase 10's profiled step "
          "came back from every rank")
    for rank, (got, wire, names) in enumerate(DP_TRACE):
        print(f"phase 12 {LM_ARCH} data-parallel step, rank {rank}: trace "
              f"{got} from events {names}; wire_bytes() {wire}; analytic "
              f"coll_dp_ar at dp_n={DP_RANKS}: {ar} (a ring all-reduce "
              f"counted 2x the tensor; the trace counts it once)",
              flush=True)
        check(got["all-reduce"] == wire > 0,
              f"phase 12: rank {rank}'s traced all-reduce bytes equal "
              f"wire_bytes() ({got['all-reduce']} vs {wire})")
    print(f"phase 12 NCCL world of one, one dense_psum: events "
          f"{NCCL_TRACE.get('names')}; parsed {NCCL_TRACE.get('bytes')}; "
          f"wire_bytes() {NCCL_TRACE.get('wire')}", flush=True)
    nccl = NCCL_TRACE.get("bytes", {}).get("all-reduce")
    check(nccl == NCCL_TRACE.get("wire") and (nccl or 0) > 0,
          f"phase 12: NCCL's traced all-reduce bytes equal wire_bytes() "
          f"({nccl} vs {NCCL_TRACE.get('wire')})")
    launches = kernels.launch_counts()
    check(sum(launches.values()) == 0,
          f"phase 12: the dry run and the bounds launch no kernel "
          f"({launches})")
    print(f"phase 12 (dry run, cost model, roofline): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the four example scripts on the card
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(HERE, "examples")
# The quickstart's largest gap between the sparse and dense gradients.
EXAMPLE_GAP = 1e-5
# Train_lm's smoke run: its argv without --ckpt-dir, the steps of the run
# stopped as a killed run would be, then resumed to the end.
TRAIN_LM_ARGV = ["--steps", "6", "--batch", "2", "--seq", "64",
                 "--sparse-ffn"]
TRAIN_LM_CUT = 3
QUICKSTART_KERNELS = ("relu_encode", "queue_builder", "compact_gemm")
CNN_EXAMPLE_KERNELS = ("relu_encode", "queue_builder", "compact_gemm")


def load_example(name):
    """``examples/torch_<name>.py`` as a module (its ``main`` at hand)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev):
    """Phase 16: each example's ``main`` on the card at a small size, held
    against the same ``main`` on the CPU; returns each path's launches."""
    import shutil
    import torch
    from repro_torch import tree

    t0 = time.perf_counter()
    card = ["--device", str(dev)]
    cpu = ["--device", "cpu"]
    by_path = {}

    qs = load_example("quickstart")
    want = qs.main(cpu)
    got, by_path["example_quickstart"] = launches_of(qs.main, card)
    check(got["max_err"] <= EXAMPLE_GAP,
          f"example quickstart on the card: max|grad_sparse - grad_dense| "
          f"{got['max_err']:.2e} <= {EXAMPLE_GAP:g}")
    check((got["element"], got["block"]) == (want["element"], want["block"]),
          f"example quickstart: sparsity lines equal the CPU's "
          f"({got['element']}, {got['block']})")
    check_path_kernels("example_quickstart", by_path["example_quickstart"],
                       QUICKSTART_KERNELS)

    cnn = load_example("cnn_training")
    def cnn_argv(steps):
        return ["--net", "vgg16", "--steps", str(steps), "--kernel-impl",
                "pallas"]

    want = cnn.main(cnn_argv(1) + cpu)
    got, by_path["example_cnn_training"] = launches_of(cnn.main,
                                                       cnn_argv(2) + card)
    l0, w0 = got["losses"][0], want["losses"][0]
    check(abs(l0 - w0) <= 1e-5 * abs(w0),
          f"example cnn_training: step-0 loss {l0:.7f} within 1e-5 of the "
          f"CPU's {w0:.7f}")
    cyc = [got["totals"][sc]["total_cycles"] for sc in SCENARIO_ORDER]
    check(all(a >= b for a, b in zip(cyc, cyc[1:])),
          f"example cnn_training: modeled cycles DC >= IN >= IN_OUT >= "
          f"IN_OUT_WR ({cyc})")
    check_path_kernels("example_cnn_training",
                       by_path["example_cnn_training"], CNN_EXAMPLE_KERNELS)

    lm = load_example("train_lm")
    root = os.path.join(HERE, "build", "smoke_example_lm")
    shutil.rmtree(root, ignore_errors=True)

    def train():
        whole = lm.main(TRAIN_LM_ARGV + card + ["--ckpt-dir",
                                                os.path.join(root, "whole")])
        cut = os.path.join(root, "cut")
        first = lm.main(TRAIN_LM_ARGV + card + ["--ckpt-dir", cut],
                        stop_after=TRAIN_LM_CUT)
        resumed = lm.main(TRAIN_LM_ARGV + card + ["--ckpt-dir", cut])
        return whole, first, resumed

    try:
        (whole, first, resumed), by_path["example_train_lm"] = \
            launches_of(train)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(resumed["params"]), tree.leaves(whole["params"])))
    print(f"example train_lm: losses {whole['losses']}; stopped after "
          f"{TRAIN_LM_CUT} {first['losses']}, resumed from "
          f"{resumed['resumed_from']} {resumed['losses']}", flush=True)
    check(resumed["resumed_from"] == TRAIN_LM_CUT
          and first["losses"] + resumed["losses"] == whole["losses"]
          and same,
          f"example train_lm: stopped at step {TRAIN_LM_CUT} and resumed, "
          f"losses and params bit-equal to the uninterrupted run")

    serve = load_example("serve_lm")
    want = serve.main(cpu)
    got, by_path["example_serve_lm"] = launches_of(serve.main, card)
    check(got["done"] == want["done"],
          "example serve_lm: greedy tokens on the card equal the CPU's")
    print(f"phase 16 (the four examples): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return by_path


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
    from repro_torch.cnn_training import set_full_precision

    dev = torch.device("cuda", 0)
    set_full_precision()
    runs = []
    try:
        return run_phases(torch, dev, runs)
    finally:
        stop_dryruns(runs)


def run_phases(torch, dev, runs):
    """Phases 1-16 on ``dev``; the dry runs it starts go into ``runs``.
    Returns the exit code."""
    from repro_torch.kernels import _build
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
    tile_build_check()

    rows = kernel_phase(dev)
    by_path = {net: end_to_end(dev, net) for net in PATHS}
    by_path.update(experiment_phase(dev))
    by_path.update(guarded_lm_phase(dev))
    by_path.update(lm_families_phase(dev))
    by_path.update(slice9_phase(dev))
    by_path.update(dp_phase(dev))
    by_path.update(analysis_phase(dev))
    by_path.update(tp_phase(dev))
    by_path.update(remat_phase(dev))
    by_path["wallclock"] = wallclock_phase(dev)
    runs += start_dryruns()
    # Phase 16 runs beside the dry runs: it has no timed row.
    by_path.update(examples_phase(dev))
    by_path["dryrun"] = cost_phase(dev, runs)

    mm_cu = "src/repro_torch/csrc/masked_matmul.cu"
    mm_py = "src/repro/kernels/masked_matmul.py"
    encoder = "src/repro_torch/csrc/cell_encode.cuh"
    sources = {"relu_encode": (encoder,
                               "src/repro/kernels/relu_encode.py:63"),
               "queue_builder": ("src/repro_torch/csrc/queue_builder.cu",
                                 "src/repro/kernels/queue_builder.py:122"),
               "compact_gemm": (mm_cu, f"{mm_py}:492"),
               "predicated_gemm": (mm_cu, f"{mm_py}:347"),
               "splitk_reduce": (mm_cu, f"{mm_py}:492"),
               "queue_member": (mm_cu, f"{mm_py}:492"),
               "emit_nan_fixup": (mm_cu, f"{mm_py}:492"),
               "bitmap_scan": (encoder,
                               "src/repro/kernels/bitmap_scan.py:61"),
               "masked_matmul_2d": (mm_cu, f"{mm_py}:172"),
               "compact_masked_matmul_2d": (mm_cu, f"{mm_py}:626")}
    out = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        per_path = {net: launches[name] for net, launches in by_path.items()}
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": sum(per_path.values()),
                    "launches_by_path": per_path,
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
