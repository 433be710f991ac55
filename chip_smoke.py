#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure makes the exit code nonzero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels under src/repro_torch/csrc, built with nvcc;
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
     emit cell must be 0 on every schedule.  A capacity-
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
     its BN gradients against a float64 step, and that rule itself against
     faults planted in a retaken first step (CONTROLS);
  6. the paper's experiment: one full-width IN_OUT_WR step each of
     GoogLeNet, ResNet-18 and DenseNet-121 through the kernels, held by the
     rules of phases 4-5 (the BN nets against float64 steps under each
     f32 step's own ReLU masks, and that rule against the CONTROLS faults
     planted again), with no dense-conv fallback and every GEMM compact; all five networks captured
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
     planted fault.
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
# off the float64 step at full width.  So in a BN net the leaves at or
# below the highest flip are held, in relative L2 norm, to the float64 step
# (plain PyTorch, cuDNN in f64): no farther than F64_RATIO times the dense
# f32 step is, or KERNEL_RTOL.  The largest clean reading is 1.95; the
# smallest reading with a planted fault (one live tile of dw7's dX zeroed,
# below) is 3.34 at pw6/bn_bias: 2.5 sits between them.
F64_RATIO = 2.5
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
                   bytes_, flops, rel, plan)
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
           lib_ms, bytes_, flops, rel)
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
           lib_ms, bytes_, flops, rel)
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
           lib_ms, bytes_, flops, rel, {"splits": splits})
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
           lib_ms, bytes_, flops, rel, {"splits": splits})
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
        want = want32[0].to(bf).float()
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
def held_against_plain(dev, tag, report, detail):
    """Inside the block every GEMM dispatch, K2 queue and K1 encode is held
    against its plain version on the same inputs as it returns; the first
    call of each shape is timed and reported (``report`` prints a kernel
    line, ``detail`` an encoder's plan), labelled ``tag``.  Yields (held:
    the calls held per kind, schedules: dispatches per (schedule, block),
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
    seen, held, timing = set(), {"gemm": 0, "queue": 0, "encode": 0}, []

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
        role = "FP" if once(("layer", layer)) else \
            "WG" if a.stride(-1) != 1 else "dX"
        g, m, k = a.shape
        n = b.shape[2]
        want, want_bits = plain_dispatch(a, b, masks, spec, mult)
        err, rel, ok = rel_err(out, want)
        ok = ok and torch.equal(out == 0, want == 0) and (
            bits is None or torch.equal(bits, want_bits))
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
        case = (f"{tag} {layer} {role} {g}x{m}x{k}x{n}"
                + (" sigma-prime" if mult is not None else "")
                + ("" if emit is None else f" emit {emit}"))
        if not once(("gemm", g, m, k, n, spec.block, spec.schedule, emit,
                     mult is None, tuple(x is None for x in masks))):
            check(ok, f"{kname} {case} matches its plain version "
                  f"({rel:.2e} of max|plain|)")
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
                   rel, plan)
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
        if not once(("queue", tuple(bitmap.shape), capacity)):
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
        report("relu_encode", f"{tag} {stats.current_layer()} input "
               f"{z.shape[0]}x{z.shape[1]} gran {gran}",
               float((y - yp).abs().max()), ok,
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
    c = stats.counts()
    stats.reset()
    print(f"{net} step audit: {held}; the step's counts {c}", flush=True)
    check(held["gemm"] == _sum(c, "gemm:") > 0
          and held["queue"] == c.get("queue:prefix_sum", 0)
          and held["encode"] == c.get("encode:act"),
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


def grad_verdicts(net, grads, grads_x, g64, order, top, g64_x=None):
    """Each leaf of a step's gradients against the dense xla_ref step and,
    in a BN net (``g64`` given), the float64 step: ``(name, f64_rule, ok,
    message, reading)``, the reading being the leaf's distance in its
    rule's norm.  Leaves at or below the highest flipped layer (index
    ``top`` in ``order``) take the float64 rule in a BN net and
    STEP_RTOL_FLIPPED otherwise; those above take KERNEL_RTOL.  The
    xla_ref step is measured against ``g64_x`` where given (a float64 step
    under its own σ′), else against ``g64``."""
    g64_x = g64 if g64_x is None else g64_x
    out = []
    for name, gx in grads_x.items():
        gp = grads[name]
        err = float((gp - gx).abs().max()) / max(float(gx.abs().max()),
                                                 1e-30)
        layer = name.split("/")[0]
        below = layer in order and order.index(layer) <= top
        if below and g64 is not None:
            l2 = {k: rel_l2(g, gt) for k, g, gt in (("pallas", gp, g64[name]),
                                                   ("xla_ref", gx,
                                                    g64_x[name]))}
            rtol = max(KERNEL_RTOL, F64_RATIO * l2["xla_ref"])
            out.append((name, True, l2["pallas"] <= rtol,
                        f"{net} grad {name}: |g - g64|/|g64| = "
                        f"{l2['pallas']:.3e} <= max({KERNEL_RTOL:g}, "
                        f"{F64_RATIO:g} x xla_ref's {l2['xla_ref']:.3e}) "
                        f"(max|diff|/max|g| against xla_ref {err:.3e})",
                        l2["pallas"]))
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
    In a BN net the leaves at or below the highest flip are held to a
    float64 step: one for both f32 steps (``bn="f64"``, see F64_RATIO), or
    one under each step's own ReLU masks (``bn="own_masks"``, see
    BN_F64_UNDER_OWN_MASKS).  Returns ``(grads_x, g64, g64_x, order,
    top)`` for ``run_controls``."""
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
    g64 = g64_x = None
    if bn is not None:
        loss64, g64, caps64 = dense_f64_step(model, init, img, labels)
        f64 = {impl: sum(int(((v > 0) != (caps64[k] > 0)).sum())
                         for k, v in caps[impl].items()) for impl in caps}
        print(f"{net} float64 step loss {loss64:.9f}; sign flips against "
              f"float64 {f64}", flush=True)
        g64_x = g64
        if bn == "own_masks":
            g64_u = g64
            g64, g64_x = (dense_f64_step(model, init, img, labels,
                                         masks=caps[impl])[1]
                          for impl in ("pallas", "xla_ref"))
            # What the flips alone do: each f32 step against the float64
            # step under no masks (the F64_RATIO form), beside that float64
            # step against itself under each f32 step's masks.
            for name, gp in grads_p.items():
                if name.split("/")[0] in order[:top + 1]:
                    print(f"{net} flip witness {name}: against the unmasked "
                          f"float64 step pallas {rel_l2(gp, g64_u[name]):.3e}"
                          f" xla_ref {rel_l2(grads_x[name], g64_u[name]):.3e};"
                          f" the float64 step under pallas's masks "
                          f"{rel_l2(g64[name], g64_u[name]):.3e}, under "
                          f"xla_ref's {rel_l2(g64_x[name], g64_u[name]):.3e}",
                          flush=True)
    for _, _, ok, what, _ in grad_verdicts(net, grads_p, grads_x, g64, order,
                                        top, g64_x=g64_x):
        check(ok, what)
    return grads_x, g64, g64_x, order, top


def run_controls(net, model, init, img, labels, scan, held, layer):
    """The first step again with each CONTROLS fault planted in ``layer``:
    every fault must fail the float64 rule on some leaf, and nothing
    planted must fail it on none."""
    from repro_torch.core.policy import IN_OUT_WR

    grads_x, g64, g64_x, order, top = held
    rule = "float64 rule"
    pol = IN_OUT_WR.with_(kernel_impl="pallas", scan_signed_inputs=scan)
    for kind in CONTROLS:
        v = [(ok, what, x) for _, f64_rule, ok, what, x in grad_verdicts(
            net, control_grads(kind, model, init, img, labels, pol, layer),
            grads_x, g64, order, top, g64_x=g64_x)
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


def launch_contract(rec, scenario, tag):
    """Every launch counter equals its dispatches; the schedule ran."""
    c, launches = rec["counts"], rec["launches"]
    check(math.isfinite(rec["loss"]), f"{tag}: loss {rec['loss']} finite")
    check(c.get("emit:grad", 0) >= 1, f"{tag}: emit:grad >= 1")
    check(launches.get("relu_encode", 0) == c.get("encode:act", 0),
          f"{tag}: relu_encode launches == encode:act ({launches})")
    check(launches.get("bitmap_scan", 0) == _sum(c, "scan_pallas:"),
          f"{tag}: bitmap_scan launches == scan_pallas:*")
    check(launches.get("queue_builder", 0) == c.get("queue:prefix_sum", 0),
          f"{tag}: queue_builder launches == queue:prefix_sum")
    check(launches.get("compact_gemm", 0) == _sum(c, "gemm:compact:"),
          f"{tag}: compact_gemm launches == gemm:compact:*")
    check(launches.get("predicated_gemm", 0) == _sum(c, "gemm:predicated:"),
          f"{tag}: predicated_gemm launches == gemm:predicated:*")
    check(launches.get("splitk_reduce", 0) <= _sum(c, "gemm:compact:")
          + _sum(c, "gemm:predicated:"),
          f"{tag}: splitk_reduce launches <= K3/K4 dispatches")
    check(launches.get("emit_nan_fixup", 0) == c.get("emit:grad", 0),
          f"{tag}: emit_nan_fixup launches == emit:grad")
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
                           "f64" if bn_seed is not None else None)
    if bn_seed is not None:
        # The float64 rule must see a fault: each planted one is rejected
        # by it, and the same harness with nothing planted is not.
        run_controls(net, model, init, img, labels, scan, held,
                     CONTROL_LAYER)
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the three other networks, the captures, the ops, the tables
# ---------------------------------------------------------------------------

# Each new path's kernels: the path's run must launch every one of them.
NEW_NETS = ("googlenet", "resnet18", "densenet121")
BN_NETS = ("resnet18", "densenet121")
# BN_F64_UNDER_OWN_MASKS: in these two BN nets the float64 rule measures
# each f32 step against a float64 step under that step's own ReLU masks.
# Their flips are few (7 in ResNet-18's first step), so which elements flip
# decides the distance to an unmasked float64 step: one flip at b2conv1,
# where x̂ = -bias/scale is O(1), moved its BN scale gradient 2.8e-4 in
# relative L2 against the dense step's 4.5e-5.  Under the step's own masks
# only the arithmetic is compared; the flips are bounded by FLIP_SHARE.
# There xla_ref's own distance is ~1e-6, so F64_RATIO times it is below
# KERNEL_RTOL and the limit in force is KERNEL_RTOL in relative L2.  The
# float64 rule, on every conv layer's leaves, must reject the CONTROLS
# faults, planted in a dX GEMM that carries σ′ (b2conv2's: b2conv1's ReLU;
# b2conv1's own dX feeds a residual sum and carries none):
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
                           "own_masks" if bn else None)
    if bn:
        # Every conv layer's leaves under the float64 rule, wherever the
        # flips fell: each fault must fail that rule itself.
        grads_x, g64, g64_x, order, _ = held
        run_controls(net, model, init, img, labels, False,
                     (grads_x, g64, g64_x, order, len(order) - 1),
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

    cfg = ARCHS[LM_ARCH]
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
    for name, why in faults.NOT_PORTED.items():
        print(f"chaos NOT PORTED {name}: {why}", flush=True)
    check(len(rows) == 7, f"{len(rows)} of 7 ported chaos cases ran")
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
    cfg = ARCHS[SEAMLESS].with_(sparse_ffn_scenario="IN_OUT_WR")
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
    against the same config on the plain path; then every kernel call held
    against its plain version, with the live-tile shares of each GEMM and
    the kernels' times beside torch.matmul's.  Returns the launches."""
    import torch
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.kernel_times import event_ms
    from repro_torch.kernels import stats
    from repro_torch.models.ffn import FFNConfig, ffn_apply

    x, p, dy = cap["x"], cap["p"], cap["dy"]
    d, f = p["w_up"].shape

    def run(policy):
        w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        y = ffn_apply(w, xi, FFNConfig(d, f, "relu", policy))
        return (y.detach(),) + torch.autograd.grad(
            y, [w["w_up"], w["w_down"], xi], grad_outputs=dy)

    kern = IN_OUT_WR.with_(kernel_impl="pallas")
    plain = IN_OUT_WR.with_(kernel_impl="xla_ref")
    stats.reset()
    got, launches = launches_of(run, kern)
    counts = stats.counts()
    stats.reset()
    want = run(plain)
    for name, a, b in zip(("output", "dW_up", "dW_down", "dX"), got, want):
        err, rel, ok = rel_err(a, b)
        check(ok, f"seamless decoder layer 0 FFN {name} through the kernels "
              f"within {KERNEL_RTOL} of the plain path ({rel:.2e} of "
              f"max|plain|)")
    print(f"seamless decoder layer 0 FFN: {x.shape[0]} x {d} -> {f} -> {d}; "
          f"the kernel path's counts {counts}; launches {launches}",
          flush=True)
    check_path_kernels("lm_ffn_kernels", launches, FFN_KERNELS)
    report, detail = REPORTERS
    stats.reset()
    with held_against_plain(dev, "seamless dec0 ffn", report, detail) as (
            held, schedules, shares):
        run(kern)
    c = stats.counts()
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
    cfg = ARCHS[INTERNVL2]
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
    cfg = ARCHS[DEEPSEEK].with_(n_layers=DEEPSEEK_LAYERS)
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
    print(f"{tag} serving: {len(done)}/{SERVE['requests']} requests, "
          f"{len(ticks)} ticks, {n_tok} tokens; tick ms median {med:.2f} "
          f"(min {min(ticks):.2f}, first {ticks[0]:.1f}); {n_tok / run_s:.1f} "
          f"tokens/s; weights {gb:.2f} GB -> tick bound {gb / 3.35:.2f} ms "
          f"at 3.35 TB/s; peak memory "
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

    cfg = ARCHS[GEMMA3]
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
    """xlstm-350m at full width and depth, f32: five ``train_loop`` steps with a checkpoint after three and a resume; the
    first step against float64 with two planted faults; serving and decode
    against the parallel forward."""
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

    cfg = ARCHS[XLSTM]
    tag = XLSTM
    free(dev)
    tcfg = TrainConfig(total_steps=XLSTM_STEPS, checkpoint_every=XLSTM_CUT,
                       keep_checkpoints=2, seed=0)
    ckdir = os.path.join(HERE, "build", "smoke_xlstm_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    stamps = [t0]
    out = train_loop(cfg, tcfg, batch_size=XLSTM_BATCH, seq_len=XLSTM_SEQ,
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
    print(f"{tag}: {size / 1e6:.1f} M params, {cfg.n_layers} layers "
          f"{cfg.pattern}, f32; train_loop {XLSTM_STEPS} steps at "
          f"{XLSTM_BATCH} x {XLSTM_SEQ}: losses {losses_a}; step ms "
          f"{[round(x, 1) for x in ms]}, median of steps 2-{XLSTM_STEPS} "
          f"{statistics.median(ms[1:]):.1f}; peak memory {peak:.2f} GiB; "
          f"run with its saves {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(os.path.join(ckdir, f"step_{XLSTM_STEPS:08d}"))
    saves = []
    free(dev)
    with final_save_counted(saves):
        out = train_loop(cfg, tcfg, batch_size=XLSTM_BATCH,
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
    by_path = {net: end_to_end(dev, net) for net in PATHS}
    by_path.update(experiment_phase(dev))
    by_path.update(guarded_lm_phase(dev))
    by_path.update(lm_families_phase(dev))
    by_path.update(slice9_phase(dev))

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
