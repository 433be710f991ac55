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
     launch counters before and reads them after.
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
               rel=None, plan=None):
        bound_b = bytes_ / HBM_BYTES_PER_S * 1e3
        bound_o = ops / F32_FLOP_PER_S * 1e3
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
    return rows


def audit_step(dev, net, report, detail, **geom):
    """One IN_OUT_WR step of ``net`` (phase 6's weights and batch) with
    every K1 encode, K2 queue and GEMM dispatch in it held against its
    plain version on the same inputs as it returns (see kernel_phase);
    ``report`` prints a kernel line, ``detail`` an encoder's plan."""
    import torch
    from repro_torch.core.policy import IN_OUT_WR
    from repro_torch.kernel_times import event_ms as time_ms
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops, shapes, stats
    from repro_torch.kernels import queue_builder as qb
    from repro_torch.kernels import relu_encode as re_
    from repro_torch.models.cnn import param_leaves

    model, params, img, labels = new_net(dev, net, **geom)
    params = clone_params(params)
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
        emit = spec.emit_gran if spec.emits_bitmap else None
        plan = {"path": mm.gemm_path(g, m, k, n, spec.block),
                "splits": mm.split_plan(g, m, k, n, spec.block),
                "block": spec.block, "emit_gran": emit}
        case = (f"{net} {layer} {role} {g}x{m}x{k}x{n}"
                + (" sigma-prime" if mult is not None else "")
                + ("" if emit is None else f" emit {emit}"))
        if not once(("gemm", g, m, k, n, spec.block, emit,
                     mult is None, tuple(x is None for x in masks))):
            check(ok, f"compact_gemm {case} matches its plain version "
                  f"({rel:.2e} of max|plain|)")
            return out, bits
        ni, nk, nj = shapes.grid_shape((m, k, n), spec.block)
        om = shapes.pad_mask3(masks.out, g, ni, nj, device=dev)
        am, bmk = (None if x is None else shapes.pad_mask3(x, g, *s)
                   for x, s in ((masks.a, (ni, nk)), (masks.b, (nk, nj))))
        flops, bytes_ = gemm_traffic((g, m, k, n), spec.block, om, am,
                                     bmk, mult, bits)
        timing.append(True)
        try:
            report("compact_gemm", case + " (K2 -> K3 dispatch)", err,
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
        case = f"{net} {stats.current_layer()} {bitmap.shape[0]}x" \
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
        report("relu_encode", f"{net} {stats.current_layer()} input "
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

    leaves = param_leaves(params)
    stats.reset()
    ops._dispatch, ops.build_queue, re_.relu_encode = \
        dispatch, queue, encode
    try:
        loss = model.loss(params, img, labels,
                          IN_OUT_WR.with_(kernel_impl="pallas"))
        torch.autograd.grad(loss, list(leaves.values()))
    finally:
        ops._dispatch, ops.build_queue, re_.relu_encode = \
            real_dispatch, real_queue, real_encode
    c = stats.counts()
    stats.reset()
    print(f"{net} step audit: {held}; the step's counts {c}", flush=True)
    check(held["gemm"] == _sum(c, "gemm:") > 0
          and held["queue"] == c.get("queue:prefix_sum")
          and held["encode"] == c.get("encode:act"),
          f"{net} step audit held every dispatch, queue and encode "
          f"against its plain version")


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
