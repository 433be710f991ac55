"""Kernel audits — the port of the reference's
``benchmarks/kernel_audit.py``: block-skip capture rate on real traces,
queue-construction cost, the bitmap-op budget of a training step, the
launch-shape table, the depthwise gate, the contract audit (the rows of
``python -m repro_torch.analysis``) and the autotuner's decision log
(``benchmarks.wallclock``'s session).

Every table takes the ``Capture`` the run was given and computes on its
device: on a CUDA device the GEMMs, encoders and queue builders run
through the port's kernels.  The reference's asserts stay asserts: a
table whose contract breaks raises, and ``run.py`` fails named tables.
"""
from __future__ import annotations

import math
import os
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import (block_sparsity, capture_rate,
                                       element_sparsity)
from repro_torch.device import resolve_device
from repro_torch.kernels import masked_matmul, ops, ref, stats

from .common import Capture, capture_traces


def _audit_mask(x2: np.ndarray, block: int, rows: List[dict], dev,
                **meta) -> float:
    m, n = x2.shape
    bb = block
    xp = torch.as_tensor(np.pad(x2, ((0, -m % bb), (0, -n % bb))),
                         device=dev)
    rows.append({**meta, "block": bb,
                 "element_sparsity": round(float(element_sparsity(xp)), 4),
                 "block_sparsity": round(float(block_sparsity(xp, bb, bb)),
                                         4),
                 "capture_rate": round(float(capture_rate(xp, bb, bb)), 4)})
    return rows[-1]["capture_rate"]


def kernel_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """Element vs block sparsity and the capture rate of the first four
    captured activations of VGG16 and GoogLeNet in both GEMM layouts, a
    dead-channel structure sweep, and ``relu_bwd_masked`` on a real mask
    against its dense oracle."""
    dev = resolve_device(cap.device)
    rows: List[dict] = []
    unstructured = []
    for net in ("vgg16", "googlenet"):
        acts, _ = capture_traces(net, cap)
        for lname, a in list(acts.items())[:4]:
            px_c = a.reshape(-1, a.shape[-1]).astype(np.float32)
            c_px = px_c.T.copy()
            for b in (8, 16):
                unstructured.append(_audit_mask(
                    px_c, b, rows, dev, net=net, layer=lname,
                    layout="pix,chan"))
                _audit_mask(c_px, b, rows, dev, net=net, layer=lname,
                            layout="chan,pix")

    # --- structure sweep: fraction of dead CHANNELS (WC sparsity) ---
    rng = np.random.default_rng(0)
    base = rng.standard_normal((256, 256)).astype(np.float32)
    struct_caps = {}
    for dead_frac in (0.0, 0.25, 0.5, 0.75):
        x = base.copy()
        n_dead = int(256 * dead_frac)
        x[:, :n_dead] = 0.0                       # dead channels
        x *= rng.random((256, 256)) > 0.3          # plus unstructured 30%
        struct_caps[dead_frac] = _audit_mask(
            x, 128, rows, dev, net="synthetic", layer=f"dead{dead_frac:.2f}",
            layout="pix,chan")

    # --- exactness on a real mask ---
    a = torch.as_tensor(rng.standard_normal((64, 48)), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.standard_normal((48, 32)), dtype=torch.float32,
                        device=dev)
    acts, _ = capture_traces("vgg16", cap)
    first = next(iter(acts.values()))
    flat = (first.reshape(-1) != 0).astype(np.float32)
    relu_mask = torch.as_tensor(np.resize(flat, (64, 32)), device=dev)
    got = ops.relu_bwd_masked(a, w, relu_mask,
                              spec=ops.GemmSpec(block=(16, 16, 16)))
    want = ref.relu_bwd_masked(a, w, relu_mask, bm=16, bk=16, bn=16)
    exact = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))

    return rows, (
        f"unstructured_capture={np.mean(unstructured):.3f} "
        f"structured_capture(dead=0.5)={struct_caps[0.5]:.3f} "
        f"exact={exact}")


def queue_cost_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """Queue-construction cost: the argsort builder vs the prefix-sum one
    (kernel K2 on a CUDA device, its plain version on the CPU), per bitmap
    size — the modeled op counts, the time of one construction (CUDA
    events over three calls after a warm-up on the card; the host clock on
    the CPU), and bit-identity of the queues against
    ``core.workredist.static_queue_order``."""
    from repro_torch.core.workredist import static_queue_order

    dev = resolve_device(cap.device)
    rng = np.random.default_rng(0)
    rows: List[dict] = []
    all_match = True
    for mb, nb in ((8, 8), (16, 16), (32, 32), (64, 64), (128, 128)):
        t = mb * nb
        bm_np = (rng.random((mb, nb)) > 0.5).astype(np.int32)
        bm = torch.as_tensor(bm_np, device=dev)
        ri, rj, rn = static_queue_order(bm_np)

        def _timed(builder):
            stats.reset()
            out = ops.build_queue(bm, capacity=t, builder=builder)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                for _ in range(3):
                    out = ops.build_queue(bm, capacity=t, builder=builder)
                end.record()
                end.synchronize()
                us = start.elapsed_time(end) / 3 * 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(3):
                    out = ops.build_queue(bm, capacity=t, builder=builder)
                us = (time.perf_counter() - t0) / 3 * 1e6
            ii, jj, nl = (o.cpu().numpy() for o in out)
            match = bool(int(nl[0]) == rn and np.array_equal(ii, ri)
                         and np.array_equal(jj, rj))
            # every construction above is attributed to THIS builder's
            # queue:<builder> key, no other
            builds = stats.queue_builds(builder)
            assert builds == 4 and stats.queue_builds() == builds, \
                stats.counts()
            return us, match, builds

        us_sort, m_sort, n_sort = _timed("argsort")
        us_pfx, m_pfx, n_pfx = _timed("prefix_sum")
        all_match &= m_sort and m_pfx
        rows.append({
            "tiles": t, "shape": f"{mb}x{nb}",
            "argsort_ops": int(t * max(1, math.ceil(math.log2(t)))),
            "prefix_sum_ops": t,
            "op_ratio": round(max(1, math.ceil(math.log2(t))), 2),
            "us_argsort": round(us_sort, 1),
            "us_prefix_sum": round(us_pfx, 1),
            "counted_builds": n_sort + n_pfx,
            "match_reference": m_sort and m_pfx,
        })
    # A builder diverging from the reference order is a correctness bug,
    # not a data point — fail the audit.
    assert all_match, "queue builders diverged from static_queue_order"
    big = rows[-1]
    return rows, (
        f"op_ratio@{big['shape']}={big['op_ratio']}x "
        f"queues_match_reference={all_match}")


def _dense_conv(x, w, stride, padding, groups):
    """conv2d(relu(x), w) in plain PyTorch: NHWC x, HWIO w, JAX's SAME/VALID
    padding — the dense reference oracle of the audits."""
    from repro_torch.core.sparse_conv import _pad_amounts

    x = torch.relu(x)
    _, h, wd, _ = x.shape
    r, s = w.shape[0], w.shape[1]
    hlo, hhi = _pad_amounts(h, r, stride, padding)
    wlo, whi = _pad_amounts(wd, s, stride, padding)
    xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi)).permute(0, 3, 1, 2)
    # dense reference oracle  # repro-lint: allow(CONV_FALLBACK)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _grads(fn, args):
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*leaves), leaves)


def bitmap_op_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """Bitmap computations per activation and per gradient in one training
    step's forward + backward of each unit (the seed re-derived up to 3 per
    activation), every GEMM on the compact schedule, exactness against
    dense autodiff; then whole training steps (VGG16, MobileNet, the ReLU
    FFN) must run scan-free: every dy bitmap emitted by its GEMM."""
    from repro_torch.core import policy as pol
    from repro_torch.core.sparse_conv import depthwise_relu_conv, relu_conv
    from repro_torch.core.sparse_linear import act_matmul
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn, param_leaves
    from repro_torch.models.ffn import FFNConfig, ffn_apply, ffn_init

    dev = resolve_device(cap.device)
    policy = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    rng = np.random.default_rng(0)
    rows: List[dict] = []

    def tensor(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    def _count(label, sparse_fn, dense_fn, args):
        stats.reset()
        gs = _grads(sparse_fn, args)
        n_act = stats.total("act")
        n_grad = stats.total("grad")
        # on this policy every GEMM must dispatch compact, none dense
        n_gemm = stats.gemm_launches()
        n_compact = stats.gemm_launches(schedule="compact")
        assert n_gemm == n_compact and n_gemm > 0, stats.counts()
        gd = _grads(dense_fn, args)
        exact = all(torch.allclose(a, b, rtol=3e-4, atol=3e-4)
                    for a, b in zip(gs, gd))
        rows.append({"path": label, "bitmap_ops_act": n_act,
                     "bitmap_ops_grad": n_grad, "seed_ops_act": 3,
                     "gemm_launches": n_gemm, "exact_vs_dense": exact})
        return n_act, exact

    x = tensor((40, 24))
    w = tensor((24, 32))
    n_mm, e_mm = _count(
        "act_matmul",
        lambda x, w: (act_matmul(x, w, policy, "relu") ** 2).sum(),
        lambda x, w: ((torch.relu(x) @ w) ** 2).sum(),
        (x, w))

    xc = tensor((2, 9, 11, 8))
    wc = tensor((3, 3, 8, 8))
    n_cv, e_cv = _count(
        "relu_conv",
        lambda x, w: (relu_conv(x, w, 1, "SAME", policy) ** 2).sum(),
        lambda x, w: (_dense_conv(x, w, 1, "SAME", 1) ** 2).sum(),
        (xc, wc))

    # grouped: the engine's batched per-group GEMMs keep the same
    # once-per-tensor metadata budget (one bitmap serves ALL groups).
    wg2 = tensor((3, 3, 4, 8))
    n_g2, e_g2 = _count(
        "relu_conv_g2",
        lambda x, w: (relu_conv(x, w, 1, "SAME", policy,
                                groups=2) ** 2).sum(),
        lambda x, w: (_dense_conv(x, w, 1, "SAME", 2) ** 2).sum(),
        (xc, wg2))

    wdw = tensor((3, 3, 1, 8))
    n_dw, e_dw = _count(
        "depthwise_relu_conv",
        lambda x, w: (depthwise_relu_conv(x, w, 1, "SAME",
                                          policy) ** 2).sum(),
        lambda x, w: (_dense_conv(x, w, 1, "SAME", x.shape[-1]) ** 2).sum(),
        (xc, wdw))

    # --- training-workload gate: the hot path is scan-free -------------
    # Every dy bitmap is emitted by the producing GEMM's bitmap_emit
    # epilogue, so a FULL training step records ZERO standalone bitmap
    # scans; any nonzero scan count fails the audit.
    def _scan_free_step(label, loss_fn, params):
        leaves = list(params.values())
        stats.reset()
        grads = torch.autograd.grad(loss_fn(), leaves)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        c = stats.counts()
        n_scan = sum(v for k, v in c.items()
                     if k.startswith("scan_pallas:") or k.startswith("scan:"))
        n_emit = c.get("emit:grad", 0)
        rows.append({"path": label, "bitmap_ops_act": stats.total("act"),
                     "bitmap_ops_grad": stats.total("grad"),
                     "seed_ops_act": "-", "gemm_launches":
                         stats.gemm_launches(), "exact_vs_dense": "-",
                     "scan_ops": n_scan, "emit_ops": n_emit,
                     "finite": finite})
        assert n_scan == 0, (label, c)
        assert n_emit >= 1, (label, c)
        assert finite, label
        return n_scan

    img, labels = image_batch(0, 0, batch=1, image_size=8, num_classes=10,
                              device=dev)
    scans = 0
    for net, width in (("vgg16", 0.0625), ("mobilenet", 0.0625)):
        model = build_cnn(net, image_size=8, width=width, num_classes=10)
        p0 = model.init(0, device=dev)
        scans += _scan_free_step(
            f"train:{net}",
            lambda m=model, p=p0: m.loss(p, img, labels, policy),
            param_leaves(p0))

    cfg = FFNConfig(d_model=16, d_ff=32, activation="relu",
                    sparse_policy=policy)
    fp = ffn_init(1, cfg, device=dev)
    xin = tensor((32, 16))
    yt = tensor((32, 16))
    scans += _scan_free_step(
        "train:ffn_relu",
        lambda: ((ffn_apply(fp, xin, cfg) - yt) ** 2).mean(), fp)

    return rows, (
        f"act_matmul_bitmaps_per_act={n_mm} relu_conv_bitmaps_per_act={n_cv} "
        f"depthwise_bitmaps_per_act={n_dw} (seed>=3) "
        f"exact={e_mm and e_cv and e_g2 and e_dw} "
        f"train_step_scan_ops={scans}")


# ---------------------------------------------------------------------------
# Launch-shape audit — the GemmSpec regression table, plus the CUDA plan
# ---------------------------------------------------------------------------

def _legacy_geometry(block, g, m, k, n, schedule, cap=None):
    """Pre-redesign launch geometry: the 2-D grid (Mb, Nb, Kb) and the
    grouped (G, Mb, Nb, Kb); compact walked (cap, Kb) with cap defaulting to
    all tiles.  Kept as the frozen reference."""
    bm, bk, bn = block
    ni, nk, nj = -(-m // bm), -(-k // bk), -(-n // bn)
    if schedule == "compact":
        cap = g * ni * nj if cap is None else cap
        return (cap, nk), cap
    grid = (ni, nj, nk) if g == 1 else (g, ni, nj, nk)
    return grid, 0


def _engine_grans(stage: str, cin: int, cout: int, groups: int,
                  block) -> Tuple[int, int, int]:
    """The per-axis bitmap granularities the conv engine resolves grouped
    specs with, in its stage order (``conv_channel_granularity`` on the
    FULL channel counts)."""
    from repro_torch.core.sparse_tensor import conv_channel_granularity

    gc = conv_channel_granularity(cin, block, groups)
    gcg = conv_channel_granularity(cout, block, groups)
    return {"fp": (1, gc, 1),
            "bp_dx": (1, gcg, gc),
            "wg": (gc, 1, gcg)}[stage]


_PATH_NAMES = {masked_matmul.STANDARD: "standard",
               masked_matmul.GROUP_ROWS: "group_rows",
               masked_matmul.GROUP_K: "group_k"}


def launch_shape_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """Per GEMM of a small MobileNet's step (and its head), both schedules:
    ``GemmSpec.launch_geometry`` against the frozen legacy grid (the
    reference's check), and beside it the plan the CUDA kernels launch for
    the shape — ``masked_matmul.gemm_path``, ``split_plan`` (split-K
    slices) and ``grid_blocks`` (blocks before any split)."""
    from repro_torch.core import policy as pol
    from repro_torch.models.cnn import build_cnn

    policy = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    model = build_cnn("mobilenet", image_size=8, width=0.25, num_classes=10)
    workload = model.gemm_workload(batch=2)
    # plus the linear head GEMM (G=1, nominal tiles)
    workload.append({"layer": "head", "stage": "fp", "groups": 1,
                     "m": 2, "k": workload[-1]["n"], "n": 10})

    rows: List[dict] = []
    all_ok = True
    for w in workload:
        g, m, k, n = w["groups"], w["m"], w["k"], w["n"]
        base = policy.gemm_spec(groups=g) if g == 1 else \
            policy.gemm_spec(groups=g, dims=(m, k, n),
                             grans=_engine_grans(w["stage"], w["cin"],
                                                 w["cout"], g, policy.block))
        for schedule in ("predicated", "compact"):
            spec = base.with_(schedule=schedule)
            geom = spec.launch_geometry(m, k, n)
            legacy_grid, legacy_cap = _legacy_geometry(
                spec.block, g, m, k, n, schedule)
            if schedule == "compact":
                ok = geom["grid"] == legacy_grid \
                    and geom["queue_capacity"] == legacy_cap
            else:
                want = (1, *legacy_grid) if g == 1 else legacy_grid
                ok = geom["grid"] == want
            all_ok &= ok
            rows.append({
                "layer": w["layer"], "stage": w["stage"], "schedule": schedule,
                "groups": g, "m": m, "k": k, "n": n,
                "block": "x".join(map(str, spec.block)),
                "grid_before": "x".join(map(str, legacy_grid)),
                "grid_after": "x".join(map(str, geom["grid"])),
                "queue_cap_before": legacy_cap,
                "queue_cap_after": geom["queue_capacity"],
                "geometry_ok": ok,
                "cuda_path": _PATH_NAMES[masked_matmul.gemm_path(
                    g, m, k, n, spec.block)],
                "cuda_splits": masked_matmul.split_plan(g, m, k, n,
                                                        spec.block),
                "cuda_grid_blocks": masked_matmul.grid_blocks(g, m, k, n,
                                                              spec.block),
            })
    assert all_ok, "sparse_gemm launch geometry regressed vs the legacy contract"
    return rows, f"gemms={len(rows)} geometry_ok={all_ok}"


# ---------------------------------------------------------------------------
# Depthwise audit — every dw layer through the sparse engine, exact grads
# ---------------------------------------------------------------------------

def depthwise_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """Grouped convs across stride × padding × groups against dense
    autodiff, then one MobileNet step: zero dense-conv fallbacks, finite
    gradients."""
    from repro_torch.core import policy as pol
    from repro_torch.core.sparse_conv import relu_conv
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn, param_leaves

    dev = resolve_device(cap.device)
    policy = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    rng = np.random.default_rng(0)
    rows: List[dict] = []

    all_exact = True
    c, m = 8, 8
    for groups in (2, c):
        for stride in (1, 2):
            for padding in ("SAME", "VALID"):
                x = torch.as_tensor(rng.standard_normal((2, 9, 9, c)),
                                    dtype=torch.float32, device=dev)
                w = torch.as_tensor(
                    rng.standard_normal((3, 3, c // groups, m)),
                    dtype=torch.float32, device=dev)

                def f(x, w, stride=stride, padding=padding, groups=groups):
                    return (relu_conv(x, w, stride, padding, policy,
                                      groups=groups) ** 2).sum()

                def g(x, w, stride=stride, padding=padding, groups=groups):
                    return (_dense_conv(x, w, stride, padding,
                                        groups) ** 2).sum()

                gs = _grads(f, (x, w))
                gd = _grads(g, (x, w))
                exact = all(torch.allclose(a, b, rtol=3e-4, atol=3e-4)
                            for a, b in zip(gs, gd))
                all_exact &= exact
                rows.append({"case": "grad_exactness", "groups": groups,
                             "stride": stride, "padding": padding,
                             "exact_vs_dense": exact, "finite": "-",
                             "dw_layers": "-", "dense_fallbacks": "-",
                             "act_bitmap_ops": "-", "grad_bitmap_ops": "-"})

    # --- MobileNet smoke: one fwd+bwd step, all 13 dw layers sparse ---
    model = build_cnn("mobilenet", image_size=8, width=0.0625, num_classes=10)
    params = model.init(0, device=dev)
    img, labels = image_batch(0, 0, batch=1, image_size=8, num_classes=10,
                              device=dev)
    stats.reset()
    grads = torch.autograd.grad(model.loss(params, img, labels, policy),
                                list(param_leaves(params).values()))
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads)
    counts = stats.counts()
    fallbacks = counts.get("conv:dense_fallback", 0)
    n_dw = sum(1 for n in model.layers if getattr(n, "depthwise", False))
    rows.append({"case": "mobilenet_smoke", "groups": "per-layer C",
                 "stride": "-", "padding": "-", "exact_vs_dense": "-",
                 "finite": finite,
                 "dw_layers": n_dw, "dense_fallbacks": fallbacks,
                 "act_bitmap_ops": stats.total("act"),
                 "grad_bitmap_ops": stats.total("grad")})
    assert fallbacks == 0, counts
    assert finite, "MobileNet depthwise step produced non-finite gradients"
    assert all_exact, "grouped gradients diverged from dense autodiff"
    return rows, (
        f"dense_fallbacks={fallbacks} dw_layers={n_dw} "
        f"grouped_grads_exact={all_exact} finite={finite}")


def contract_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """The bitmap-contract verifier as a results table: one row per
    checker×workload with its violation count — the rows ``python -m
    repro_torch.analysis`` gates on, run on ``cap.device``.  All counts must
    be zero; any violation fails the table."""
    from repro_torch.analysis import kernel_sanitizer as ks
    from repro_torch.analysis import lint, trace_audit

    dev = resolve_device(cap.device)
    rows: List[dict] = []
    all_violations = []

    def row(checker, workload, vs):
        all_violations.extend(vs)
        rows.append({"checker": checker, "workload": workload,
                     "violations": len(vs),
                     "codes": ";".join(sorted({v.code for v in vs})) or "-"})

    for name in sorted(trace_audit.WORKLOADS):
        row("trace", name, trace_audit.audit_workloads([name], device=dev))
    row("kernel", "sweep", ks.sanitize_all(dev))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    row("lint", "src/repro_torch", lint.lint_paths([root]))

    assert not all_violations, \
        [f"{v.checker}:{v.code}@{v.where}" for v in all_violations]
    return rows, f"checkers=3 rows={len(rows)} violations=0"


def autotune_audit(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """The autotuner's decision log as a table: ``benchmarks.wallclock``'s
    scripted eager session on ``cap.device`` (the capture's geometry is
    not used) against a fresh cache, one row per resolve event (default /
    measured / retune / hit) with the live-tile fractions and sample
    count it was decided from.  Asserts the session's arc: compact under
    sparse output tiles, a drift retune chain ending dense under all-live
    tiles, and two dims-keyed workloads holding DIFFERENT schedules at
    once (the per-(spec, shape) selection)."""
    from .wallclock import autotune_session

    selections, log, counters = autotune_session(device=cap.device)
    by_phase = {}
    for s in selections:
        by_phase.setdefault(s["phase"], []).append(s["schedule"])

    assert by_phase["drift:sparse"][-1] == "compact", by_phase
    assert by_phase["drift:dense"][-1] == "dense", by_phase
    assert by_phase["shape:A"][-1] == "compact", by_phase
    assert by_phase["shape:B"][-1] == "dense", by_phase
    assert counters["retunes"] >= 1 and counters["hits"] >= 1, counters

    # traceability: every measured/retune decision cites >= min_samples
    # measured samples and a concrete live fraction ("default" rows are
    # the static fallback; "hit" rows replay a prior decision, its
    # fractions included); every log row carries the full field set.
    for r in log:
        assert set(r) == {"seq", "event", "key", "shape", "groups",
                          "schedule", "block", "live_frac", "operand_frac",
                          "samples"}, sorted(r)
        if r["event"] in ("measured", "retune"):
            assert r["live_frac"] is not None and r["samples"] >= 3, r

    schedules = sorted({r["schedule"] for r in log})
    return log, (
        f"events={len(log)} schedules={'/'.join(schedules)} "
        f"hits={counters['hits']} misses={counters['misses']} "
        f"retunes={counters['retunes']} traceable=True")
