"""The port's CUDA kernels on a GPU: each kernel against its plain version,
the composite ops relu_bwd_masked and weight_grad_masked, and small steps
of all five networks on the card against the same steps on the CPU.

Marked ``cuda``; every test skips without a CUDA device (decided inside the
fixture, never at import).  On a machine with a GPU and nvcc:
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.kernels import bitmap_scan as k5
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops, ref, shapes, stats
from repro_torch.kernels import queue_builder as qb
from repro_torch.kernels import relu_encode as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stats.reset()
    kernels.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.parametrize("shape,gran", [((37, 29), (8, 16)),
                                        ((333, 64), (1, 64)),
                                        ((33, 30), (1, 3))])
def test_relu_encode_kernel_matches_plain(dev, shape, gran):
    z = torch.randn(shape, device=dev)
    y, bits = k1.relu_encode(z, gran)
    yp, bp = k1.relu_encode_plain(z, gran)
    assert torch.equal(y, yp) and torch.equal(bits, bp)
    assert k1.launches == 1


# The encoder's paths (kernels/relu_encode.encode_plan): (shape, gran,
# storage offset in elements, path).  An offset of 1 leaves the pointer
# 4 bytes off 16-byte alignment.
ENCODER_CASES = {
    "(1, 1) aligned": ((1000, 64), (1, 1), 0, "quads"),
    "(1, 1) offset pointer": ((1000, 64), (1, 1), 1, "thread"),
    "(1, 1) N = 3, flat with a tail": ((1001, 3), (1, 1), 0, "quads"),
    "(1, 2) flat with a tail": ((999, 34), (1, 2), 0, "quads"),
    "(1, 4)": ((500, 36), (1, 4), 0, "quads"),
    "(1, 32)": ((1000, 32), (1, 32), 0, "segments"),
    "(1, 32) ragged": ((1000, 72), (1, 32), 0, "segments"),
    "(1, 64)": ((1000, 64), (1, 64), 0, "segments"),
    "(1, 128)": ((300, 128), (1, 128), 0, "segments"),
    "(1, 64) offset pointer": ((300, 64), (1, 64), 1, "warp"),
    "(8, 16) ragged": ((333, 29), (8, 16), 0, "warp"),
    "(8, 16) ragged, float4 rows": ((333, 36), (8, 16), 0, "warp"),
    "(4, 1)": ((333, 29), (4, 1), 0, "thread"),
    "(128, 128)": ((8, 1024), (128, 128), 0, "warp"),
}


def _planted(shape, offset, dev, seed):
    """A (M, N) operand at ``offset`` elements into its buffer, signed, with
    a NaN beside a positive value in a few cells."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m, n = shape
    buf = torch.randn(m * n + offset, device=dev, generator=gen)
    x = buf[offset:].view(m, n)
    for i in (0, m // 2, m - 1):
        j = (7 * i) % n
        x[i, j] = float("nan")
        x[i, (j + 1) % n] = 1.5
    return x


def _same(a, b):
    """Bit-equal, a NaN equal to a NaN."""
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_paths_match_plain(dev, case):
    shape, gran, offset, path = ENCODER_CASES[case]
    z = _planted(shape, offset, dev, 0)
    plan = k1.encode_plan(*shape, gran, z.data_ptr() % 16 == 0)
    assert plan.path == path
    y, bits = k1.relu_encode(z, gran)
    yp, bp = k1.relu_encode_plain(z, gran)
    assert _same(y, yp) and torch.equal(bits, bp)
    x = _planted(shape, offset, dev, 1)
    x *= torch.rand(shape, device=dev) > 0.5
    assert torch.equal(k5.bitmap_scan(x, gran), k5.bitmap_scan_plain(x, gran))
    # the planted NaN cells are 0 in both, as in the reference
    assert int(bits[0, 0]) == int(bp[0, 0])
    assert k1.launches == 1 and k5.launches == 1


@pytest.mark.parametrize("start,path", [(4, "quads"), (2, "thread")])
def test_bitmap_scan_strided_view_at_1x1(dev, start, path):
    """A column view of a wider tensor (row stride 72): 16-byte aligned rows
    take the quads path row by row, rows 8 bytes off take a thread per
    element."""
    wide = _planted((333, 72), 0, dev, 2)
    view = wide[:, start:start + 64]
    assert k1.encode_plan(333, 64, (1, 1), view.data_ptr() % 16 == 0,
                          ld=view.stride(0)).path == path
    assert torch.equal(k5.bitmap_scan(view, (1, 1)),
                       k5.bitmap_scan_plain(view, (1, 1)))


@pytest.mark.parametrize("shape", [(3136, 1), (5, 3000), (1, 1)])
def test_queue_kernel_matches_plain(dev, shape):
    bm = (torch.rand(shape, device=dev) < 0.4).to(torch.int32)
    for cap in (bm.numel(), int(bm.sum()) // 2):
        for a, b in zip(qb.build_queue_kernel(bm, capacity=cap),
                        qb.build_queue_plain(bm, cap)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["predicated", "compact"])
@pytest.mark.parametrize("cap", ["unbounded", "overflow"])
def test_sparse_gemm_on_card_matches_cpu(dev, schedule, cap):
    g, m, k, n, block, emit = 2, 333, 250, 77, (8, 16, 8), (2, 4)
    ni, nk, nj = shapes.grid_shape((m, k, n), block)
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((g, m, k)), rng.standard_normal((g, k, n)),
              rng.random((g, ni, nj)) < 0.5, rng.random((g, ni, nk)) < 0.7,
              rng.random((g, nk, nj)) < 0.7, rng.random((g, m, n)) < 0.5]
    a, b, om, am, bmk, mult = (torch.tensor(x).float() for x in arrays)
    om, am, bmk = (x.to(torch.int32) for x in (om, am, bmk))
    spec = ops.GemmSpec(
        block=block, groups=g, schedule=schedule,
        epilogue=("sigma_prime", "bitmap_emit"), emit_gran=emit,
        max_active_blocks=int(om.sum()) // 2 if cap == "overflow" else None)
    want, want_bits = ops.sparse_gemm(a, b, (om, am, bmk), spec,
                                      epilogue_mult=mult)
    got, got_bits = ops.sparse_gemm(
        a.to(dev), b.to(dev), tuple(x.to(dev) for x in (om, am, bmk)), spec,
        epilogue_mult=mult.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got_bits.cpu(), want_bits)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())
    # the CPU call ran the plain versions; the card call launched, and an
    # overflowing compact dispatch also launched its predicated fallback
    launches = kernels.launch_counts()
    compact = int(schedule == "compact")
    assert launches["compact_gemm"] == compact
    assert launches["queue_builder"] == compact
    assert launches["predicated_gemm"] == \
        int(schedule == "predicated" or cap == "overflow")


def test_strided_operands_need_no_copy(dev):
    p = torch.randn(700, 300, device=dev)
    d = torch.randn(700, 40, device=dev)
    out, _ = mm.grouped_masked_matmul_kernel(
        p.t()[None], d[None], None, None, None, block=(128, 128, 128))
    torch.cuda.synchronize()
    want = p.t() @ d
    assert float((out[0] - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_vgg16_step_on_card_matches_cpu(dev):
    from repro_torch.cnn_training import train_steps
    kw = dict(net="vgg16", steps=1, image_size=32, width=0.125,
              num_classes=10, batch=2)
    cpu = train_steps(device="cpu", **kw)["steps"][0]
    gpu = train_steps(device="cuda", **kw)["steps"][0]
    assert gpu["counts"] == cpu["counts"]
    assert abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    c, launches = gpu["counts"], gpu["launches"]
    assert launches["relu_encode"] == c["encode:act"]
    assert launches["queue_builder"] == c["queue:prefix_sum"]
    assert launches["compact_gemm"] == c["gemm:compact:1"]


@pytest.mark.parametrize("shape,gran", [((401, 3), (1, 1)),
                                        ((8, 1024), (128, 128)),
                                        ((333, 29), (8, 8)),
                                        ((37, 30), (1, 3))])
def test_bitmap_scan_kernel_matches_plain(dev, shape, gran):
    x = torch.randn(shape, device=dev)
    x *= torch.rand(shape, device=dev) > 0.9
    bits = k5.bitmap_scan(x, gran)
    assert torch.equal(bits, k5.bitmap_scan_plain(x, gran))
    # a column view: rows strided, columns contiguous, no copy made
    wide = torch.randn(shape[0], shape[1] + 5, device=dev)
    view = wide[:, 2:2 + shape[1]]
    assert torch.equal(k5.bitmap_scan(view, gran),
                       k5.bitmap_scan_plain(view, gran))
    assert k5.launches == 2


def _mm2d_operands(dev, m=96, k=160, n=64, block=(32, 32, 16)):
    bm, bk, bn = block
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(m, k, device=dev, generator=gen)
    b = torch.randn(k, n, device=dev, generator=gen)
    om, am, bmk = ((torch.rand(s, device=dev, generator=gen) < 0.6)
                   .to(torch.int32) for s in ((m // bm, n // bn),
                                              (m // bm, k // bk),
                                              (k // bk, n // bn)))
    mult = (torch.rand(m, n, device=dev, generator=gen) < 0.5).float()
    return a, b, om, am, bmk, mult


@pytest.mark.parametrize("sigma", [False, True])
def test_2d_kernels_match_plain_and_sparse_gemm(dev, sigma):
    block = (32, 32, 16)
    bm, bk, bn = block
    a, b, om, am, bmk, mult = _mm2d_operands(dev, block=block)
    mult = mult if sigma else None
    kw = dict(bm=bm, bk=bk, bn=bn, epilogue_mult=mult)
    k6 = mm.masked_matmul_kernel(a, b, om, am, bmk, **kw)
    want = mm.masked_matmul_plain(a, b, om, am, bmk, **kw)
    ii, jj, n_live = qb.build_queue_kernel(om, capacity=om.numel())
    k7 = mm.compact_masked_matmul_kernel(a, b, ii, jj, n_live, am, bmk, **kw)
    torch.cuda.synchronize()
    k7_want = mm.compact_masked_matmul_plain(a, b, ii, jj, n_live, am, bmk,
                                             **kw)
    scale = float(want.abs().max())
    assert float((k6 - want).abs().max()) <= 1e-5 * scale
    assert float((k7 - k7_want).abs().max()) <= 1e-5 * scale
    # scattered, K7 is bit-equal to K6 and to sparse_gemm(G=1)
    nl = int(n_live[0])
    scattered = torch.zeros_like(k6)
    tiles = scattered.view(a.shape[0] // bm, bm, b.shape[1] // bn, bn)
    tiles[ii[:nl].long(), :, jj[:nl].long(), :] = k7[:nl]
    assert torch.equal(scattered, k6)
    spec = ops.GemmSpec(block=block, schedule="compact",
                        epilogue=("sigma_prime",) if sigma else ())
    assert torch.equal(ops.sparse_gemm(a, b, (om, am, bmk), spec,
                                       epilogue_mult=mult), k6)
    assert kernels.launch_counts()["masked_matmul_2d"] == 1
    assert kernels.launch_counts()["compact_masked_matmul_2d"] == 1


@pytest.mark.parametrize("schedule", ["predicated", "compact"])
def test_depthwise_shaped_grouped_gemm_matches_cpu(dev, schedule):
    """dw1's dX GEMM, cut to 2 images: 32 groups of (T, 9) @ (9, 1) on
    degenerate (128, 9, 1) tiles, A a strided per-group view."""
    g, t = 32, 2 * 112 * 112
    rng = np.random.default_rng(1)
    pm = torch.tensor(rng.standard_normal((t, 9 * g)), dtype=torch.float32)
    a = pm.reshape(t, 9, g, 1).permute(2, 0, 1, 3).reshape(g, t, 9)
    b = torch.tensor(rng.standard_normal((g, 9, 1)), dtype=torch.float32)
    ni = -(-t // 128)
    om = torch.tensor(rng.random((g, ni, 1)) < 0.5).to(torch.int32)
    mult = torch.tensor(rng.random((g, t, 1)) < 0.5).float()
    spec = ops.GemmSpec(block=(128, 9, 1), groups=g, schedule=schedule,
                        epilogue=("sigma_prime", "bitmap_emit"),
                        emit_gran=(1, 1))
    want, want_bits = ops.sparse_gemm(a, b, (om, None, None), spec,
                                      epilogue_mult=mult)
    a_dev = pm.to(dev).reshape(t, 9, g, 1).permute(2, 0, 1, 3) \
        .reshape(g, t, 9)
    assert a_dev.stride() == (1, 9 * g, g)     # a view, no copy
    got, got_bits = ops.sparse_gemm(a_dev, b.to(dev), (om.to(dev), None,
                                                       None), spec,
                                    epilogue_mult=mult.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got_bits.cpu(), want_bits)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_mobilenet_step_on_card_matches_cpu(dev):
    """The whole MobileNet stack (image 32, width 0.25) gives equal count
    dicts and launches equal to dispatches on the card.  Its loss is held
    on the first nine layers (conv0 to pw4): deeper, BatchNorm normalizes
    over 2 images at 1×1 spatial, where the step is ill-conditioned (the
    dense ``xla_ref`` step on the card moves the logits by 0.46 against the
    CPU there too, so the number says nothing about the kernels).  The BN
    parameters are drawn off the init's scale 1, bias 0: there a BN scale
    feeding ReLU → depthwise conv → BN has an exactly zero gradient, whose
    f32 value is rounding noise."""
    from repro_torch.cnn_training import train_steps
    from repro_torch.core import policy as tpol
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import CNNModel, mobilenet_layers

    kw = dict(net="mobilenet", steps=1, image_size=32, width=0.25,
              num_classes=10, batch=2, scan_signed_inputs=True)
    cpu = train_steps(device="cpu", **kw)["steps"][0]
    gpu = train_steps(device="cuda", **kw)["steps"][0]
    assert gpu["counts"] == cpu["counts"]
    c, launches = gpu["counts"], gpu["launches"]
    assert c["encode:act"] == 26 and c["scan_pallas:act"] == 2
    assert launches["relu_encode"] == c["encode:act"]
    assert launches["bitmap_scan"] == c["scan_pallas:act"]
    assert launches["queue_builder"] == c["queue:prefix_sum"]
    assert launches["compact_gemm"] == sum(
        v for k_, v in c.items() if k_.startswith("gemm:compact:"))

    model = CNNModel("mobilenet", mobilenet_layers(0.25)[:9], 10, 32)
    pol = tpol.IN_OUT_WR.with_(kernel_impl="pallas", scan_signed_inputs=True)
    init = model.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for leaf in init.values():
            for name, sd in (("bn_scale", 0.2), ("bn_bias", 0.5)):
                if name in leaf:
                    leaf[name].add_(sd * torch.randn(leaf[name].shape,
                                                     generator=gen))
    losses, grads = [], []
    for d in ("cpu", "cuda"):
        params = {layer: {k: v.detach().to(d).requires_grad_(True)
                          for k, v in leaf.items()}
                  for layer, leaf in init.items()}
        img, lbl = image_batch(0, 0, batch=2, image_size=32, num_classes=10,
                               device=d)
        flat = [v for leaf in params.values() for v in leaf.values()]
        loss = model.loss(params, img, lbl, pol)
        losses.append(float(loss))
        grads.append([g.cpu() for g in torch.autograd.grad(loss, flat)])
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    for gg, gc in zip(grads[1], grads[0]):
        assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


def test_depthwise_node_with_channel_multiplier_stays_on_engine(dev):
    """On the card a depthwise node whose weights carry a channel
    multiplier runs through the engine's kernels, never the CPU's counted
    ``conv:dense_fallback`` escape, and equals that escape's plain conv;
    any other group structure raises."""
    from repro_torch.core import policy as tpol
    from repro_torch.models import cnn

    node = cnn.ConvNode("dw", 0, 3, stride=2, depthwise=True)
    pol = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 7, 7, 4), generator=gen)
    w = torch.randn((3, 3, 1, 8), generator=gen)
    for relu in (True, False):
        stats.reset()
        want = cnn.apply_conv({"w": w}, x, node, pol, relu)
        assert stats.counts() == {"conv:dense_fallback": 1}
        stats.reset()
        kernels.reset_launch_counts()
        got = cnn.apply_conv({"w": w.to(dev)}, x.to(dev), node, pol, relu)
        torch.cuda.synchronize()
        assert "conv:dense_fallback" not in stats.counts()
        assert kernels.launch_counts()["compact_gemm"] == 1
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    with pytest.raises(ValueError):
        cnn.apply_conv({"w": torch.randn((3, 3, 2, 4), device=dev)},
                       x.to(dev), node, pol, True)


# (G, M, K, N, block, emit, A layout): a split-K shape (A plain and A a
# transposed view, as in a WG GEMM), the group-major rows path (depthwise
# FP/dX tiles, A a per-group view of the patch matrix) and the group-major
# k path (depthwise WG tiles).
PLAN_CASES = {
    "split": (1, 40, 3000, 20, (16, 32, 8), (2, 4), "plain"),
    "split transposed": (2, 40, 3000, 20, (16, 32, 8), None, "t"),
    "rows": (40, 300, 9, 1, (128, 9, 1), (1, 1), "grouped"),
    "rows N2": (40, 300, 9, 2, (128, 9, 2), (1, 1), "grouped"),
    "k": (40, 9, 1000, 1, (9, 128, 1), None, "grouped_t"),
    "k N2": (40, 9, 1000, 2, (9, 128, 2), (3, 1), "grouped_t"),
}


def _plan_operands(dev, g, m, k, n, block, layout):
    rng = np.random.default_rng(3)
    ni, nk, nj = shapes.grid_shape((m, k, n), block)
    if layout == "grouped":       # group g's columns of (M, K·G) patches
        pm = torch.tensor(rng.standard_normal((m, k * g)),
                          dtype=torch.float32, device=dev)
        a = pm.reshape(m, k, g, 1).permute(2, 0, 1, 3).reshape(g, m, k)
    elif layout == "grouped_t":   # the same view of (K, M·G), transposed
        pm = torch.tensor(rng.standard_normal((k, m * g)),
                          dtype=torch.float32, device=dev)
        a = pm.reshape(k, m, g, 1).permute(2, 0, 1, 3).reshape(g, k, m) \
            .transpose(1, 2)
    elif layout == "t":
        a = torch.tensor(rng.standard_normal((g, k, m)), dtype=torch.float32,
                         device=dev).transpose(1, 2)
    else:
        a = torch.tensor(rng.standard_normal((g, m, k)), dtype=torch.float32,
                         device=dev)
    b = torch.tensor(rng.standard_normal((g, k, n)), dtype=torch.float32,
                     device=dev)
    om, am, bmk = (torch.tensor(rng.random(s) < 0.6, device=dev)
                   .to(torch.int32)
                   for s in ((g, ni, nj), (g, ni, nk), (g, nk, nj)))
    mult = torch.tensor(rng.random((g, m, n)) < 0.5, device=dev).float()
    return a, b, om, am, bmk, mult


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_split_and_group_major_kernels_match_plain(dev, case):
    g, m, k, n, block, emit, layout = PLAN_CASES[case]
    a, b, om, am, bmk, mult = _plan_operands(dev, g, m, k, n, block, layout)
    path = mm.gemm_path(g, m, k, n, block)
    splits = mm.split_plan(g, m, k, n, block)
    assert (path == mm.STANDARD) == case.startswith("split")
    assert path == mm.GROUP_ROWS or splits > 1
    kw = dict(block=block, epilogue_mult=mult, emit_gran=emit)
    want, want_bits = mm.grouped_masked_matmul_plain(
        a, b, om, am, bmk, out=torch.zeros(g, m, n, device=dev),
        bits=None if emit is None else torch.zeros(
            g, -(-m // emit[0]), -(-n // emit[1]), dtype=torch.int32,
            device=dev), **kw)
    flat = om.reshape(-1, om.shape[2]).contiguous()
    results = [mm.grouped_masked_matmul_kernel(a, b, om, am, bmk, **kw)]
    for cap in (flat.numel(), int(flat.sum()) // 2):
        fi, jj, nl = qb.build_queue_kernel(flat, capacity=cap)
        out, bits = mm.grouped_compact_masked_matmul_kernel(
            a, b, fi, jj, nl, am, bmk, **kw)
        if cap < flat.numel():
            out, bits = mm.grouped_masked_matmul_kernel(
                a, b, om, am, bmk, out=out, bits=bits, n_live=nl,
                capacity=cap, **kw)
        results.append((out, bits))
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    for got, got_bits in results:
        assert float((got - want).abs().max()) <= 1e-5 * scale
        assert torch.equal(got == 0, want == 0)
        if emit is not None:
            assert torch.equal(got_bits, want_bits)
        # one plan per shape: every schedule gives the same bits
        assert torch.equal(got, results[0][0])
    launches = kernels.launch_counts()
    assert launches["splitk_reduce"] == (4 if splits > 1 else 0)
    assert launches["compact_gemm"] == 2 and launches["predicated_gemm"] == 2


def test_queue_overflow_counted_on_card_without_a_sync(dev):
    g, m, k, n, block, emit = 2, 333, 250, 77, (8, 16, 8), (2, 4)
    ni, nk, nj = shapes.grid_shape((m, k, n), block)
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((g, m, k)), rng.standard_normal((g, k, n)),
              rng.random((g, ni, nj)) < 0.5, rng.random((g, ni, nk)) < 0.7,
              rng.random((g, nk, nj)) < 0.7, rng.random((g, m, n)) < 0.5]
    a, b, om, am, bmk, mult = (torch.tensor(x).float() for x in arrays)
    om, am, bmk = (x.to(torch.int32) for x in (om, am, bmk))
    spec = ops.GemmSpec(block=block, groups=g, schedule="compact",
                        epilogue=("sigma_prime", "bitmap_emit"),
                        emit_gran=emit, max_active_blocks=int(om.sum()) // 2)
    stats.reset()
    want, want_bits = ops.sparse_gemm(a, b, (om, am, bmk), spec,
                                      epilogue_mult=mult)
    cpu_counts = stats.counts()
    stats.reset()
    args = [x.to(dev) for x in (a, b, om, am, bmk, mult)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_bits = ops.sparse_gemm(*args[:2], tuple(args[2:5]), spec,
                                        epilogue_mult=args[5])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stats.counts() == cpu_counts
    assert cpu_counts["fallback:queue_overflow"] == 1
    assert torch.equal(got_bits.cpu(), want_bits)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("case", ["unsplit", "split", "rows", "rows N2",
                                  "k N2"])
def test_gemm_emit_gives_nan_cells_0(dev, case):
    """A NaN planted in sigma-prime's multiplier inside a live tile, beside
    live values of its emit cell: on every path and schedule the cell's bit
    is 0, as the reference's max over the cell gives it; the next launch,
    with no NaN, emits as before."""
    g, m, k, n, block, emit, layout = PLAN_CASES.get(
        case, (2, 333, 250, 77, (8, 16, 8), (2, 4), "plain"))
    a, b, om, am, bmk, mult = _plan_operands(dev, g, m, k, n, block, layout)
    assert (mm.split_plan(g, m, k, n, block) > 1) == (case in ("split",
                                                               "k N2"))
    live = om.nonzero()[0].tolist()
    gi, ti, tj = live
    bad = mult.clone()
    bad[gi, ti * block[0], tj * block[2]] = float("nan")
    for mult_ in (bad, mult):
        kw = dict(block=block, epilogue_mult=mult_, emit_gran=emit)
        want, want_bits = mm.grouped_masked_matmul_plain(
            a, b, om, am, bmk, out=torch.zeros(g, m, n, device=dev),
            bits=torch.zeros(g, -(-m // emit[0]), -(-n // emit[1]),
                             dtype=torch.int32, device=dev), **kw)
        flat = om.reshape(-1, om.shape[2]).contiguous()
        fi, jj, nl = qb.build_queue_kernel(flat, capacity=flat.numel())
        results = [mm.grouped_masked_matmul_kernel(a, b, om, am, bmk, **kw),
                   mm.grouped_compact_masked_matmul_kernel(
                       a, b, fi, jj, nl, am, bmk, **kw)]
        torch.cuda.synchronize()
        scale = float(want.nan_to_num(0.0).abs().max())
        cell = (gi, ti * block[0] // emit[0], tj * block[2] // emit[1])
        for got, got_bits in results:
            assert torch.equal(got.isnan(), want.isnan())
            assert float((got - want).nan_to_num(0.0).abs().max()) \
                <= 1e-5 * scale
            assert torch.equal(got_bits, want_bits)
            if mult_ is bad:
                assert int(got_bits[cell]) == 0
    assert int(want_bits.sum()) > 0


# ---------------------------------------------------------------------------
# K2 across blocks, the split-K reduce alone, the repaired plain GEMM
# ---------------------------------------------------------------------------

# One block (<= 4,096 tiles), its edges, MobileNet's dw1/dw2 dX bitmaps
# (25,088 and 50,176 x 1) and ~70,000 tiles (18 blocks of look-back).
@pytest.mark.parametrize("tiles", [1, 77, 4095, 4096, 4097, 12289, 25088,
                                   50176, 70001])
@pytest.mark.parametrize("density", [0.0, 0.4, 1.0])
def test_queue_kernel_across_blocks_matches_plain(dev, tiles, density):
    gen = torch.Generator(device=dev).manual_seed(tiles)
    bm = (torch.rand((tiles, 1), device=dev, generator=gen) < density) \
        .to(torch.int32)
    n_live = int(bm.sum())
    # an unaligned view of the same bits: the scalar path
    buf = torch.zeros(tiles + 1, dtype=torch.int32, device=dev)
    buf[1:] = bm[:, 0]
    views = [bm, buf[1:].view(tiles, 1)]
    if tiles % 7 == 0:
        views.append(bm.view(tiles // 7, 7))      # C > 1
    for view in views:
        assert (view.data_ptr() % 16 == 0) == (view is not views[1])
        for cap in sorted({tiles, max(n_live // 2, 1), tiles + 5}):
            for _ in range(3):         # stale status words would show here
                got = qb.build_queue_kernel(view, capacity=cap)
                want = qb.build_queue_plain(view, cap)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
    assert qb.launches == 3 * sum(len({tiles, max(n_live // 2, 1),
                                       tiles + 5}) for _ in views)


REDUCE_CASES = {
    # (G, M, K, N, block, emit, A layout, mode): the standard path
    # predicated and compact (capacity past n_live: dead queue slots), with
    # an emit and a NaN in sigma-prime's multiplier; group k compact
    # (membership) across groups, N = 1 and N = 2; group k at G = 3, whose
    # split slice G·M·N (27, 54) is not a whole number of float4s.
    "standard predicated": ((1, 40, 3000, 20, (16, 32, 8), (2, 4), "plain"),
                            "predicated", False),
    "standard compact, NaN": ((2, 40, 3000, 20, (16, 32, 8), (2, 4), "t"),
                              "compact", True),
    "standard N % 4 = 0": ((1, 96, 3000, 64, (32, 32, 32), (1, 32), "t"),
                           "compact", True),
    "group k compact": ((40, 9, 1000, 1, (9, 128, 1), (1, 1), "grouped_t"),
                        "compact", False),
    "group k N2, NaN": ((40, 9, 1000, 2, (9, 128, 2), (3, 1), "grouped_t"),
                        "predicated", True),
    "group k G3 N1": ((3, 9, 3000, 1, (9, 128, 1), (1, 1), "grouped_t"),
                      "compact", False),
    "group k G3 N2": ((3, 9, 3000, 2, (9, 128, 2), (3, 1), "grouped_t"),
                      "predicated", False),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_splitk_reduce_matches_plain_in_plan_order(dev, case):
    """The reduce alone, after one GEMM pass: torch.equal to its plain
    version (``splitk_reduce_plain`` in plan order, x sigma-prime, on the
    live tiles), bits equal after the NaN fix-up, and within 1e-5 of the
    sequential split-order sum."""
    from repro_torch.kernels import _build

    (g, m, k, n, block, emit, layout), mode, nan = REDUCE_CASES[case]
    a, b, om, am, bmk, mult = _plan_operands(dev, g, m, k, n, block, layout)
    path = mm.gemm_path(g, m, k, n, block)
    splits = mm.split_plan(g, m, k, n, block)
    plan = mm.reduce_plan(path, g, m, n, splits)
    assert splits > 1 and (path == mm.GROUP_K) == case.startswith("group")
    if nan:
        gi, ti, tj = om.nonzero()[0].tolist()
        mult[gi, ti * block[0], tj * block[2]] = float("nan")
    ni, _, nj = shapes.grid_shape((m, k, n), block)
    out = torch.zeros(g, m, n, device=dev)
    bits = torch.zeros(g, -(-m // emit[0]), -(-n // emit[1]),
                       dtype=torch.int32, device=dev)
    fi = jj = nl = None
    cap = 0
    if mode == "compact":
        cap = g * ni * nj + 3
        fi, jj, nl = qb.build_queue_kernel(om.reshape(g * ni, nj)
                                           .contiguous(), capacity=cap)
    args, rargs, got_splits, (ws, _member) = mm.launch_args(
        mm._COMPACT if mode == "compact" else mm._PREDICATED, a, b, out,
        bits, None if mode == "compact" else om, am, bmk, mult, fi, jj, nl,
        cap, block, emit)
    assert got_splits == splits and tuple(rargs[-4:-1]) == tuple(plan)
    lib = _build.load()
    _build.check(lib.masked_gemm_launch(*args), "gemm")
    torch.cuda.synchronize()
    partials = ws.clone()
    # the reduce, and the NaN fix-up its launcher runs after it
    _build.check(lib.masked_gemm_reduce_launch(*rargs), "reduce")
    torch.cuda.synchronize()
    live = ref.expand_block_mask(om, block[0], block[2])[:, :m, :n].bool()
    total = mm.splitk_reduce_plain(partials, plan) * mult
    want = torch.where(live, total, torch.zeros_like(total))
    assert _same(out, want)
    assert torch.equal(bits, mm.emit_nan_fixup_plain(
        want, mm.emit_bits(want.nan_to_num(0.0), emit), emit))
    seq = mm.splitk_reduce_plain(partials, mm.ReducePlan(1, 256, 1)) * mult
    seq = torch.where(live, seq, torch.zeros_like(seq))
    scale = float(seq.nan_to_num(0.0).abs().max())
    assert float((out - seq).nan_to_num(0.0).abs().max()) <= 1e-5 * scale
    if nan:
        assert int(out.isnan().sum()) == 1


@pytest.mark.parametrize("overflow", [False, True])
def test_launches_around_the_gemm_match_plain(dev, overflow):
    """queue_member alone zero-fills and marks its bitmap (nothing on
    overflow), emit_nan_fixup alone clears the NaN cells' bits whatever the
    device flag says, each as its plain version; a group-major compact
    dispatch that emits counts one pre-pass and one fix-up."""
    rng = np.random.default_rng(5)
    om = torch.tensor(rng.random((3 * 70, 1)) < 0.5, dtype=torch.int32,
                      device=dev)
    cap = om.numel() if not overflow else int(om.sum()) // 2
    fi, jj, nl = qb.build_queue_kernel(om, capacity=cap)
    member = torch.full((om.numel(),), 7, dtype=torch.int32, device=dev)
    mm.queue_member(fi, jj, nl, member, n_cols=1)
    want = mm.queue_member_plain(fi.cpu(), jj.cpu(), nl.cpu(),
                                 torch.full_like(member.cpu(), 7), n_cols=1)
    assert torch.equal(member.cpu(), want)
    assert int(want.sum()) == (0 if overflow else int(om.sum()))
    out = torch.randn(2, 33, 20, device=dev)
    out[1, 17, 3] = float("nan")
    bits = torch.ones(2, 17, 7, dtype=torch.int32, device=dev)
    mm.emit_nan_fixup(out, bits, (2, 3))
    assert torch.equal(bits.cpu(), mm.emit_nan_fixup_plain(
        out.cpu(), torch.ones(2, 17, 7, dtype=torch.int32), (2, 3)))
    assert int(bits[1, 8, 1]) == 0 and int(bits.sum()) == 2 * 17 * 7 - 1
    assert mm.queue_member_launches == 1 and mm.emit_fixup_launches == 1

    g, m, k, n, block = 3, 70 * 8, 9, 1, (8, 9, 1)
    assert mm.gemm_path(g, m, k, n, block) == mm.GROUP_ROWS
    a = torch.randn(g, m, k, device=dev)
    b = torch.randn(g, k, n, device=dev)
    mult = torch.ones(g, m, n, device=dev)
    got, got_bits = mm.grouped_compact_masked_matmul_kernel(
        a, b, fi, jj, nl, None, None, block=block, epilogue_mult=mult,
        emit_gran=(1, 1))
    plain, plain_bits = mm.grouped_compact_masked_matmul_kernel(
        a.cpu(), b.cpu(), fi.cpu(), jj.cpu(), nl.cpu(), None, None,
        block=block, epilogue_mult=mult.cpu(), emit_gran=(1, 1))
    if not overflow:       # the predicated fallback owns an overflow
        assert torch.allclose(got.cpu(), plain, rtol=1e-5, atol=1e-5)
        assert torch.equal(got_bits.cpu(), plain_bits)
    assert mm.queue_member_launches == 2 and mm.emit_fixup_launches == 2


@pytest.mark.parametrize("schedule,cap", [("predicated", None),
                                          ("compact", None),
                                          ("compact", 2)])
@pytest.mark.parametrize("where", ["a", "a_inf", "mult"])
def test_plain_gemm_repair_matches_kernels(dev, where, schedule, cap):
    """A NaN or an infinity in a skipped block: the kernels and the plain
    version put the non-finite values in the same places."""
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((16, 16)), dtype=torch.float32)
    mult = torch.tensor(rng.random((16, 16)) < 0.5, dtype=torch.float32)
    dead = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    ones = torch.ones(2, 2, dtype=torch.int32)
    om, bmk = {"a": (dead, ones), "a_inf": (ones, dead),
               "mult": (torch.tensor([[1, 1], [0, 1]], dtype=torch.int32),
                        ones)}[where]
    if where == "mult":
        mult[8, 0] = float("nan")
    else:
        a[0, 0] = float("nan") if where == "a" else float("inf")
    stages = ("sigma_prime",) if where == "mult" else ()
    spec = ops.GemmSpec(block=(8, 8, 8), schedule=schedule, epilogue=stages,
                        max_active_blocks=cap)
    res = []
    for d in ("cpu", dev):
        x = [t.to(d) for t in (a, b, om, ones, bmk, mult)]
        res.append(ops.sparse_gemm(x[0], x[1], tuple(x[2:5]), spec,
                                   epilogue_mult=x[5] if stages else None)
                   .cpu())
    want, got = res
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    fin = want.isfinite()
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5 * float(
        want[fin].abs().max())
    assert int((~want.isfinite()).sum()) == (0 if where == "mult" else 8)


@pytest.mark.parametrize("schedule", ["predicated", "compact"])
def test_composite_ops_on_card_match_cpu(dev, schedule):
    """relu_bwd_masked (σ′ from a ~50% mask) and weight_grad_masked over
    its result: the card against the plain versions on the CPU, with equal
    count dicts; the WG's long K takes the split-K plan."""
    rng = np.random.default_rng(12)
    dy = torch.relu(torch.tensor(rng.standard_normal((300, 200)),
                                 dtype=torch.float32))
    w_t = torch.tensor(rng.standard_normal((200, 72)), dtype=torch.float32)
    sigma = torch.tensor(rng.random((300, 72)) < 0.5, dtype=torch.float32)
    sigma[:64] = 0                       # two dead row tiles
    x_t = torch.tensor(rng.standard_normal((40, 300)), dtype=torch.float32)
    spec = ops.GemmSpec(block=(32, 32, 32), schedule=schedule)
    res, counts = [], []
    for d in ("cpu", dev):
        stats.reset()
        d_pre = ops.relu_bwd_masked(dy.to(d), w_t.to(d), sigma.to(d),
                                    spec=spec)
        dw = ops.weight_grad_masked(x_t.to(d), d_pre, spec=spec)
        res.append((d_pre.cpu(), dw.cpu()))
        counts.append(stats.counts())
    assert counts[1] == counts[0]
    for got, want in zip(res[1], res[0]):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
    assert float(res[1][0][:64].abs().max()) == 0.0


@pytest.mark.parametrize("net", ["googlenet", "resnet18", "densenet121"])
def test_other_networks_step_on_card_matches_cpu(dev, net):
    """One small IN_OUT_WR step of each of the other three networks: equal
    count dicts, the loss at 1e-5, launches equal to dispatches."""
    from repro_torch.cnn_training import train_steps
    kw = dict(net=net, steps=1, image_size=32, width=0.125, num_classes=10,
              batch=2)
    cpu = train_steps(device="cpu", **kw)["steps"][0]
    gpu = train_steps(device="cuda", **kw)["steps"][0]
    assert gpu["counts"] == cpu["counts"]
    assert abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    c, launches = gpu["counts"], gpu["launches"]
    assert c.get("conv:dense_fallback", 0) == 0
    assert launches["relu_encode"] == c["encode:act"]
    assert launches["queue_builder"] == c["queue:prefix_sum"]
    assert launches["compact_gemm"] == c["gemm:compact:1"] == sum(
        v for k, v in c.items() if k.startswith("gemm:"))
