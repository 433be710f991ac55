"""The port's CUDA kernels on a GPU: each kernel against its plain version,
and small VGG16 and MobileNet steps on the card against the same steps on
the CPU.

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
from repro_torch.kernels import ops, shapes, stats
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
