"""The port's CUDA kernels on a GPU: each kernel against its plain version,
and a small VGG16 step on the card against the same step on the CPU.

Marked ``cuda``; every test skips without a CUDA device (decided inside the
fixture, never at import).  On a machine with a GPU and nvcc:
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
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
