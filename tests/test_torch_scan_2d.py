"""Kernels K5 (signed bitmap scan), K6 and K7 (the 2-D masked GEMMs) of the
port against the JAX reference, on the CPU.

Each wrapper takes its plain PyTorch version for CPU tensors; the reference
runs its Pallas kernels in interpret mode on the same numpy inputs.
Bitmaps must match exactly and be counted alike (``scan_pallas:<kind>``);
GEMM outputs to 1e-5, the reference's own tolerance
(tests/test_kernels_masked_matmul.py), and K7's compacted (S, bm, bn)
output slot for slot.  The CUDA kernels themselves run only on a GPU
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import sparse_tensor as jst
from repro.kernels import masked_matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro_torch.core import sparse_tensor as tst
from repro_torch.kernels import launch_counts
from repro_torch.kernels import masked_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


# ---------------------------------------------------------------------------
# K5 bitmap_scan
# ---------------------------------------------------------------------------

def _signed(shape, seed, density=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * (rng.random(shape) < density)


@pytest.mark.parametrize("gran", [(1, 1), (1, 3), (8, 8), (128, 128)])
@pytest.mark.parametrize("shape", [(37, 29), (130, 3), (8, 1024)])
def test_bitmap_scan_matches_reference(shape, gran):
    x = _signed(shape, 0)
    jbits = jops.bitmap_scan(jnp.asarray(x), block=gran, kind="act")
    tbits = tops.bitmap_scan(torch.tensor(x), block=gran, kind="act")
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert tstats.counts() == jstats.counts() == {"scan_pallas:act": 1}
    assert launch_counts()["bitmap_scan"] == 0      # CPU: plain version


def test_bitmap_scan_sees_negative_values():
    """Signed data: a cell holding only negatives is live."""
    x = -np.abs(_signed((16, 16), 1))
    x[:8] = 0.0
    tbits = tops.bitmap_scan(torch.tensor(x), block=(8, 8))
    jbits = jops.bitmap_scan(jnp.asarray(x), block=(8, 8))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert tbits.tolist() == [[0, 0], [1, 1]]


@pytest.mark.parametrize("gran", [(1, 1), (1, 3), (8, 8)])
def test_bitmap_scan_nan_cell_matches_reference(gran):
    """A cell holding a NaN next to a nonzero value: the reference's max over
    the cell carries the NaN and NaN > 0 is false, so its bit is 0."""
    x = _signed((37, 29), 3)
    x[9, 4], x[8, 5], x[9, 5] = np.nan, -2.0, 1.5
    jbits = jops.bitmap_scan(jnp.asarray(x), block=gran, kind="act")
    tbits = tops.bitmap_scan(torch.tensor(x), block=gran, kind="act")
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    gr, gc = gran
    assert int(tbits[9 // gr, 4 // gc]) == 0
    assert int(tbits[9 // gr, 5 // gc]) == (1 if gc == 1 else 0)


@pytest.mark.parametrize("impl", ["pallas", "xla_ref"])
def test_scan_bitmap_routes_like_reference(impl):
    x = _signed((21, 12), 2)
    jb = jst.scan_bitmap(jnp.asarray(x), (1, 4), kind="act", impl=impl)
    tb = tst.scan_bitmap(torch.tensor(x), (1, 4), kind="act", impl=impl)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tstats.counts() == jstats.counts()
    key = "scan_pallas:act" if impl == "pallas" else "scan:act"
    assert tstats.counts() == {key: 1}


# ---------------------------------------------------------------------------
# K6 / K7 — the 2-D predicated and compact launches
# ---------------------------------------------------------------------------

BLOCK = (8, 16, 8)


def _operands(seed=3, m=32, k=48, n=24):
    bm, bk, bn = BLOCK
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    om = (rng.random((m // bm, n // bn)) < 0.5).astype(np.int32)
    am = (rng.random((m // bm, k // bk)) < 0.6).astype(np.int32)
    bmk = (rng.random((k // bk, n // bn)) < 0.6).astype(np.int32)
    mult = (rng.random((m, n)) < 0.5).astype(np.float32)
    return a, b, om, am, bmk, mult


def _kw(mult, to):
    bm, bk, bn = BLOCK
    return dict(bm=bm, bk=bk, bn=bn,
                epilogue_mult=None if mult is None else to(mult))


@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
def test_masked_matmul_kernel_matches_reference(sigma):
    a, b, om, am, bmk, mult = _operands()
    mult = mult if sigma else None
    want = jmm.masked_matmul_kernel(
        *(jnp.asarray(v) for v in (a, b, om, am, bmk)), interpret=True,
        **_kw(mult, jnp.asarray))
    got = tmm.masked_matmul_kernel(
        *(torch.tensor(v) for v in (a, b, om, am, bmk)),
        **_kw(mult, torch.tensor))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
    assert launch_counts()["masked_matmul_2d"] == 0


@pytest.mark.parametrize("cap", ["full", "below"])
@pytest.mark.parametrize("sigma", [False, True], ids=["plain", "sigma"])
def test_compact_masked_matmul_kernel_matches_reference(sigma, cap):
    """The compacted (S, bm, bn) output, slot for slot: slot s < n_active
    holds tile (ii[s], jj[s]), the slots after it are zero."""
    a, b, om, am, bmk, mult = _operands(seed=4)
    mult = mult if sigma else None
    s_cap = om.size if cap == "full" else max(int(om.sum()) // 2, 1)
    ii, jj, n_live = jops.build_queue(jnp.asarray(om), capacity=s_cap)
    n_active = jnp.minimum(n_live, s_cap).reshape(1)
    want = jmm.compact_masked_matmul_kernel(
        jnp.asarray(a), jnp.asarray(b), ii, jj, n_active, jnp.asarray(am),
        jnp.asarray(bmk), interpret=True, **_kw(mult, jnp.asarray))
    got = tmm.compact_masked_matmul_kernel(
        torch.tensor(a), torch.tensor(b),
        *(torch.tensor(np.asarray(v)) for v in (ii, jj, n_active)),
        torch.tensor(am), torch.tensor(bmk), **_kw(mult, torch.tensor))
    assert tuple(got.shape) == np.asarray(want).shape == (s_cap, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert not got[int(n_active[0]):].any()
    assert launch_counts()["compact_masked_matmul_2d"] == 0


def test_2d_kernels_pin_sparse_gemm_g1():
    """Scattered, K7 equals K6, and both equal ``sparse_gemm`` at G = 1 —
    the role tests/test_gemm_spec.py gives the reference's 2-D kernels."""
    a, b, om, am, bmk, mult = _operands(seed=5)
    ta, tb, tom, tam, tbm, tmult = (torch.tensor(v) for v in
                                    (a, b, om, am, bmk, mult))
    bm, bk, bn = BLOCK
    k6 = tmm.masked_matmul_kernel(ta, tb, tom, tam, tbm, bm=bm, bk=bk, bn=bn,
                                  epilogue_mult=tmult)
    ii, jj, n_live = tops.build_queue(tom, capacity=tom.numel())
    k7 = tmm.compact_masked_matmul_kernel(ta, tb, ii, jj, n_live, tam, tbm,
                                          bm=bm, bk=bk, bn=bn,
                                          epilogue_mult=tmult)
    nl = int(n_live[0])
    scattered = torch.zeros_like(k6)
    scattered.view(4, bm, 3, bn)[ii[:nl].long(), :, jj[:nl].long(), :] = \
        k7[:nl]
    assert torch.equal(scattered, k6)
    spec = tops.GemmSpec(block=BLOCK, schedule="compact",
                         epilogue=("sigma_prime",))
    got = tops.sparse_gemm(ta, tb, (tom, tam, tbm), spec,
                           epilogue_mult=tmult)
    np.testing.assert_allclose(got.numpy(), k6.numpy(), rtol=TOL, atol=TOL)


def test_2d_kernels_reject_unaligned_and_non_f32():
    a, b, om, am, bmk, _ = (torch.tensor(v) for v in _operands())
    with pytest.raises(ValueError):
        tmm.masked_matmul_kernel(a[:30], b, om, am, bmk, bm=8, bk=16, bn=8)
    with pytest.raises(NotImplementedError):
        tmm.masked_matmul_kernel(a.half(), b, om, am, bmk, bm=8, bk=16,
                                 bn=8)
    # out_dtype is honoured as in the reference: f32 accumulation, cast
    got = tmm.masked_matmul_kernel(a, b, om, am, bmk, bm=8, bk=16, bn=8,
                                   out_dtype=torch.bfloat16)
    want = tmm.masked_matmul_kernel(a, b, om, am, bmk, bm=8, bk=16, bn=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    ii = torch.zeros(3, dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmm.compact_masked_matmul_kernel(a, b, ii, ii[:2], n, am, bmk, bm=8,
                                         bk=16, bn=8)
    with pytest.raises(ValueError):
        tmm.compact_masked_matmul_kernel(a, b, ii, ii, n, am[:2], bmk, bm=8,
                                         bk=16, bn=8)
