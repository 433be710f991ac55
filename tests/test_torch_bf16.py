"""bf16 operands and ``out_dtype`` in the port, against the JAX package:
the masked GEMM on every schedule with bf16 operands against the
reference's bf16 ``sparse_gemm`` at its own bf16 tolerance (2e-2,
``tests/test_kernels_masked_matmul.py``), emitted bitmaps exact;
``out_dtype`` honoured (f32 accumulation, cast at the end); K1 and K5 on
bf16 with relu(z) keeping z's dtype and the bitmaps exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import stats as jstats
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats

BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()
    yield
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()


def _bf16_pair(x: np.ndarray):
    """The same bf16 values in both packages (rounded once, by JAX)."""
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)
    return j, t


def _case(m, k, n, block, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    a *= rng.random((m, k)) > 0.5
    b = rng.standard_normal((k, n)).astype(np.float32)
    bm, bk, bn = block
    om = (rng.random((-(-m // bm), -(-n // bn))) > 0.3).astype(np.int32)
    am = np.asarray(jref.block_any_nonzero(
        jnp.pad(jnp.asarray(a), ((0, -m % bm), (0, -k % bk))), bm, bk))
    return a, b, om, am.astype(np.int32)


@pytest.mark.parametrize("shape", [(16, 16, 16), (33, 17, 65),
                                   (48, 40, 56)])
@pytest.mark.parametrize("schedule", ["predicated", "compact", "dense"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_bf16_gemm_matches_reference(shape, schedule, out_dtype):
    block = (16, 8, 16)
    m, k, n = shape
    a, b, om, am = _case(m, k, n, block)
    ja, ta = _bf16_pair(a)
    jb, tb = _bf16_pair(b)
    kw = dict(block=block, schedule=schedule,
              epilogue=("bitmap_emit",), emit_gran=(4, 8))
    jspec = jops.GemmSpec(out_dtype=getattr(jnp, out_dtype), **kw)
    tspec = tops.GemmSpec(out_dtype=getattr(torch, out_dtype), **kw)
    jout, jbits = jops.sparse_gemm(ja, jb, jops.GemmMasks(
        jnp.asarray(om), jnp.asarray(am), None), jspec)
    tout, tbits = tops.sparse_gemm(ta, tb, tops.GemmMasks(
        torch.from_numpy(om), torch.from_numpy(am), None), tspec)
    assert tstats.counts() == jstats.counts()
    assert tout.dtype == getattr(torch, out_dtype)
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(tout.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    # the bits describe the f32 accumulator's zeros: exact
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    # out_dtype is a cast of the f32 result
    f32 = tops.sparse_gemm(ta, tb, tops.GemmMasks(
        torch.from_numpy(om), torch.from_numpy(am), None),
        tspec.with_(out_dtype=torch.float32))[0]
    assert torch.equal(tout, f32.to(tout.dtype))


@pytest.mark.parametrize("grouped", [False, True])
def test_bf16_operands_match_their_f32_widening(grouped):
    """bf16 products are exact in f32: a bf16 GEMM equals the f32 GEMM of
    the widened operands, and the mixed case is taken too."""
    a, b, om, am = _case(40, 24, 48, (8, 8, 8), seed=3)
    _, ta = _bf16_pair(a)
    _, tb = _bf16_pair(b)
    if grouped:
        ta, tb = ta.reshape(2, 20, 24), tb.reshape(24, 2, 24) \
            .permute(1, 0, 2).contiguous()
    spec = tops.GemmSpec(block=(8, 8, 8), groups=2 if grouped else 1,
                         schedule="compact")
    got = tops.sparse_gemm(ta, tb, None, spec)
    want = tops.sparse_gemm(ta.float(), tb.float(), None, spec)
    mixed = tops.sparse_gemm(ta, tb.float(), None, spec)
    assert torch.equal(got, want) and torch.equal(mixed, want)


@pytest.mark.parametrize("gran", [(1, 8), (4, 4), (3, 5)])
def test_bf16_relu_encode_and_scan_match_reference(gran):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((21, 30)).astype(np.float32)
    z[:6] = -np.abs(z[:6])
    jz, tz = _bf16_pair(z)
    jy, jbits = jops.relu_encode(jz, block=gran)
    ty, tbits = tops.relu_encode(tz, block=gran)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    js = jops.bitmap_scan(jz, block=gran)
    ts = tops.bitmap_scan(tz, block=gran)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tstats.counts() == jstats.counts()
