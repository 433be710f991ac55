"""The port's sparsity statistics and the paper's two composite ops against
the JAX package's.

``core/sparsity.py``: each function on seeded numpy inputs at 1e-6, and
``footprints_identical`` with the same verdicts.  ``kernels.ops``'
``relu_bwd_masked`` and ``weight_grad_masked``: the port's plain versions
(CPU tensors) against the reference's Pallas kernels in interpret mode, as
its own tests run them, at 1e-5 and with equal count dicts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import sparsity as jsp
from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _sparse(shape, seed, dead_rows=0, dead_cols=0, p=0.5):
    """Normal values with ~p of them zeroed, plus whole dead rows/cols."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.random(shape) > p
    if dead_rows:
        x[:dead_rows] = 0
    if dead_cols:
        x[..., :dead_cols] = 0
    return x


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.0), (2, 0.95), (3, 1.0)])
def test_elementwise_statistics_match(seed, p):
    x = _sparse((6, 10, 12), seed, p=p)
    _close(tsp.relu_mask(torch.tensor(x)), jsp.relu_mask(jnp.asarray(x)))
    _close(tsp.element_sparsity(torch.tensor(x)),
           jsp.element_sparsity(jnp.asarray(x)))
    _close(tsp.tc_sparsity(torch.tensor(x)), jsp.tc_sparsity(jnp.asarray(x)))
    _close(tsp.wc_sparsity(torch.tensor(x)), jsp.wc_sparsity(jnp.asarray(x)))


@pytest.mark.parametrize("block", [(1, 1), (4, 4), (8, 16), (16, 8)])
@pytest.mark.parametrize("seed,p,dead", [(0, 0.5, (0, 0)), (1, 0.9, (16, 8)),
                                         (2, 0.0, (0, 0)), (3, 1.0, (0, 0)),
                                         (4, 0.3, (32, 0))])
def test_block_statistics_match(block, seed, p, dead):
    x = _sparse((64, 48), seed, dead_rows=dead[0], dead_cols=dead[1], p=p)
    bm, bn = block
    xt, xj = torch.tensor(x), jnp.asarray(x)
    _close(tsp.block_sparsity(xt, bm, bn), jsp.block_sparsity(xj, bm, bn))
    _close(tsp.capture_rate(xt, bm, bn), jsp.capture_rate(xj, bm, bn))
    _close(tsp.block_any_nonzero(xt, bm, bn),
           jsp.block_any_nonzero(xj, bm, bn))
    bits = np.asarray(jsp.block_any_nonzero(xj, bm, bn))
    _close(tsp.expand_block_mask(torch.tensor(bits), bm, bn),
           jsp.expand_block_mask(jnp.asarray(bits), bm, bn))
    got = tsp.SparsityStats.of(xt, bm, bn)
    want = jsp.SparsityStats.of(xj, bm, bn)
    for f in ("element", "block", "capture"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-6, f


@pytest.mark.parametrize("seed", range(4))
def test_footprints_identical_same_verdicts(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((8, 9, 5)).astype(np.float32)
    act = np.maximum(z, 0)
    dy = rng.standard_normal(z.shape).astype(np.float32)
    dy *= rng.random(z.shape) > 0.3
    cases = {"through_relu": dy * (z > 0),
             "extra_zeros": dy * (z > 0) * (rng.random(z.shape) > 0.5),
             "leak": dy,                            # nonzero where act == 0
             "one_leak": (dy * (z > 0)).copy()}
    leak_at = np.argwhere(act == 0)[0]
    cases["one_leak"][tuple(leak_at)] = 1.0
    verdicts = {}
    for name, g in cases.items():
        want = jsp.footprints_identical(jnp.asarray(act), jnp.asarray(g))
        got = tsp.footprints_identical(torch.tensor(act), torch.tensor(g))
        assert got is want, name
        verdicts[name] = got
    assert verdicts == {"through_relu": True, "extra_zeros": True,
                        "leak": False, "one_leak": False}


# ---------------------------------------------------------------------------
# The composite ops
# ---------------------------------------------------------------------------

OP_CASES = {
    # (M, K, N), block, mask density, dead dy k-rows
    "aligned": ((64, 48, 32), (16, 16, 16), 0.5, 0),
    "ragged": ((37, 29, 21), (8, 8, 8), 0.5, 0),
    "dead_tiles": ((64, 48, 32), (16, 16, 16), 0.5, 16),
    "all_dead": ((32, 16, 16), (8, 8, 8), 0.0, 0),
}


def _op_inputs(case):
    (m, k, n), block, dens, dead = OP_CASES[case]
    rng = np.random.default_rng(5)
    dy = rng.standard_normal((m, k)).astype(np.float32)
    dy[:, :dead] = 0
    w_t = rng.standard_normal((k, n)).astype(np.float32)
    mask = (rng.random((m, n)) < dens).astype(np.float32)
    mask[: m // 4] = 0                      # a dead band of output tiles
    x_t = rng.standard_normal((n, m)).astype(np.float32)
    x_t *= rng.random((n, m)) > 0.5
    return block, dy, w_t, mask, x_t


@pytest.mark.parametrize("schedule", ["predicated", "compact"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("use_in,use_out", [(True, True), (False, True),
                                            (True, False)])
def test_relu_bwd_masked_matches_reference(case, schedule, use_in, use_out):
    block, dy, w_t, mask, _ = _op_inputs(case)
    kw = dict(use_input_sparsity=use_in, use_output_sparsity=use_out)
    jstats.reset()
    want = jops.relu_bwd_masked(
        jnp.asarray(dy), jnp.asarray(w_t), jnp.asarray(mask),
        spec=jops.GemmSpec(block=block, schedule=schedule), **kw)
    jc = jstats.counts()
    tstats.reset()
    got = tops.relu_bwd_masked(
        torch.tensor(dy), torch.tensor(w_t), torch.tensor(mask),
        spec=tops.GemmSpec(block=block, schedule=schedule), **kw)
    assert tstats.counts() == jc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), (dy @ w_t) * mask, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("schedule", ["predicated", "compact"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("use_in", [True, False])
def test_weight_grad_masked_matches_reference(case, schedule, use_in):
    block, dy, w_t, mask, x_t = _op_inputs(case)
    d_pre = ((dy @ w_t) * mask).astype(np.float32)
    jstats.reset()
    want = jops.weight_grad_masked(
        jnp.asarray(x_t), jnp.asarray(d_pre),
        spec=jops.GemmSpec(block=block, schedule=schedule),
        use_input_sparsity=use_in)
    jc = jstats.counts()
    tstats.reset()
    got = tops.weight_grad_masked(
        torch.tensor(x_t), torch.tensor(d_pre),
        spec=tops.GemmSpec(block=block, schedule=schedule),
        use_input_sparsity=use_in)
    assert tstats.counts() == jc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x_t @ d_pre, rtol=1e-4,
                               atol=1e-4)


def test_ops_are_exported_as_in_the_reference():
    import repro.kernels as jk
    import repro_torch.kernels as tk
    for name in ("relu_bwd_masked", "weight_grad_masked", "sparse_gemm",
                 "build_queue", "GemmSpec", "GemmMasks"):
        assert hasattr(jk, name) and hasattr(tk, name), name
