"""The port's sparse units against the JAX reference, on the CPU.

``relu_matmul``/``matmul`` and the conv engine (stride {1, 2} × {SAME,
VALID}; tests/test_torch_grouped.py sweeps its grouped branch) run forward
and backward in both packages on the
same numpy inputs; the reference side runs its Pallas kernels in interpret
mode under ``kernel_impl="pallas"``.  Outputs and gradients must agree to
1e-5 relative to their scale (both sum the same products in f32, in a
different order), and the two packages' stats count dicts must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.core import sparse_conv as jconv
from repro.core import sparse_linear as jlin
from repro.kernels import stats as jstats
from repro_torch.core import policy as tpol
from repro_torch.core import sparse_conv as tconv
from repro_torch.core import sparse_linear as tlin
from repro_torch.kernels import stats as tstats

TOL = 1e-5
BLOCK = (8, 16, 8)
POLICIES = {
    "IN_OUT_WR": (jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK),
                  tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)),
    "IN_OUT": (jpol.IN_OUT.with_(kernel_impl="pallas", block=BLOCK),
               tpol.IN_OUT.with_(kernel_impl="pallas", block=BLOCK)),
}


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _rand(shape, seed, sparsify=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if sparsify:
        x *= rng.random(shape) > sparsify
    return x


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


def _both(jfn, tfn, inputs, cotangent_seed):
    """Run ``sum(f(*inputs) * c)`` forward and backward in both packages;
    return ((j_out, j_grads, j_counts), (t_out, t_grads, t_counts))."""
    jin = [jnp.asarray(x) for x in inputs]
    c = _rand(jax.eval_shape(jfn, *jin).shape, cotangent_seed)

    def jrun(*xs):
        out, vjp = jax.vjp(jfn, *xs)
        return out, vjp(jnp.asarray(c))

    jstats.reset()
    jout, jg = jax.jit(jrun)(*jin)
    jc = jstats.counts()
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tstats.reset()
    tout = tfn(*tin)
    tg = torch.autograd.grad((tout * torch.tensor(c)).sum(), tin)
    tc = tstats.counts()
    return (jout, jg, jc), (tout.detach().numpy(), [g.numpy() for g in tg], tc)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("unit", ["relu_matmul", "matmul"])
def test_linear_units_match_reference(unit, policy):
    jp, tp = POLICIES[policy]
    x = _rand((37, 29), 0, 0.3)
    w = _rand((29, 23), 1)
    jf = {"relu_matmul": lambda a, b: jlin.relu_matmul(a, b, jp),
          "matmul": lambda a, b: jlin.matmul(a, b, jp)}[unit]
    tf = {"relu_matmul": lambda a, b: tlin.relu_matmul(a, b, tp),
          "matmul": lambda a, b: tlin.matmul(a, b, tp)}[unit]
    (jout, jg, jc), (tout, tg, tc) = _both(jf, tf, (x, w), 2)
    _close(tout, jout)
    for got, want in zip(tg, jg):
        _close(got, want)
    assert tc == jc


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fused", [True, False], ids=["relu_conv", "conv"])
def test_conv_engine_matches_reference(stride, padding, fused):
    jp, tp = POLICIES["IN_OUT_WR"]
    x = _rand((2, 9, 8, 8), 3)
    w = _rand((3, 3, 8, 16), 4) * 0.3
    jface = jconv.relu_conv if fused else jconv.conv
    tface = tconv.relu_conv if fused else tconv.conv
    (jout, jg, jc), (tout, tg, tc) = _both(
        lambda a, b: jface(a, b, stride, padding, jp),
        lambda a, b: tface(a, b, stride, padding, tp), (x, w), 5)
    assert tout.shape == np.asarray(jout).shape
    _close(tout, jout)
    for got, want in zip(tg, jg):
        _close(got, want)
    assert tc == jc


def test_relu_conv_chain_hands_dy_bitmap_through_registry():
    """Two stacked relu_convs: the upper one's dX GEMM emits the lower
    one's dy bitmap, and torch autograd hands the lower backward the very
    tensor object that was registered (a registry hit, as in JAX)."""
    jp, tp = POLICIES["IN_OUT"]
    x = _rand((2, 8, 8, 8), 6)
    w1 = _rand((3, 3, 8, 8), 7) * 0.3
    w2 = _rand((3, 3, 8, 8), 8) * 0.3

    def jf(a, b, c):
        return jconv.relu_conv(jconv.relu_conv(a, b, 1, "SAME", jp), c, 1,
                               "SAME", jp)

    def tf(a, b, c):
        return tconv.relu_conv(tconv.relu_conv(a, b, 1, "SAME", tp), c, 1,
                               "SAME", tp)

    (jout, jg, jc), (tout, tg, tc) = _both(jf, tf, (x, w1, w2), 9)
    _close(tout, jout)
    for got, want in zip(tg, jg):
        _close(got, want)
    assert tc == jc
    assert tc["registry:hit"] == 1


def test_policy_rejects_unported_options():
    # autotune is ported: the policy takes it (tests/test_torch_autotune.py)
    assert tpol.IN_OUT_WR.with_(autotune=True).autotune
    with pytest.raises(ValueError):
        tpol.IN_OUT_WR.with_(kernel_impl="bogus")
    # the signed-input scan is ported: the policy takes it as the reference
    # does, with the reference's defaults for the grouped-engine fields
    p = tpol.IN_OUT_WR.with_(scan_signed_inputs=True)
    assert p.scan_signed_inputs
    assert (p.grouped_sparsity_min_k, p.fuse_epilogue) == \
        (jpol.IN_OUT_WR.grouped_sparsity_min_k, jpol.IN_OUT_WR.fuse_epilogue)
    # dense dims, and the degenerate per-group dims of depthwise dX and WG
    shapes = [((33, 40, 29), (1, 8, 8), 1), ((100352, 9, 1), (1, 1, 1), 32),
              ((9, 100352, 1), (1, 1, 1), 32), ((50, 18, 8), (1, 4, 4), 2)]
    for name in jpol.SCENARIOS:
        j, t = jpol.SCENARIOS[name], tpol.SCENARIOS[name]
        for kw in ({}, {"kernel_impl": "pallas"}):
            for dims, grans, groups in shapes:
                js = j.with_(**kw).gemm_spec(groups=groups, dims=dims,
                                             grans=grans)
                ts = t.with_(**kw).gemm_spec(groups=groups, dims=dims,
                                             grans=grans)
                assert (ts.block, ts.groups, ts.schedule, ts.epilogue,
                        ts.queue_builder) == (js.block, js.groups,
                                              js.schedule, js.epilogue,
                                              js.queue_builder)
