"""The port's grouped and depthwise conv engine against the JAX reference, on
the CPU.

The sweep of tests/test_grouped_conv.py — stride {1, 2} × {SAME, VALID} ×
groups {2, C} × fused ReLU {yes, no} — plus the depthwise faces, the
``grouped_sparsity_min_k`` cut-off and the unfused σ′ ablation
(``fuse_epilogue=False``).  Both packages run forward and backward on the
same numpy inputs; the reference is jitted and runs its Pallas kernels in
interpret mode under ``kernel_impl="pallas"``.  Outputs and gradients must
agree to 1e-4·max|g| (the reference's own grouped tests hold 3e-4 against
dense autodiff), and the two packages' stats count dicts must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.core import sparse_conv as jconv
from repro.kernels import stats as jstats
from repro_torch.core import policy as tpol
from repro_torch.core import sparse_conv as tconv
from repro_torch.kernels import stats as tstats

TOL = 1e-4
C, M = 6, 12     # channels divisible by both group counts under test
BLOCK = (8, 16, 8)
WR = (jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK),
      tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK))
PRED = (jpol.IN_OUT.with_(kernel_impl="pallas", block=(16, 16, 16)),
        tpol.IN_OUT.with_(kernel_impl="pallas", block=(16, 16, 16)))


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale


def _check(jfn, tfn, x, w, seed):
    """``sum(f(x, w) * c)`` forward and backward in both packages: outputs,
    both gradients and the count dicts must agree; returns the counts."""
    c = _rand(jax.eval_shape(jfn, jnp.asarray(x), jnp.asarray(w)).shape,
              seed)

    def jrun(a, b):
        out, vjp = jax.vjp(jfn, a, b)
        return out, vjp(jnp.asarray(c))

    jstats.reset()
    jout, jg = jax.jit(jrun)(jnp.asarray(x), jnp.asarray(w))
    jc = jstats.counts()
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tstats.reset()
    tout = tfn(tx, tw)
    tg = torch.autograd.grad((tout * torch.tensor(c)).sum(), (tx, tw))
    tc = tstats.counts()
    assert tuple(tout.shape) == np.asarray(jout).shape
    _close(tout.detach().numpy(), jout)
    for got, want in zip(tg, jg):
        _close(got.numpy(), want)
    assert tc == jc
    return tc


@pytest.mark.parametrize("fused", [True, False], ids=["relu_conv", "conv"])
@pytest.mark.parametrize("groups", [2, C])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_engine_matches_reference(stride, padding, groups, fused):
    jp, tp = WR
    x = _rand((2, 9, 11, C), 1)
    w = _rand((3, 3, C // groups, M), 2) * 0.3
    jface = jconv.relu_conv if fused else jconv.conv
    tface = tconv.relu_conv if fused else tconv.conv
    counts = _check(
        lambda a, b: jface(a, b, stride, padding, jp, groups=groups),
        lambda a, b: tface(a, b, stride, padding, tp, groups=groups),
        x, w, 3)
    assert counts[f"gemm:compact:{groups}"] == 3


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fused", [True, False],
                         ids=["depthwise_relu_conv", "depthwise_conv"])
def test_depthwise_faces_match_reference(fused, stride):
    jp, tp = PRED
    c = 8
    x = _rand((2, 8, 8, c), 5)
    w = _rand((3, 3, 1, c), 6) * 0.3
    jface = jconv.depthwise_relu_conv if fused else jconv.depthwise_conv
    tface = tconv.depthwise_relu_conv if fused else tconv.depthwise_conv
    counts = _check(lambda a, b: jface(a, b, stride, "SAME", jp),
                    lambda a, b: tface(a, b, stride, "SAME", tp), x, w, 7)
    assert counts[f"gemm:predicated:{c}"] == 3


def test_depthwise_relu_conv_dx_is_exactly_zero_where_relu_is_off():
    """σ′ rides each group's epilogue: masked channels of dx are exact
    zeros, and one group's zeros never leak into another."""
    _, tp = WR
    x = torch.tensor(_rand((2, 8, 8, 8), 8), requires_grad=True)
    w = torch.tensor(_rand((3, 3, 1, 8), 9))
    y = tconv.depthwise_relu_conv(x, w, 1, "SAME", tp)
    (dx,) = torch.autograd.grad((y * y).sum(), (x,))
    assert bool((dx[x.detach() < 0] == 0).all())


def test_grouped_sparsity_min_k_drops_masks(monkeypatch):
    """Above the per-group K of a depthwise conv the FP and dX operand
    masks are dropped, in both packages alike, without changing a number;
    the WG masks stay."""
    jp, tp = PRED
    hi = (jp.with_(grouped_sparsity_min_k=1000),
          tp.with_(grouped_sparsity_min_k=1000))
    x = _rand((2, 8, 8, 8), 10)
    w = _rand((3, 3, 1, 8), 11) * 0.3
    for pj, pt in (PRED, hi):
        _check(lambda a, b: jconv.depthwise_relu_conv(a, b, 1, "SAME", pj),
               lambda a, b: tconv.depthwise_relu_conv(a, b, 1, "SAME", pt),
               x, w, 12)

    # Two stacked depthwise convs, so the lower dX GEMM has a dy bitmap.
    # _mm calls: FP lower, FP upper, dX upper (dy from the loss: no mask),
    # WG upper, dX lower, WG lower.
    seen = []
    real = tconv._mm

    def spy(a, b, out_mask, a_mask, *args, **kw):
        seen.append(a_mask is not None)
        return real(a, b, out_mask, a_mask, *args, **kw)

    monkeypatch.setattr(tconv, "_mm", spy)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    for pol, want in ((tp, [True, True, False, True, True, True]),
                      (hi[1], [False, False, False, True, False, True])):
        seen.clear()
        y = tconv.depthwise_relu_conv(
            tconv.depthwise_relu_conv(tx, tw, 1, "SAME", pol), tw, 1,
            "SAME", pol)
        torch.autograd.grad((y * y).sum(), (tx, tw))
        assert seen == want


@pytest.mark.parametrize("groups", [1, 2, C])
def test_unfused_epilogue_matches_reference(groups):
    """``fuse_epilogue=False``: σ′ as a separate pass after the GEMM, its
    emitted bits dropped — the same numbers and counts as the reference."""
    jp, tp = (p.with_(fuse_epilogue=False) for p in WR)
    x = _rand((2, 8, 8, C), 13)
    w = _rand((3, 3, C // groups, M), 14) * 0.3
    counts = _check(
        lambda a, b: jconv.relu_conv(a, b, 1, "SAME", jp, groups=groups),
        lambda a, b: tconv.relu_conv(a, b, 1, "SAME", tp, groups=groups),
        x, w, 15)
    assert "emit:grad" not in counts


@pytest.mark.parametrize("fused", [True, False],
                         ids=["depthwise_relu_conv", "depthwise_conv"])
def test_depthwise_channel_multiplier_matches_reference(fused):
    """w (R,S,1,C·2): the engine takes a channel multiplier (groups == C,
    two outputs per group), the path a depthwise node with such weights
    takes on the card."""
    jp, tp = WR
    c = 4
    x = _rand((2, 7, 7, c), 16)
    w = _rand((3, 3, 1, 2 * c), 17) * 0.3
    jface = jconv.depthwise_relu_conv if fused else jconv.depthwise_conv
    tface = tconv.depthwise_relu_conv if fused else tconv.depthwise_conv
    counts = _check(lambda a, b: jface(a, b, 2, "SAME", jp),
                    lambda a, b: tface(a, b, 2, "SAME", tp), x, w, 18)
    assert counts[f"gemm:compact:{c}"] == 3


def test_depthwise_engine_rejects_other_group_structures():
    """Weights that are not one input channel per group raise."""
    _, tp = WR
    x = torch.tensor(_rand((2, 7, 7, 4), 19))
    for shape in ((3, 3, 2, 4), (3, 3, 1, 6)):
        with pytest.raises(ValueError):
            tconv.depthwise_relu_conv(x, torch.tensor(_rand(shape, 20)), 1,
                                      "SAME", tp)
