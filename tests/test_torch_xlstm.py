"""The port's xLSTM blocks against the JAX package's: ``mlstm_apply`` across
chunk boundaries (the carried (C, n, m)) and ``slstm_apply`` (the port's
Python time loop against the reference's ``lax.scan``), outputs and every
gradient; ``mlstm_decode`` and ``slstm_decode`` step by step (outputs and
state) and against the parallel forward; a 24-layer stack's f32 steps
of both packages against float64.  Same numpy inputs and the reference's
weights into both; tolerance 1e-5 (f32), the decode-vs-parallel check at
the reference's 2e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.models import xlstm as jx
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.models import xlstm as tx
from repro_torch.models.transformer import params_from_jax

TOL = 1e-5
JCFG = jx.XLSTMConfig(d_model=32, n_heads=2, chunk=8)
TCFG = tx.XLSTMConfig(d_model=32, n_heads=2, chunk=8)
KINDS = {"mlstm": (jx.mlstm_init, jx.mlstm_apply, tx.mlstm_apply),
         "slstm": (jx.slstm_init, jx.slstm_apply, tx.slstm_apply)}


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()
    yield
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()


def _close(got, want, tol=TOL):
    got = got.detach().cpu().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _params(kind, seed=0):
    pn = jax.tree.map(np.asarray, KINDS[kind][0](jax.random.key(seed), JCFG))
    return pn, params_from_jax(pn, device="cpu")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("t", [8, 24])
def test_apply_and_grads_match_reference(kind, t):
    _, japply, tapply = KINDS[kind]
    pn, tp = _params(kind)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, JCFG.d_model)).astype(np.float32)
    w = rng.standard_normal((2, t, JCFG.d_model)).astype(np.float32)
    jy = jax.jit(lambda p, x: japply(p, x, JCFG))(pn, jnp.asarray(x))
    jg, jgx = jax.jit(jax.grad(lambda p, x: (japply(p, x, JCFG) * w).sum(),
                               argnums=(0, 1)))(pn, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx_ = torch.from_numpy(x).requires_grad_(True)
    y = tapply(tp, tx_, TCFG)
    _close(y, jy)
    (y * torch.from_numpy(w)).sum().backward()
    for k in sorted(pn):
        _close(tp[k].grad, jg[k])
    _close(tx_.grad, jgx)


def test_mlstm_rejects_a_ragged_sequence():
    _, tp = _params("mlstm")
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        tx.mlstm_apply(tp, torch.zeros(1, 12, TCFG.d_model), TCFG)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_matches_reference_and_parallel_forward(kind):
    """Sixteen decode steps (two mLSTM chunks of 8) against the
    reference's, output and every state entry at every step; the outputs
    against the block's parallel forward over the same inputs."""
    pn, tp = _params(kind, seed=1)
    jdec = {"mlstm": jx.mlstm_decode, "slstm": jx.slstm_decode}[kind]
    tdec = {"mlstm": tx.mlstm_decode, "slstm": tx.slstm_decode}[kind]
    jc = (jx.mlstm_init_cache if kind == "mlstm"
          else jx.slstm_init_cache)(JCFG, 2)
    tc = (tx.mlstm_init_cache if kind == "mlstm"
          else tx.slstm_init_cache)(TCFG, 2, "cpu")
    step = jax.jit(lambda p, x, c: jdec(p, x, c, JCFG))
    t = 16
    x = np.random.default_rng(5).standard_normal(
        (2, t, JCFG.d_model)).astype(np.float32)
    outs = []
    for i in range(t):
        jy, jc = step(pn, jnp.asarray(x[:, i:i + 1]), jc)
        ty, tc2 = tdec(tp, torch.from_numpy(x[:, i:i + 1]), tc, TCFG)
        assert tc2 is tc
        _close(ty, jy)
        for k in sorted(jc):
            _close(tc[k], jc[k])
        outs.append(ty)
    par = KINDS[kind][2](tp, torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), par.numpy(),
                               rtol=2e-3, atol=2e-3)


# chip_smoke.py's rule for xlstm-350m's first step at full depth: each
# gradient leaf within ULP_RATIO times the farthest that ULP_DRAWS float64
# steps from params moved by one f32 rounding lie from the float64 step
# (``repro_torch.conditioning``), or phase 7's 1e-4.
ULP_DRAWS, ULP_RATIO, F64_TOL = 2, 16.0, 1e-4


def test_deep_stack_f32_gap_is_the_networks(monkeypatch):
    """The SMOKE xlstm at 24 layers, 2 x 128 tokens: the f32 step of
    either package lies beyond 1e-4 of the port's float64 step, and so
    does a float64 step from params moved by one f32 rounding (x (1 ±
    2^-24)); every f32 leaf of both packages is held by the chip check's
    rule, which rejects the mLSTM carry reset at every chunk.  Readings:
    the port 1.46e-3, the reference 6.11e-4, the moved float64 steps
    2.82e-4 at their worst leaves; per leaf the port at most 5.2 times the
    spread, the reference 2.7 times."""
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.models import transformer as jtr
    from repro_torch import conditioning
    from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
    from repro_torch.models import transformer as ttr

    jcfg = J_SMOKE["xlstm-350m"].with_(n_layers=24)
    tcfg = T_SMOKE["xlstm-350m"].with_(n_layers=24)
    jp = jtr.lm_init(jax.random.key(0), jcfg, dtype=jnp.float32)
    tok = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    _, jg = jax.jit(jax.value_and_grad(lambda p: jtr.lm_loss(
        p, {"tokens": jnp.asarray(tok)}, jcfg)))(jp)
    tp = ttr.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = {"tokens": torch.from_numpy(tok)}
    _, g64 = conditioning.lm_grads(tcfg, tp, batch, torch.float64)
    spread = np.max(conditioning.rounding_spreads(tcfg, tp, batch, g64,
                                                  ULP_DRAWS), axis=0)
    bounds = np.maximum(F64_TOL, ULP_RATIO * spread)
    assert spread.max() > F64_TOL

    def rels(g):
        return np.array(conditioning.leaf_rels(g, g64))
    port = conditioning.lm_grads(tcfg, tp, batch, torch.float32)[1]
    for g in (port, [torch.from_numpy(np.asarray(x)) for x in
                     jax.tree.leaves(jg)]):
        r = rels(g)
        assert r.max() > F64_TOL and np.all(r <= bounds)
    real = tx._mlstm_chunk
    monkeypatch.setattr(tx, "_mlstm_chunk", lambda carry, *a: real(
        (torch.zeros_like(carry[0]), torch.zeros_like(carry[1]),
         torch.full_like(carry[2], tx.NEG_INIT)), *a))
    assert not np.all(rels(conditioning.lm_grads(
        tcfg, tp, batch, torch.float32)[1]) <= bounds)
