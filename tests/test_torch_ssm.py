"""The port's Mamba block against the JAX package's: the chunk scan against
``jax.lax.associative_scan``, ``ssm_apply`` (output and every gradient)
across chunk boundaries, ``ssm_decode`` step by step (output and state)
and against the parallel forward.  Same numpy inputs and the reference's
weights into both; tolerance 1e-5 (f32, different summation orders), the
decode-vs-parallel check at the reference's own 2e-3
(``tests/test_models_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.models import ssm as jssm
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import params_from_jax

TOL = 1e-5


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


def _cfgs(chunk=8, d_model=32):
    return (jssm.SSMConfig(d_model=d_model, chunk=chunk),
            tssm.SSMConfig(d_model=d_model, chunk=chunk))


def _params(jcfg, seed=0):
    pn = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(seed), jcfg))
    return pn, params_from_jax(pn, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 16])
def test_chunk_scan_matches_associative_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)

    def op(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    ja, jb = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = tssm._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(ta, ja, 1e-6)
    _close(tb, jb, 1e-6)


@pytest.mark.parametrize("t", [8, 24])          # one chunk, three chunks
def test_ssm_apply_and_grads_match_reference(t):
    jcfg, tcfg = _cfgs()
    pn, tp = _params(jcfg)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    f = jax.jit(jax.grad(
        lambda p, x: (jssm.ssm_apply(p, x, jcfg) * w).sum(), argnums=(0, 1)))
    jg, jgx = f(pn, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tssm.ssm_apply(tp, tx, tcfg)
    want_y = jax.jit(lambda p, x: jssm.ssm_apply(p, x, jcfg))(pn,
                                                             jnp.asarray(x))
    _close(y, want_y)
    (y * torch.from_numpy(w)).sum().backward()
    for k in sorted(pn):
        _close(tp[k].grad, jg[k])
    _close(tx.grad, jgx)


def test_ssm_apply_rejects_a_ragged_sequence():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    with pytest.raises(ValueError, match="multiple of the SSM chunk"):
        tssm.ssm_apply(tp, torch.zeros(1, 12, tcfg.d_model), tcfg)


def test_ssm_decode_matches_reference_and_parallel_forward():
    """Sixteen steps of ``ssm_decode`` (two chunks of 8) against the
    reference's, output and state at every step, and the last outputs
    against ``ssm_apply`` over the same sequence."""
    jcfg, tcfg = _cfgs()
    pn, tp = _params(jcfg, seed=1)
    t = 16
    x = np.random.default_rng(3).standard_normal(
        (2, t, jcfg.d_model)).astype(np.float32)
    jdec = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, c, jcfg))
    jc = jssm.ssm_init_cache(jcfg, 2, jnp.float32)
    tc = tssm.ssm_init_cache(tcfg, 2, torch.float32, "cpu")
    outs = []
    for i in range(t):
        jy, jc = jdec(pn, jnp.asarray(x[:, i:i + 1]), jc)
        ty, tc2 = tssm.ssm_decode(tp, torch.from_numpy(x[:, i:i + 1]), tc,
                                  tcfg)
        assert tc2 is tc                     # updated in place
        _close(ty, jy)
        for k in ("conv", "h"):
            _close(tc[k], jc[k])
        outs.append(ty)
    par = tssm.ssm_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), par.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ssm_decode_bf16_follows_the_references_promotion():
    """bf16 params with the f32 conv window the serving engines default
    to: the window promotes the conv and the ``w_x`` product to f32 in the
    reference, and in the port; sixteen steps, the f32 state at TOL (a
    bf16 rounding of the conv output moves it by ~7e-3), the bf16 output
    at the bf16 tolerance of ``tests/test_kernels_masked_matmul.py``."""
    jcfg, tcfg = _cfgs()
    pn = jax.tree.map(np.asarray, jssm.ssm_init(jax.random.key(1), jcfg,
                                                dtype=jnp.bfloat16))
    tp = params_from_jax(pn, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jdec = jax.jit(lambda p, x, c: jssm.ssm_decode(p, x, c, jcfg))
    jc = jssm.ssm_init_cache(jcfg, 2, jnp.float32)
    tc = tssm.ssm_init_cache(tcfg, 2, torch.float32, "cpu")
    for i in range(16):
        jy, jc = jdec(pn, xj[:, i:i + 1], jc)
        ty, _ = tssm.ssm_decode(tp, x[:, i:i + 1], tc, tcfg)
        assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
        assert tc["conv"].dtype == torch.float32 == tc["h"].dtype
        _close(ty, jy, 2e-2)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])
