"""The port's FFN block and the shared building blocks of
``models/common.py`` against the JAX package's.

The reference's weights are carried across; forward and gradients match at
1e-5 with EQUAL count dicts: ``relu`` and ``relu2`` under a sparse policy
(the fused ``act_matmul`` unit through the kernels' plain versions against
the reference's Pallas kernels in interpret mode), ``gelu`` and
``silu_glu`` dense.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro_torch.core import policy as tpol
from repro_torch.kernels import stats as tstats
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _policy(pkg, scenario):
    if scenario is None:
        return None
    return pkg.SCENARIOS[scenario].with_(kernel_impl="pallas",
                                         block=(8, 8, 8))


@pytest.mark.parametrize("activation,scenario", [
    ("relu", "IN_OUT_WR"), ("relu", "IN_OUT"), ("relu2", "IN_OUT_WR"),
    ("relu", None), ("gelu", None), ("silu_glu", None), ("gelu_glu", None),
])
def test_ffn_forward_and_grads_match_reference(activation, scenario):
    d_model, d_ff = 16, 40
    jcfg = jffn.FFNConfig(d_model, d_ff, activation,
                          sparse_policy=_policy(jpol, scenario))
    tcfg = tffn.FFNConfig(d_model, d_ff, activation,
                          sparse_policy=_policy(tpol, scenario))
    jparams = jax.tree.map(np.asarray, jffn.ffn_init(jax.random.key(1), jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, d_model)).astype(np.float32)
    yt = rng.standard_normal((3, 11, d_model)).astype(np.float32)

    def jloss(p):
        return jnp.mean((jffn.ffn_apply(p, jnp.asarray(x), jcfg)
                         - jnp.asarray(yt)) ** 2)

    jstats.reset()
    jy = jffn.ffn_apply(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x),
                        jcfg)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jparams))
    jc = jstats.counts()

    tparams = {k: torch.tensor(v).requires_grad_(True)
               for k, v in jparams.items()}
    tstats.reset()
    ty = tffn.ffn_apply(tparams, torch.tensor(x), tcfg)
    tl = ((tffn.ffn_apply(tparams, torch.tensor(x), tcfg)
           - torch.tensor(yt)) ** 2).mean()
    tg = torch.autograd.grad(tl, list(tparams.values()))
    tc = tstats.counts()

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for name, g in zip(tparams, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert tc == jc
    if scenario is not None:
        sched = "compact" if scenario == "IN_OUT_WR" else "predicated"
        # two forwards of two GEMMs each, one backward of four
        assert tc[f"gemm:{sched}:1"] == 2 * 2 + 4
        assert tc["encode:act"] == 2


def test_ffn_init_shapes_and_device():
    cfg = tffn.FFNConfig(8, 24, "silu_glu")
    p = tffn.ffn_init(0, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_gate": (8, 24), "w_up": (8, 24), "w_down": (24, 8)}
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in p.values())
    std = float(torch.cat([v.detach().flatten() for k, v in p.items()
                           if k != "w_down"]).std())
    assert abs(std - 8 ** -0.5) < 0.05
    q = tffn.ffn_init(0, tffn.FFNConfig(8, 24, "relu"), device="cpu")
    assert set(q) == {"w_up", "w_down"}


@pytest.mark.parametrize("name", ["relu", "relu2", "gelu", "silu"])
def test_activation_fn_matches_reference(name):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        tcommon.activation_fn(name)(torch.tensor(x)).numpy(),
        np.asarray(jcommon.activation_fn(name)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32) * 3 + 1
    jinit, japply = jcommon.make_norm(kind)
    tinit, tapply = tcommon.make_norm(kind)
    jp = jax.tree.map(np.asarray, jinit(32))
    jp = {k: v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tinit(32).items()} == \
        {k: v.shape for k, v in jp.items()}
    np.testing.assert_allclose(
        tapply({k: torch.tensor(v) for k, v in jp.items()},
               torch.tensor(x)).numpy(),
        np.asarray(japply({k: jnp.asarray(v) for k, v in jp.items()},
                          jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tcommon.make_norm("batchnorm")


def test_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(tcommon.rope_freqs(8).numpy(),
                               np.asarray(jcommon.rope_freqs(8)), rtol=1e-6)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e4)), rtol=1e-5, atol=1e-5)


def test_initializers_and_dtypes():
    gen = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(gen, 64, 32, scale=2.0)
    assert w.shape == (64, 32) and abs(float(w.std()) - 0.25) < 0.02
    e = tcommon.embed_init(gen, 100, 16, dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std())
                                             - 0.02) < 0.003
    assert [tcommon.dtype_of(n) for n in ("float32", "bfloat16",
                                          "float16")] == \
        [torch.float32, torch.bfloat16, torch.float16]
