"""The port's AdamW against the JAX package's: ``adamw_update`` over three
steps on the same gradients, with clipping, a loss scale and one non-finite
step (skipped, counted under ``guard:nonfinite_skip`` with no host read),
at 1e-6; ``cosine_lr`` at a few steps; the reference's own optimizer cases
on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.optim import optimizer as jopt
from repro_torch import tree as ttree
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.optim import optimizer as topt

TOL = 1e-6


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


def _params():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"b0": {"s": rng.standard_normal((2, 5))
                              .astype(np.float32)}},
            "bias": rng.standard_normal((5,)).astype(np.float32)}


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                     .astype(np.float32), _params())
    if step == 1:                       # the non-finite step
        g["w"][2, 3] = np.inf
    return g


def _t(tree):
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                          tree)


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert float(np.abs(got - want).max()) <= \
        tol * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("loss_scale", [0.0, 128.0])
def test_adamw_update_matches_reference(loss_scale):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
              grad_clip=1.0, loss_scale=loss_scale, emit_guard_stats=True)
    jcfg, tcfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, _params())
    js = jopt.adamw_init(jp)
    tp = _t(_params())
    ts = topt.adamw_init(tp)
    # clipping: the first step's norm is well above grad_clip
    scale = 3.0 * max(loss_scale, 1.0)
    for step in range(3):
        g = _grads(step, scale)
        jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                       jcfg)
        tp, ts, tm = topt.adamw_update(_t(g), ts, tp, tcfg)
        jax.effects_barrier()
        for k in ("grad_norm", "lr", "skipped"):
            w = float(jm[k])
            if np.isfinite(w):
                assert abs(float(tm[k]) - w) <= TOL * max(abs(w), 1e-6), k
            else:
                assert not np.isfinite(float(tm[k]))
        assert float(tm["skipped"]) == (1.0 if step == 1 else 0.0)
        assert int(ts["step"]) == int(js["step"])
    for got, want in zip(ttree.leaves(tp), jax.tree.leaves(jp)):
        _close(got, want)
    for got, want in zip(ttree.leaves(ts), jax.tree.leaves(js)):
        _close(got, want)
    assert tstats.guard_counts() == jstats.guard_counts() \
        == {"guard:nonfinite_skip": 1}


def test_skip_is_counted_on_the_device_without_a_read():
    """The skip flag is added into a pending device counter; nothing is
    folded until the counts are read."""
    tp = _t(_params())
    ts = topt.adamw_init(tp)
    cfg = topt.OptConfig(emit_guard_stats=True)
    topt.adamw_update(_t(_grads(1, 1.0)), ts, tp, cfg)
    assert tstats._PENDING and not tstats._COUNTS
    assert tstats.guard_counts() == {"guard:nonfinite_skip": 1}
    prev = tstats.set_runtime_counting(False)
    try:
        topt.adamw_update(_t(_grads(1, 1.0)), ts, tp, cfg)
    finally:
        tstats.set_runtime_counting(prev)
    assert tstats.guard_counts() == {"guard:nonfinite_skip": 1}


@pytest.mark.parametrize("step", [0, 1, 5, 50, 100, 600, 1000, 1500])
def test_cosine_lr_matches_reference(step):
    cfg = dict(learning_rate=3e-4, warmup_steps=100, total_steps=1000)
    want = float(jopt.cosine_lr(jnp.int32(step), jopt.OptConfig(**cfg)))
    got = float(topt.cosine_lr(torch.tensor(step, dtype=torch.int32),
                               topt.OptConfig(**cfg)))
    assert abs(got - want) <= TOL * max(want, 1e-12)


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    p = {"w": torch.zeros(3)}
    st = topt.adamw_init(p)
    cfg = topt.OptConfig(learning_rate=0.1, warmup_steps=1,
                         total_steps=200, weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2 * (p["w"] - target)}
        p, st, _ = topt.adamw_update(g, st, p, cfg)
    assert float((p["w"] - target).abs().max()) < 0.05


def test_master_weights_are_copied_not_aliased():
    p = {"w": torch.ones(4)}
    st = topt.adamw_init(p)
    assert st["master"]["w"].data_ptr() != p["w"].data_ptr()
    pb = {"w": torch.ones(4, dtype=torch.bfloat16)}
    stb = topt.adamw_init(pb)
    assert stb["master"]["w"].dtype == torch.float32
    new, _, _ = topt.adamw_update({"w": torch.full((4,), 1e-3)}, stb, pb,
                                  topt.OptConfig(learning_rate=1e-4))
    assert new["w"].dtype == torch.bfloat16
