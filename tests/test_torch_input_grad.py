"""The units' backward builds only the gradients autograd reads.

The reference differentiates by tracing: its trace counts every dispatch
of a unit's backward, and XLA then drops the ones whose result nothing
reads (the image's gradient, a frozen weight's).  The port runs eagerly,
so its units read ``ctx.needs_input_grad``: such a dispatch is counted
under the reference's keys (``stats.counts()`` stays equal) and also in
``stats.elided()``, and nothing of it is built or launched.  With the image
requiring grad, the first conv's dX runs and matches the reference's
``jax.grad`` with respect to the image.  Both packages take the same
numpy params and batch; the reference runs its Pallas kernels in
interpret mode, jitted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.core.sparse_linear import matmul as jmatmul
from repro.core.sparse_linear import relu_matmul as jrelu_matmul
from repro.kernels import stats as jstats
from repro.models.cnn import build_cnn as jbuild
from repro_torch.core import policy as tpol
from repro_torch.core.sparse_linear import matmul as tmatmul
from repro_torch.core.sparse_linear import relu_matmul as trelu_matmul
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats
from repro_torch.models.cnn import build_cnn as tbuild
from repro_torch.models.cnn import param_leaves, params_from_jax

GEOM = dict(image_size=32, width=0.125, num_classes=10)
BLOCK = (32, 32, 32)
# The first conv's dX under IN_OUT_WR: a compact dispatch (its queue
# built first) whose epilogue would emit the image gradient's bitmap.
VGG16_ELIDED = {"gemm:compact:1": 1, "emit:grad": 1, "queue:prefix_sum": 1}


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


@pytest.fixture
def dispatches(monkeypatch):
    """The masked-GEMM dispatches the port actually ran, by stats key."""
    ran = {}
    real = tops._dispatch

    def counted(a, b, masks, spec, mult):
        ran[spec.stats_key] = ran.get(spec.stats_key, 0) + 1
        return real(a, b, masks, spec, mult)

    monkeypatch.setattr(tops, "_dispatch", counted)
    return ran


def _ran_equals_counts_minus_elided(ran):
    c, e = tstats.counts(), tstats.elided()
    want = {k: c[k] - e.get(k, 0) for k in c if k.startswith("gemm:")}
    assert ran == {k: v for k, v in want.items() if v}


@pytest.fixture(scope="module")
def vgg16_case():
    """The reference's loss, its gradients with respect to the params and
    the image, and its trace's count dict, on one numpy batch."""
    jm = jbuild("vgg16", **GEOM)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    rng = np.random.default_rng(1)
    jparams = {layer: {k: jnp.asarray(rng.standard_normal(v.shape).astype(
                           np.float32) * (2.0 / np.prod(v.shape[:-1])) ** 0.5)
                       for k, v in leaves.items()}
               for layer, leaves in shapes.items()}
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    lbl = np.asarray([3, 7], np.int32)
    jp = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)
    jstats.reset()
    loss, (gp, gx) = jax.jit(jax.value_and_grad(
        lambda p, x: jm.loss(p, x, jnp.asarray(lbl), jp), argnums=(0, 1)))(
        jparams, jnp.asarray(img))
    counts = jstats.counts()
    jstats.reset()
    return {"params": jax.tree.map(np.asarray, jparams), "img": img,
            "lbl": lbl, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, gp), "dx": np.asarray(gx),
            "counts": counts}


def _port_step(case, image_grad: bool):
    tm = tbuild("vgg16", **GEOM)
    tparams = params_from_jax(case["params"], "cpu")
    leaves = param_leaves(tparams)
    img = torch.tensor(case["img"]).requires_grad_(image_grad)
    tp = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)
    tstats.reset()
    loss = tm.loss(tparams, img, torch.tensor(case["lbl"]), tp)
    wrt = list(leaves.values()) + ([img] if image_grad else [])
    grads = torch.autograd.grad(loss, wrt)
    return float(loss.detach()), dict(zip(leaves, grads)), \
        (grads[-1] if image_grad else None)


def test_vgg16_counts_equal_the_reference_with_the_dx_elided(vgg16_case,
                                                             dispatches):
    loss, grads, _ = _port_step(vgg16_case, image_grad=False)
    assert tstats.counts() == vgg16_case["counts"]
    assert tstats.elided() == VGG16_ELIDED
    _ran_equals_counts_minus_elided(dispatches)
    np.testing.assert_allclose(loss, vgg16_case["loss"], rtol=1e-5)
    for name, g in grads.items():
        layer, leaf = name.split("/")
        want = vgg16_case["grads"][layer][leaf]
        assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max(), \
            name


def test_vgg16_param_grads_unchanged_by_the_elision(vgg16_case):
    loss, grads, _ = _port_step(vgg16_case, image_grad=False)
    loss_x, grads_x, _ = _port_step(vgg16_case, image_grad=True)
    assert loss == loss_x
    for name, g in grads.items():
        assert torch.equal(g, grads_x[name]), name


def test_vgg16_image_gradient_matches_the_reference(vgg16_case, dispatches):
    _, _, dx = _port_step(vgg16_case, image_grad=True)
    assert tstats.counts() == vgg16_case["counts"]
    assert tstats.elided() == {}
    _ran_equals_counts_minus_elided(dispatches)
    want = vgg16_case["dx"]
    assert dx.shape == want.shape
    assert np.abs(dx.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# Two dense layers: which leaf is frozen decides which GEMM is elided
# ---------------------------------------------------------------------------

LIN_BLOCK = (8, 8, 8)


def _linear_case(rng):
    x = (rng.standard_normal((24, 20))
         * (rng.random((24, 20)) > 0.4)).astype(np.float32)
    w1 = rng.standard_normal((20, 16)).astype(np.float32) / 4
    w2 = rng.standard_normal((16, 12)).astype(np.float32) / 4
    return [x, w1, w2]


@pytest.mark.parametrize("first,wants", [
    ("relu_matmul", (False, True, True)), ("relu_matmul", (True, True, True)),
    ("relu_matmul", (True, True, False)), ("relu_matmul", (False, False, True)),
    ("matmul", (False, True, True)), ("matmul", (True, False, True))])
def test_two_layer_units_build_only_what_autograd_reads(first, wants,
                                                        dispatches):
    """``wants`` says which of (x, w1, w2) require grad.  The counts equal
    the reference's trace, ``elided`` names the GEMM of each leaf not
    asked for (a frozen weight's dW is never built), the gradients asked
    for equal the reference's at 1e-5."""
    arrays = _linear_case(np.random.default_rng(3))
    jp = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=LIN_BLOCK)
    tp = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=LIN_BLOCK)
    j_first = jrelu_matmul if first == "relu_matmul" else jmatmul
    t_first = trelu_matmul if first == "relu_matmul" else tmatmul
    argnums = tuple(i for i, w in enumerate(wants) if w)

    def jloss(*v):
        return (jrelu_matmul(j_first(v[0], v[1], jp), v[2], jp) ** 2).sum()

    jgrads = jax.jit(jax.grad(jloss, argnums=argnums))(
        *map(jnp.asarray, arrays))
    jc = jstats.counts()

    ts = [torch.tensor(a).requires_grad_(w) for a, w in zip(arrays, wants)]
    loss = (trelu_matmul(t_first(ts[0], ts[1], tp), ts[2], tp) ** 2).sum()
    tgrads = torch.autograd.grad(loss, [ts[i] for i in argnums])
    assert tstats.counts() == jc
    elided = tstats.elided()
    # The first layer's backward runs only if x or w1 requires grad, and
    # then elides the GEMM of the one that does not; the second layer's
    # elides its dX when neither does, its dW when w2 is frozen.
    x_or_w1 = wants[0] or wants[1]
    n_elided = (x_or_w1 and not wants[0]) + (x_or_w1 and not wants[1]) \
        + (not x_or_w1) + (not wants[2])
    assert sum(v for k, v in elided.items()
               if k.startswith("gemm:")) == n_elided
    _ran_equals_counts_minus_elided(dispatches)
    for g, want in zip(tgrads, jgrads):
        want = np.asarray(want)
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_frozen_weight_leaves_dw_unbuilt(monkeypatch):
    """A frozen weight's WG GEMM is counted, never built: no operand of
    it reaches the dispatcher."""
    arrays = _linear_case(np.random.default_rng(4))
    tp = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=LIN_BLOCK)
    shapes = []
    real = tops.sparse_gemm

    def seen(a, b, *args, **kw):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(tops, "sparse_gemm", seen)
    x, w1, w2 = (torch.tensor(a) for a in arrays)
    x.requires_grad_(True)
    w2.requires_grad_(True)
    loss = (trelu_matmul(trelu_matmul(x, w1, tp), w2, tp) ** 2).sum()
    gx, g2 = torch.autograd.grad(loss, [x, w2])
    # forward: two GEMMs; backward: the second layer's dX and dW, the
    # first layer's dX — never the first layer's dW, (20, 24) @ (24, 16)
    assert sorted(shapes[2:]) == sorted([((24, 12), (12, 16)),
                                         ((16, 24), (24, 12)),
                                         ((24, 16), (16, 20))])
    assert tstats.elided() == {"gemm:compact:1": 1, "queue:prefix_sum": 1}
    assert tuple(gx.shape) == (24, 20) and tuple(g2.shape) == (16, 12)


def test_autotuned_elided_dispatch_is_observed_as_in_an_eager_reference():
    """With ``autotune=True`` the reference's eager step runs and observes
    the dispatch the port elides; the port observes its masks all the
    same, so both caches decide alike, step after step."""
    from repro.kernels import autotune as jat
    from repro_torch.kernels import autotune as tat
    arrays = _linear_case(np.random.default_rng(5))
    jp = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=LIN_BLOCK,
                              autotune=True)
    tp = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=LIN_BLOCK,
                              autotune=True)

    def jloss(w1, w2):
        x = jnp.asarray(arrays[0])
        return (jrelu_matmul(jrelu_matmul(x, w1, jp), w2, jp) ** 2).sum()

    jat.reset(window=4, min_samples=2)
    tat.reset(window=4, min_samples=2)
    try:
        for _ in range(3):
            jax.grad(jloss, argnums=(0, 1))(*map(jnp.asarray, arrays[1:]))
            w1, w2 = (torch.tensor(a).requires_grad_(True)
                      for a in arrays[1:])
            x = torch.tensor(arrays[0])
            loss = (trelu_matmul(trelu_matmul(x, w1, tp), w2, tp) ** 2).sum()
            torch.autograd.grad(loss, [w1, w2])
        assert sum(v for k, v in tstats.elided().items()
                   if k.startswith("gemm:")) == 3
        assert tat.log_rows() == jat.log_rows()
        assert sorted(tstats.live_tile_keys()) == \
            sorted(jstats.live_tile_keys())
        for key in jstats.live_tile_keys():
            assert tstats.live_tile_stats(key) == jstats.live_tile_stats(key)
    finally:
        jat.reset()
        tat.reset()
