"""The port's VGG16 training step against the JAX reference, on the CPU.

Both packages take the same parameters (carried over by
``params_from_jax``) and the same numpy batch at the VGG16 smoke geometry
(image 8, width 0.0625, batch 2; the geometry of
tests/test_bitmap_threading.py), under ``IN_OUT_WR`` and ``IN_OUT`` with
``kernel_impl="pallas"`` and block (8, 16, 8); the reference runs its
Pallas kernels in interpret mode.  The loss matches at rtol 1e-5; each
gradient leaf at max|Δ| ≤ 1e-4·max|g| (fourteen layers sum in a different
order); the stats count dicts must be EQUAL, which pins ``registry:hit``
and so catches a silent hand-off miss in torch autograd.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.models.cnn import build_cnn as jbuild
from repro_torch.cnn_training import train_steps
from repro_torch.core import policy as tpol
from repro_torch.data.pipeline import image_batch
from repro_torch.kernels import stats as tstats
from repro_torch.models.cnn import build_cnn as tbuild
from repro_torch.models.cnn import param_leaves, params_from_jax

BLOCK = (8, 16, 8)
GEOM = dict(image_size=8, width=0.0625, num_classes=10)


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _jax_params():
    """A JAX-shaped VGG16 param tree (the tree ``CNNModel.init`` builds,
    from ``jax.eval_shape``, so nothing is compiled), filled from numpy."""
    shapes = jax.eval_shape(jbuild("vgg16", **GEOM).init, jax.random.key(0))
    rng = np.random.default_rng(1)
    return {layer: {k: jnp.asarray(rng.standard_normal(v.shape).astype(
                        np.float32) * (2.0 / np.prod(v.shape[:-1])) ** 0.5)
                    for k, v in leaves.items()}
            for layer, leaves in shapes.items()}


def test_params_from_jax_round_trip():
    jparams = _jax_params()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert set(tparams) == set(jparams)
    for layer, leaves in jparams.items():
        assert set(tparams[layer]) == set(leaves)
        for k, v in leaves.items():
            t = tparams[layer][k]
            assert t.dtype == torch.float32 and t.requires_grad
            np.testing.assert_array_equal(t.detach().numpy(), np.asarray(v))
    # the port's own init builds the same tree, shape for shape
    own = tbuild("vgg16", **GEOM).init(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in param_leaves(own).items()} == \
        {k: tuple(v.shape) for k, v in param_leaves(tparams).items()}


@pytest.mark.parametrize("scenario", ["IN_OUT_WR", "IN_OUT"])
def test_vgg16_step_matches_reference(scenario):
    jp = jpol.SCENARIOS[scenario].with_(kernel_impl="pallas", block=BLOCK)
    tp = tpol.SCENARIOS[scenario].with_(kernel_impl="pallas", block=BLOCK)
    jm = jbuild("vgg16", **GEOM)
    jparams = _jax_params()
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    img -= img.mean(axis=(1, 2, 3), keepdims=True)
    lbl = np.asarray([3, 7], np.int32)

    jstats.reset()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(img), jnp.asarray(lbl), jp)))(jparams)
    jc = jstats.counts()

    tm = tbuild("vgg16", **GEOM)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = param_leaves(tparams)
    tstats.reset()
    tloss = tm.loss(tparams, torch.tensor(img), torch.tensor(lbl), tp)
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))
    tc = tstats.counts()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for (name, _), g in zip(leaves.items(), tgrads):
        layer, leaf = name.split("/")
        want = np.asarray(jgrads[layer][leaf])
        assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max(), \
            name
    assert tc == jc
    # the step's contract: one encode per fused activation, a dy bitmap
    # emitted by every dX GEMM, hand-offs wherever two convs are adjacent
    assert tc["encode:act"] == 8 and tc["registry:hit"] == 8
    assert tc["emit:grad"] >= 1
    assert not any(k.startswith("scan") for k in tc)
    if scenario == "IN_OUT_WR":
        assert tc["queue:prefix_sum"] == tc["gemm:compact:1"]


def test_train_steps_on_cpu_is_deterministic_and_finite():
    kw = dict(net="vgg16", steps=2, batch=2, device="cpu", **GEOM)
    a = train_steps(**kw)
    b = train_steps(**kw)
    la = [r["loss"] for r in a["steps"]]
    assert la == [r["loss"] for r in b["steps"]]
    assert all(np.isfinite(la))
    # no kernel launches on the CPU: the wrappers ran their plain versions
    assert all(not r["launches"] for r in a["steps"])
    assert a["steps"][0]["counts"]["encode:act"] == 8


def test_train_steps_relu_live_fractions_are_outside_the_step():
    kw = dict(net="vgg16", steps=2, batch=2, device="cpu", **GEOM)
    plain = train_steps(**kw)
    live = train_steps(relu_live=True, **kw)
    assert [r["loss"] for r in live["steps"]] == \
        [r["loss"] for r in plain["steps"]]
    for rec, ref in zip(live["steps"], plain["steps"]):
        assert rec["counts"] == ref["counts"]      # not counted in the step
        assert list(rec["relu_live"]) == [f"conv{i}" for i in range(1, 14)]
        assert all(0.0 <= v <= 1.0 for v in rec["relu_live"].values())
    # the first step's fractions are those of the initial weights
    model = tbuild("vgg16", **GEOM)
    params = model.init(0, device="cpu")
    img, _ = image_batch(0, 0, batch=2, image_size=8, num_classes=10,
                         device="cpu")
    caps = {}
    with torch.no_grad():
        model.apply(params, img, tpol.DC, capture=caps)
    assert live["steps"][0]["relu_live"] == {
        k: float(torch.count_nonzero(v)) / v.numel() for k, v in caps.items()}


def test_layer_ranges_cover_forward_and_backward():
    """Each layer's backward reopens its ``layer:<name>`` profiler range, so
    a trace keys both passes of every layer to one name."""
    from torch.profiler import ProfilerActivity, profile

    model = tbuild("vgg16", **GEOM)
    params = model.init(0, device="cpu")
    img, lbl = image_batch(0, 0, batch=2, image_size=8, num_classes=10,
                           device="cpu")
    pol = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = model.loss(params, img, lbl, pol)
        torch.autograd.grad(loss, list(param_leaves(params).values()))
    ranges = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("layer:")}
    assert ranges == {f"layer:{name}": 2 for name in params}


def test_trace_summary_keys_device_work_to_the_launching_layer():
    from repro_torch.profile_step import summarize_trace

    def rng(name, tid, ts, dur):
        return {"cat": "user_annotation", "name": f"layer:{name}",
                "tid": tid, "ts": ts, "dur": dur}

    def launch(corr, tid, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(name, corr, dur, cat="kernel"):
        return {"cat": cat, "name": name, "tid": 7, "ts": 1000 + corr,
                "dur": dur, "args": {"correlation": corr}}

    # conv1's forward on thread 1, its backward on thread 2, conv2 nested
    # inside an outer range, and one launch outside every range
    events = [rng("conv1", 1, 0, 10), rng("outer", 1, 20, 30),
              rng("conv2", 1, 25, 5), rng("conv1", 2, 100, 10),
              launch(1, 1, 5), launch(2, 1, 27), launch(3, 1, 45),
              launch(4, 2, 105), launch(5, 1, 60),
              kernel("gemm", 1, 1000), kernel("gemm", 2, 2000),
              kernel("copy", 3, 500, "gpu_memcpy"), kernel("gemm", 4, 4000),
              kernel("fill", 5, 250)]
    res = summarize_trace(events)
    assert dict(res["layers"]) == {"conv1": 5.0, "conv2": 2.0, "outer": 0.5,
                                   "(no layer)": 0.25}
    assert res["kernels"][0] == ("gemm", 7.0, 3)
    assert res["busy_ms"] == 7.75
    assert res["longest"][:2] == [("gemm", "conv1", 4.0, None),
                                  ("gemm", "conv2", 2.0, None)]
    assert [(r[0], r[1]) for r in res["in_order"]] == [
        ("gemm", "conv1"), ("gemm", "conv2"), ("copy", "outer"),
        ("gemm", "conv1"), ("fill", "(no layer)")]


def test_image_batch_is_deterministic():
    a = image_batch(3, 5, batch=4, image_size=16, num_classes=10,
                    device="cpu")
    b = image_batch(3, 5, batch=4, image_size=16, num_classes=10,
                    device="cpu")
    c = image_batch(3, 6, batch=4, image_size=16, num_classes=10,
                    device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (4, 16, 16, 3) and a[1].shape == (4,)
    assert float(a[0].mean(dim=(1, 2, 3)).abs().max()) < 1e-5
