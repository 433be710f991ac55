"""The port's MobileNet and ResNet-18 training steps against the JAX
reference, on the CPU (GoogLeNet and DenseNet-121 are in
tests/test_torch_networks.py, so that each file's run stays short).

Both packages build the same ``CNNModel`` and take the same parameters
(the reference's own init, carried over by ``params_from_jax``) and the
same numpy batch, with ``kernel_impl="pallas"``; the reference is jitted
and runs its Pallas kernels in interpret mode.  The loss matches at rtol
1e-5, each gradient leaf at max|Δ| ≤ 1e-4·max|g|, and the stats count
dicts must be EQUAL.

The BN scale and bias are drawn off the init's (1, 0).  There, ReLU's
positive homogeneity makes a BN scale that feeds ReLU → depthwise conv → BN
(conv0 and every pw layer of MobileNet) have an exactly zero gradient, and
the f32 value both packages compute for it is rounding noise: the
reference's own dense step is 1e-2·max|g| off a float64 step there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.models import cnn as jcnn
from repro_torch.core import policy as tpol
from repro_torch.kernels import stats as tstats
from repro_torch.models import cnn as tcnn
from repro_torch.models.cnn import param_leaves, params_from_jax


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def step_both(jm, tm, scenario, block, scan=False, image=8):
    """One loss + gradient in both packages; returns the count dicts after
    checking the loss and every gradient leaf."""
    kw = dict(kernel_impl="pallas", block=block, scan_signed_inputs=scan)
    jp = jpol.SCENARIOS[scenario].with_(**kw)
    tp = tpol.SCENARIOS[scenario].with_(**kw)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    for leaves in jparams.values():
        for name, sd in (("bn_scale", 0.2), ("bn_bias", 0.5)):
            if name in leaves:
                leaves[name] = leaves[name] + sd * rng.standard_normal(
                    leaves[name].shape).astype(np.float32)
    img = rng.standard_normal((2, image, image, 3)).astype(np.float32)
    img -= img.mean(axis=(1, 2, 3), keepdims=True)
    lbl = np.asarray([3, 7], np.int32)

    jstats.reset()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jnp.asarray(img), jnp.asarray(lbl), jp)))(
        jax.tree.map(jnp.asarray, jparams))
    jc = jstats.counts()

    tparams = params_from_jax(jparams, "cpu")
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
    return tc


@pytest.mark.parametrize("scenario,scan", [("IN_OUT_WR", True),
                                           ("IN_OUT", False)])
def test_truncated_mobilenet_step_matches_reference(scenario, scan):
    """conv0, dw1, pw1, dw2, pw2 at width 0.0625: two grouped layers (2
    and 4 groups), BN after every conv, the signed image and head input."""
    def model(pkg):
        return pkg.CNNModel("mobilenet", pkg.mobilenet_layers(0.0625)[:5],
                            num_classes=10, image_size=8)

    counts = step_both(model(jcnn), model(tcnn), scenario, (8, 8, 8),
                       scan=scan)
    sched = "compact" if scenario == "IN_OUT_WR" else "predicated"
    want = {"encode:act": 4, f"gemm:{sched}:2": 3, f"gemm:{sched}:4": 3,
            "registry:miss": 6, "emit:grad": 6}
    if scan:
        want["scan_pallas:act"] = 2
    assert {k: counts.get(k) for k in want} == want
    assert counts[f"gemm:{sched}:1"] == 12     # conv0, pw1, pw2, head


@pytest.mark.parametrize("net", ["resnet18"])
def test_other_networks_step_matches_reference(net):
    """The other ``groups == 1`` networks at the VGG16 smoke geometry
    (image 8, width 0.0625, batch 2, block (8, 16, 8)), IN_OUT_WR."""
    geom = dict(image_size=8, width=0.0625, num_classes=10)
    counts = step_both(jcnn.build_cnn(net, **geom),
                       tcnn.build_cnn(net, **geom), "IN_OUT_WR", (8, 16, 8))
    assert counts["queue:prefix_sum"] == sum(
        v for k, v in counts.items() if k.startswith("gemm:compact:"))
    assert not any(k.startswith("scan") for k in counts)


def test_depthwise_node_with_channel_multiplier_takes_counted_fallback():
    """A depthwise node whose weights do not match its input's channels
    (here a channel multiplier of 2) leaves the sparse engine through the
    counted ``conv:dense_fallback`` escape, as in the reference."""
    node = tcnn.ConvNode("dw", 0, 3, stride=2, depthwise=True)
    jnode = jcnn.ConvNode("dw", 0, 3, stride=2, depthwise=True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 7, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 8)).astype(np.float32)
    jp = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    tp = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    for relu in (True, False):
        jstats.reset()
        tstats.reset()
        want = jcnn.apply_conv({"w": jnp.asarray(w)}, jnp.asarray(x), jnode,
                               jp, relu)
        got = tcnn.apply_conv({"w": torch.tensor(w)}, torch.tensor(x), node,
                              tp, relu)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert tstats.counts() == jstats.counts() == \
            {"conv:dense_fallback": 1}
