"""The port's cost model, WDU and their bridge from the CNN models against
the JAX package's.

``core/costmodel.py`` and ``core/workredist.py`` are the same numpy in both
packages, so "equal" means ``==``:
every case of tests/test_costmodel.py runs on the port's modules, and the
quantities those cases read are compared across the two packages.  The
bridge (``conv_specs``, ``gemm_workload``) and ``GemmSpec.launch_geometry``
give equal rows for all five networks.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_costmodel as ref_cases
from repro.core import costmodel as jcm
from repro.core import policy as jpol
from repro.core import workredist as jwr
from repro.kernels import stats as jstats
from repro.models import cnn as jcnn
from repro_torch.core import costmodel as tcm
from repro_torch.core import policy as tpol
from repro_torch.core import workredist as twr
from repro_torch.kernels import stats as tstats
from repro_torch.models import cnn as tcnn


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


CASES = sorted(n for n in dir(ref_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", CASES)
def test_reference_case_holds_on_the_port(case, monkeypatch):
    """Each case of the reference's cost-model tests, run on the port's
    ``costmodel`` and ``workredist``."""
    monkeypatch.setattr(ref_cases, "cm", tcm)
    monkeypatch.setattr(ref_cases, "wr", twr)
    fn = getattr(ref_cases, case)
    if case == "test_wdu_invariants_hold_across_knobs":
        for threshold, split in ((0.3, 0.5), (0.0, 0.5), (0.3, 1.0),
                                 (1.0, 0.5)):
            fn(threshold, split)
    else:
        fn()


def _spec(pkg, **kw):
    base = dict(name="l", c=128, h=28, w=28, m=128, r=3, s=3, batch=16)
    base.update(kw)
    return pkg.ConvSpec(**base)


def _trace(pkg, x=0.5, g=0.5, o=0.5, seed=0):
    rng = np.random.default_rng(seed)
    return pkg.LayerTrace(x_density=x, g_in_density=g, out_mask_density=o,
                          bp_active_map=0.5 + 0.15 * rng.random((28, 28)),
                          fp_active_map=0.5 + 0.15 * rng.random((28, 28)))


def _flat(obj):
    """A dataclass tree as a flat dict of numbers (arrays as lists)."""
    if dataclasses.is_dataclass(obj):
        return {k: _flat(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _flat(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


SPEC_CASES = [dict(), dict(has_bn=True), dict(input_is_relu=False),
              dict(groups=128, m=128), dict(r=1, s=1, c=2048),
              dict(stride=2, output_feeds_relu=False)]


@pytest.mark.parametrize("kw", SPEC_CASES, ids=str)
@pytest.mark.parametrize("scenario", ["DC", "IN", "IN_OUT", "IN_OUT_WR"])
@pytest.mark.parametrize("mode", ["none", "direct", "hierarchical"])
def test_layer_cost_equal(kw, scenario, mode):
    want = jcm.layer_cost(_spec(jcm, **kw), _trace(jcm), scenario,
                          reconfig_mode=mode)
    got = tcm.layer_cost(_spec(tcm, **kw), _trace(tcm), scenario,
                         reconfig_mode=mode)
    assert _flat(got) == _flat(want)
    assert got.total_cycles == want.total_cycles
    assert got.total_energy == want.total_energy
    assert got.bp.time_s == want.bp.time_s


@pytest.mark.parametrize("scenario", ["DC", "IN", "IN_OUT", "IN_OUT_WR"])
def test_network_cost_equal(scenario):
    specs = [dict(name=f"l{i}") for i in range(3)]
    want = jcm.network_cost([_spec(jcm, **s) for s in specs],
                            [_trace(jcm, seed=i) for i in range(3)],
                            scenario)
    got = tcm.network_cost([_spec(tcm, **s) for s in specs],
                           [_trace(tcm, seed=i) for i in range(3)],
                           scenario)
    assert got == want


@pytest.mark.parametrize("crs", [1, 9, 64, 576, 1000, 1024, 1536, 2048,
                                 100352])
def test_lane_utilization_equal(crs):
    for mode in ("none", "direct", "hierarchical"):
        assert tcm.lane_utilization(crs, tcm.DEFAULT_HW, mode) == \
            jcm.lane_utilization(crs, jcm.DEFAULT_HW, mode)
    assert tcm.DEFAULT_HW == tcm.HwConfig()
    assert dataclasses.asdict(tcm.DEFAULT_HW) == \
        dataclasses.asdict(jcm.DEFAULT_HW)


@pytest.mark.parametrize("kw", [dict(), dict(redistribute=False),
                                dict(threshold=0.9), dict(threshold=1.0),
                                dict(split=1.0), dict(threshold=0.0)],
                         ids=str)
@pytest.mark.parametrize("n,seed", [(256, 0), (64, 5), (32, 6), (1, 1)])
def test_wdu_simulate_equal(kw, n, seed):
    work = np.random.default_rng(seed).gamma(2.0, 100.0, n)
    assert dataclasses.asdict(twr.simulate(work, **kw)) == \
        dataclasses.asdict(jwr.simulate(work, **kw))
    zero = np.zeros(8)
    assert dataclasses.asdict(twr.simulate(zero, **kw)) == \
        dataclasses.asdict(jwr.simulate(zero, **kw))


@pytest.mark.parametrize("shape,cap", [((9, 7), 0), ((9, 7), 3),
                                       ((1, 1), 0), ((16, 4), 100)])
def test_queue_orders_equal(shape, cap):
    bm = (np.random.default_rng(8).random(shape) > 0.5).astype(np.int32)
    got, want = twr.static_queue_order(bm, cap), \
        jwr.static_queue_order(bm, cap)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert twr.wdu_dispatch_order(bm) == jwr.wdu_dispatch_order(bm)


@pytest.mark.parametrize("hw,tx", [((32, 32), 16), ((7, 7), 16),
                                   ((224, 224), 16), ((28, 13), 8)])
def test_tile_work_equal(hw, tx):
    act = np.random.default_rng(3).random(hw)
    np.testing.assert_array_equal(
        twr.tile_work_from_mask(act, tx, tx, 9.0),
        jwr.tile_work_from_mask(act, tx, tx, 9.0))


# ---------------------------------------------------------------------------
# The bridge from the CNN models
# ---------------------------------------------------------------------------

GEOMS = [(224, 1.0), (32, 0.25)]


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("net", sorted(tcnn.NETWORKS))
def test_conv_specs_and_gemm_workload_equal(net, geom):
    size, width = geom
    jm = jcnn.build_cnn(net, image_size=size, width=width, num_classes=1000)
    tm = tcnn.build_cnn(net, image_size=size, width=width, num_classes=1000)
    for batch in (16, 2):
        js, ts = jm.conv_specs(batch), tm.conv_specs(batch)
        assert [dataclasses.asdict(s) for s in ts] == \
            [dataclasses.asdict(s) for s in js]
        assert [(s.u, s.v, s.crs, s.mrs, s.macs_fp(), s.macs_bp(),
                 s.macs_wg()) for s in ts] == \
            [(s.u, s.v, s.crs, s.mrs, s.macs_fp(), s.macs_bp(),
              s.macs_wg()) for s in js]
        assert tm.gemm_workload(batch) == jm.gemm_workload(batch)


def _launch_workload(pkg_cnn):
    model = pkg_cnn.build_cnn("mobilenet", image_size=8, width=0.25,
                              num_classes=10)
    workload = model.gemm_workload(batch=2)
    workload.append({"layer": "head", "stage": "fp", "groups": 1,
                     "m": 2, "k": workload[-1]["n"], "n": 10})
    return workload


@pytest.mark.parametrize("schedule", ["predicated", "compact", "dense"])
def test_launch_geometry_equal(schedule):
    """Over launch_shape_audit's workload, at the engine's granularities,
    the port's GemmSpec resolves to the reference's launch geometry."""
    from repro.core.sparse_tensor import conv_channel_granularity as jgran
    from repro_torch.core.sparse_tensor import \
        conv_channel_granularity as tgran

    def grans(gran, w, block):
        gc = gran(w["cin"], block, w["groups"])
        gcg = gran(w["cout"], block, w["groups"])
        return {"fp": (1, gc, 1), "bp_dx": (1, gcg, gc),
                "wg": (gc, 1, gcg)}[w["stage"]]

    kw = dict(kernel_impl="pallas", block=(8, 8, 8))
    jp, tp = jpol.IN_OUT_WR.with_(**kw), tpol.IN_OUT_WR.with_(**kw)
    workload = _launch_workload(tcnn)
    assert workload == _launch_workload(jcnn)
    for w in workload:
        g, dims = w["groups"], (w["m"], w["k"], w["n"])
        if g == 1:
            js, ts = jp.gemm_spec(groups=1), tp.gemm_spec(groups=1)
        else:
            js = jp.gemm_spec(groups=g, dims=dims,
                              grans=grans(jgran, w, jp.block))
            ts = tp.gemm_spec(groups=g, dims=dims,
                              grans=grans(tgran, w, tp.block))
        for cap in (None, 3):
            jg = js.with_(schedule=schedule, max_active_blocks=cap) \
                .launch_geometry(*dims)
            tg = ts.with_(schedule=schedule, max_active_blocks=cap) \
                .launch_geometry(*dims)
            assert tg == jg, w
