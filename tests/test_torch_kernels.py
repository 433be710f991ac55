"""The port's kernel layer against the JAX reference, on the CPU.

Each wrapper takes its plain PyTorch version for CPU tensors; these tests
hold those versions (through the port's public wrappers and its
``sparse_gemm`` dispatcher) against ``repro.kernels.ops`` running its Pallas
kernels in interpret mode, on the same numpy inputs.  Bitmaps and queues
must match exactly; f32 outputs to 1e-5, the reference's own tolerance
(tests/test_kernels_masked_matmul.py).  The CUDA kernels themselves run only
on a GPU (tests/test_torch_cuda.py and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import queue_builder as tqueue
from repro_torch.kernels import stats as tstats

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


# ---------------------------------------------------------------------------
# K1 relu_encode
# ---------------------------------------------------------------------------

# (1, 1), (1, 2), (1, 32): MobileNet's depthwise and pointwise inputs;
# (4, 1) a cell of several rows; (37, 29) has N % 4 != 0.
@pytest.mark.parametrize("gran", [(1, 8), (8, 16), (1, 1), (1, 2), (1, 32),
                                  (4, 1)])
@pytest.mark.parametrize("shape", [(37, 29), (64, 48)])
def test_relu_encode_matches_reference(gran, shape):
    z = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jy, jbits = jops.relu_encode(jnp.asarray(z), block=gran)
    ty, tbits = tops.relu_encode(torch.tensor(z), block=gran)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert tstats.counts() == jstats.counts() == {"encode:act": 1}
    assert launch_counts()["relu_encode"] == 0     # CPU: plain version


@pytest.mark.parametrize("gran", [(1, 2), (1, 8), (4, 1), (8, 16)])
def test_relu_encode_nan_cell_matches_reference(gran):
    """A cell holding a NaN next to a positive value: the reference's max
    over the cell carries the NaN and NaN > 0 is false, so its bit is 0;
    the NaN itself passes through the ReLU."""
    z = np.random.default_rng(5).standard_normal((37, 29)).astype(np.float32)
    z[9, 4], z[8, 5] = np.nan, 2.0
    z[20, 17] = np.nan                      # a NaN beside negatives too
    jy, jbits = jops.relu_encode(jnp.asarray(z), block=gran)
    ty, tbits = tops.relu_encode(torch.tensor(z), block=gran)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))   # NaN == NaN
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    gr, gc = gran
    assert int(tbits[9 // gr, 4 // gc]) == 0
    assert int(tbits[20 // gr, 17 // gc]) == 0
    assert np.isnan(ty.numpy()[9, 4])


# encode_plan: the encoder's path from the shape, the cell and the
# alignment alone (csrc/cell_encode.cuh).
ENCODE_PLANS = {
    # (m, n, gran, aligned, ld): (path, lanes per cell, flat)
    "dw2 input (1, 1)": ((100352, 64, (1, 1), True, None),
                         ("quads", 1, True)),
    "(1, 2)": ((100352, 32, (1, 2), True, None), ("quads", 1, True)),
    "image (1, 1), N = 3": ((401408, 3, (1, 1), True, None),
                            ("quads", 1, True)),
    "strided view (1, 1)": ((333, 64, (1, 1), True, 72),
                            ("quads", 1, False)),
    "pw1 input (1, 32)": ((100352, 32, (1, 32), True, None),
                          ("segments", 8, False)),
    "conv2 input (1, 64)": ((401408, 64, (1, 64), True, None),
                            ("segments", 16, False)),
    "conv4 input (1, 128)": ((100352, 128, (1, 128), True, None),
                             ("segments", 32, False)),
    "head (128, 128)": ((8, 1024, (128, 128), True, None),
                        ("warp", 32, False)),
    "ragged (8, 16)": ((333, 29, (8, 16), True, None), ("warp", 32, False)),
    "unaligned (1, 1)": ((100352, 64, (1, 1), False, None),
                         ("thread", 1, False)),
    "unaligned (1, 32)": ((100352, 32, (1, 32), False, None),
                          ("warp", 32, False)),
    "odd row stride (1, 1)": ((333, 64, (1, 1), True, 65),
                              ("thread", 1, False)),
    "(4, 1)": ((64, 48, (4, 1), True, None), ("thread", 1, False)),
}


@pytest.mark.parametrize("case", sorted(ENCODE_PLANS))
def test_encode_plan_picks_the_path(case, monkeypatch):
    from repro_torch.kernels import relu_encode as k1

    (m, n, gran, aligned, ld), want = ENCODE_PLANS[case]

    def no_device(*_a, **_k):
        raise AssertionError("encode_plan asked the device")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    plan = k1.encode_plan(m, n, gran, aligned, ld=ld)
    assert (plan.path, plan.lanes_per_cell, plan.flat) == want
    # a pure function: the same inputs, the same plan
    assert k1.encode_plan(m, n, gran, aligned, ld=ld) == plan
    assert plan.vector == (plan.path in ("quads", "segments")
                           or (plan.path == "warp" and aligned
                               and n % 4 == 0 and gran[1] % 4 == 0
                               and (ld or n) % 4 == 0))
    # the grid covers the work, at most BLOCKS_PER_SM blocks per SM
    assert 1 <= plan.grid <= k1.SM_COUNT * k1.BLOCKS_PER_SM
    assert k1.encode_plan(m, n, gran, aligned, ld=ld, sm_count=4).grid \
        <= 4 * k1.BLOCKS_PER_SM


def test_encode_plan_grid_and_limits():
    from repro_torch.kernels import relu_encode as k1

    # dw2's input: 1.6 M quads fill the card; a small one takes one block
    assert k1.encode_plan(100352, 64, (1, 1), True).grid == 132 * 8
    assert k1.encode_plan(8, 64, (1, 1), True).grid == 1
    assert k1.encode_plan(8, 64, (1, 32), True).grid == 1
    with pytest.raises(ValueError):
        k1.encode_plan(2 ** 16, 2 ** 15, (1, 1), True)
    with pytest.raises(ValueError):
        k1.encode_plan(8, 8, (0, 1), True)


# ---------------------------------------------------------------------------
# K2 queue builders
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(1)
BITMAPS = {
    "random": (_rng.random((5, 7)) < 0.5).astype(np.int32),
    "all_zero": np.zeros((4, 4), np.int32),
    "all_one": np.ones((4, 4), np.int32),
    "ragged": np.asarray([[0, 1, 1], [1, 0, 0], [0, 0, 1],
                          [1, 1, 1], [0, 0, 0]], np.int32),
    "long": (_rng.random((3, 700)) < 0.3).astype(np.int32),
}


@pytest.mark.parametrize("builder", ["prefix_sum", "argsort"])
@pytest.mark.parametrize("cap_kind", ["above", "exact", "below"])
@pytest.mark.parametrize("name", list(BITMAPS))
def test_build_queue_matches_reference(name, cap_kind, builder):
    bm = BITMAPS[name]
    n_live = int(bm.sum())
    cap = {"above": bm.size + 3, "exact": bm.size,
           "below": max(n_live // 2, 1)}[cap_kind]
    jii, jjj, jn = jops.build_queue(jnp.asarray(bm), capacity=cap,
                                    builder=builder)
    tii, tjj, tn = tops.build_queue(torch.tensor(bm), capacity=cap,
                                    builder=builder)
    np.testing.assert_array_equal(tii.numpy(), np.asarray(jii))
    np.testing.assert_array_equal(tjj.numpy(), np.asarray(jjj))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) == n_live
    assert tstats.counts() == jstats.counts() == {f"queue:{builder}": 1}


# MobileNet's compact GEMMs hand K2 (G·Mb, 1) bitmaps: dw1's dX 32 × 784
# row tiles, dw2's 64 × 784; "above" puts the capacity past T.
@pytest.mark.parametrize("tiles,cap_kind", [(25088, "exact"),
                                            (25088, "below"),
                                            (50176, "exact"),
                                            (50176, "above")])
def test_queue_plain_version_at_mobilenet_sizes(tiles, cap_kind):
    bm = (np.random.default_rng(tiles).random((tiles, 1)) < 0.5) \
        .astype(np.int32)
    cap = {"exact": tiles, "above": tiles + 77,
           "below": int(bm.sum()) // 2}[cap_kind]
    jq = jops.build_queue(jnp.asarray(bm), capacity=cap)
    tq = tqueue.build_queue_plain(torch.tensor(bm), cap)
    for t, j in zip(tq, jq):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(tq[2][0]) == int(bm.sum())


def test_queue_plain_version_equals_argsort_reference():
    for bm in BITMAPS.values():
        for cap in (bm.size, max(int(bm.sum()) // 2, 1)):
            t = torch.tensor(bm)
            for a, b in zip(tqueue.build_queue_plain(t, cap),
                            tqueue.build_queue_argsort(t, cap)):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K3/K4 through sparse_gemm
# ---------------------------------------------------------------------------

EPILOGUES = {"none": (), "sigma": ("sigma_prime",),
             "sigma_emit": ("sigma_prime", "bitmap_emit")}
# (block, groups, emit granularity): a 2-D request and a grouped one.
BLOCKS = {"8x16x8": ((8, 16, 8), 1, (2, 4)),
          "16x8x32": ((16, 8, 32), 2, (4, 8))}
CASES = [("predicated", e, b, "unbounded") for e in EPILOGUES for b in BLOCKS]
CASES += [("compact", e, b, c) for e in EPILOGUES for b in BLOCKS
          for c in ("unbounded", "overflow")]


def _gemm_inputs(block, g, seed=2):
    m, k, n = 33, 40, 29
    bm, bk, bn = block
    ni, nk, nj = -(-m // bm), -(-k // bk), -(-n // bn)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g, m, k)).astype(np.float32)
    b = rng.standard_normal((g, k, n)).astype(np.float32)
    om = (rng.random((g, ni, nj)) < 0.5).astype(np.int32)
    am = (rng.random((g, ni, nk)) < 0.7).astype(np.int32)
    bmk = (rng.random((g, nk, nj)) < 0.7).astype(np.int32)
    mult = (rng.random((g, m, n)) < 0.5).astype(np.float32)
    if g == 1:
        a, b, om, am, bmk, mult = (x[0] for x in (a, b, om, am, bmk, mult))
    return a, b, om, am, bmk, mult


@pytest.mark.parametrize("schedule,epi,blk,cap", CASES)
def test_sparse_gemm_matches_reference(schedule, epi, blk, cap):
    block, g, emit = BLOCKS[blk]
    stages = EPILOGUES[epi]
    a, b, om, am, bmk, mult = _gemm_inputs(block, g)
    max_active = int(om.sum()) // 2 if cap == "overflow" else None
    kw = dict(block=block, groups=g, schedule=schedule, epilogue=stages,
              emit_gran=emit if "bitmap_emit" in stages else None,
              max_active_blocks=max_active)
    use_mult = "sigma_prime" in stages
    jres = jops.sparse_gemm(
        jnp.asarray(a), jnp.asarray(b),
        jops.GemmMasks(*(jnp.asarray(x) for x in (om, am, bmk))),
        jops.GemmSpec(**kw),
        epilogue_mult=jnp.asarray(mult) if use_mult else None)
    tres = tops.sparse_gemm(
        torch.tensor(a), torch.tensor(b),
        tops.GemmMasks(*(torch.tensor(x) for x in (om, am, bmk))),
        tops.GemmSpec(**kw),
        epilogue_mult=torch.tensor(mult) if use_mult else None)
    if "bitmap_emit" in stages:
        (jout, jbits), (tout, tbits) = jres, tres
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    else:
        jout, tout = jres, tres
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    # skipped tiles are EXACT zeros in both packages
    np.testing.assert_array_equal(tout.numpy() == 0, np.asarray(jout) == 0)
    assert tstats.counts() == jstats.counts()
    if cap == "overflow":
        assert tstats.counts().get("fallback:queue_overflow") == 1


# Non-finite values in skipped blocks, at (16, 16) @ (16, 16) on block
# (8, 8, 8): (where, value, out_mask, b_mask, which operand or σ′ holds it).
DEAD_2X2 = [[0, 1], [1, 1]]
NONFINITE = {
    # a NaN in A's row 0, whose output tile (0, 0) is dead
    "nan in a dead output tile": (DEAD_2X2, None, "a"),
    # an infinity in a live A block that meets the dead B block (0, 0)
    "inf in a live A block, dead B block": (None, DEAD_2X2, "a_inf"),
    # a NaN in σ′'s multiplier on the dead output tile (1, 0)
    "nan in sigma-prime at a dead tile": ([[1, 1], [0, 1]], None, "mult"),
}


@pytest.mark.parametrize("schedule,cap", [("predicated", None),
                                          ("compact", None),
                                          ("compact", 2)])
@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_sparse_gemm_nonfinite_in_skipped_blocks_matches_reference(
        case, schedule, cap):
    """A NaN or an infinity in a block the kernels skip stays out of the
    output: the plain version's non-finite values sit where the reference's
    do, under every schedule (cap 2 < n_live: the overflow fallback), and
    the finite values agree to 1e-5.

    The σ′ case is held against the reference's compact schedule: its
    predicated Pallas kernel runs the epilogue on a dead tile too (its
    accumulator 0 × NaN), where every kernel of both packages that skips
    the tile, and so the port on every schedule, leaves 0."""
    out_mask, b_mask, where = NONFINITE[case]
    rng = np.random.default_rng(11)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16)).astype(np.float32)
    mult = (rng.random((16, 16)) < 0.5).astype(np.float32)
    if where == "a":
        a[0, 0] = np.nan
    elif where == "a_inf":
        a[0, 0] = np.inf
    else:
        mult[8, 0] = np.nan
    ones = np.ones((2, 2), np.int32)
    om = np.asarray(out_mask if out_mask is not None else ones, np.int32)
    bmk = np.asarray(b_mask if b_mask is not None else ones, np.int32)
    masks = (om, ones, bmk)
    stages = ("sigma_prime",) if where == "mult" else ()
    kw = dict(block=(8, 8, 8), epilogue=stages, max_active_blocks=cap)
    jsched, jcap = ("compact", None) if where == "mult" else (schedule, cap)
    want = np.asarray(jops.sparse_gemm(
        jnp.asarray(a), jnp.asarray(b),
        jops.GemmMasks(*(jnp.asarray(x) for x in masks)),
        jops.GemmSpec(schedule=jsched, **{**kw, "max_active_blocks": jcap}),
        epilogue_mult=jnp.asarray(mult) if stages else None))
    got = tops.sparse_gemm(
        torch.tensor(a), torch.tensor(b),
        tops.GemmMasks(*(torch.tensor(x) for x in masks)),
        tops.GemmSpec(schedule=schedule, **kw),
        epilogue_mult=torch.tensor(mult) if stages else None).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    # row 0 of the live tile (0, 1) only; the skipped tile or pair is finite
    bad = ~np.isfinite(got)
    assert bad.sum() == (0 if where == "mult" else 8)
    assert bad[0, 8:].all() == (where != "mult")


def test_plain_gemm_keeps_one_bmm_on_finite_operands(monkeypatch):
    """Finite operands take one bmm (the order and time the step's plain
    version had); a non-finite live block takes the k-block route."""
    from repro_torch.kernels import masked_matmul as tmm

    calls = []
    real = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda x, y: calls.append(1)
                        or real(x, y))
    a, b, om, am, bmk, mult = (torch.tensor(x) for x in
                               _gemm_inputs((8, 16, 8), 2))
    tmm._masked_product(a, b, om, am, bmk, (8, 16, 8), mult)
    assert len(calls) == 1
    a[0, 0, 0] = float("inf")
    tmm._masked_product(a, b, om, am, bmk, (8, 16, 8), mult)
    assert len(calls) == 1 + 3              # K = 40 on bk = 16: 3 k blocks


def test_gemm_spec_validation_matches_reference():
    for kw in ({"schedule": "bogus"}, {"groups": 0}, {"block": (8, 8)},
               {"epilogue": ("bitmap_emit",)},
               {"emit_gran": (1, 1)},
               {"epilogue": ("bitmap_emit",), "emit_gran": (3, 1)}):
        with pytest.raises(ValueError):
            jops.GemmSpec(**kw)
        with pytest.raises(ValueError):
            tops.GemmSpec(**kw)


def test_wrappers_reject_bf16_and_bad_shapes():
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        tops.relu_encode(a, block=(1, 8))
    with pytest.raises(NotImplementedError):
        tops.sparse_gemm(a, a, None, tops.GemmSpec(block=(8, 8, 8)))
    x = torch.zeros((8, 8))
    with pytest.raises(ValueError):
        tops.sparse_gemm(x, x, tops.GemmMasks(out=torch.ones(3, 3)),
                         tops.GemmSpec(block=(8, 8, 8)))


# ---------------------------------------------------------------------------
# stats readers, oracles and shape helpers
# ---------------------------------------------------------------------------

def test_stats_readers_match_reference():
    keys = ["encode:act", "queue:prefix_sum", "queue:argsort",
            "gemm:compact:1", "gemm:compact:1", "gemm:predicated:2",
            "mm:compact", "gmm:predicated:2", "emit:grad", "scan:grad"]
    for key in keys:
        jstats.record(key)
        tstats.record(key)
    assert tstats.counts() == jstats.counts()
    for what in ("", "act", "grad", "1"):
        assert tstats.total(what) == jstats.total(what)
    for builder in ("", "prefix_sum", "argsort"):
        assert tstats.queue_builds(builder) == jstats.queue_builds(builder)
    for schedule in ("", "compact", "predicated", "dense"):
        for groups in (None, 1, 2):
            assert tstats.gemm_launches(schedule, groups) == \
                jstats.gemm_launches(schedule, groups)


def test_oracles_and_pad_helpers_match_reference():
    from repro.kernels import ref as jref
    from repro.kernels import shapes as jshapes
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import shapes as tshapes

    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 29)).astype(np.float32)
    x *= rng.random(x.shape) > 0.6
    for b0, b1 in ((8, 16), (1, 8), (37, 29)):
        np.testing.assert_array_equal(
            tshapes.block_bitmap(torch.tensor(x), b0, b1).numpy(),
            np.asarray(jshapes.block_bitmap(jnp.asarray(x), b0, b1)))
    m = (rng.random((3, 5)) < 0.5).astype(np.int32)
    np.testing.assert_array_equal(
        tshapes.pad_mask(torch.tensor(m), 4, 7).numpy(),
        np.asarray(jshapes.pad_mask(jnp.asarray(m), 4, 7)))
    np.testing.assert_array_equal(
        tshapes.pad_mask3(None, 2, 3, 4).numpy(),
        np.asarray(jshapes.pad_mask3(None, 2, 3, 4)))
    assert tshapes.grid_shape((33, 40, 29), (8, 16, 8)) == \
        jshapes.grid_shape((33, 40, 29), (8, 16, 8))
    a = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal((48, 24)).astype(np.float32)
    om = (rng.random((4, 3)) < 0.5).astype(np.int32)
    am = (rng.random((4, 3)) < 0.5).astype(np.int32)
    bmk = (rng.random((3, 3)) < 0.5).astype(np.int32)
    mult = (rng.random((32, 24)) < 0.5).astype(np.float32)
    kw = dict(bm=8, bk=16, bn=8)
    got = tref.masked_matmul(*(torch.tensor(v) for v in (a, b, om, am, bmk)),
                             epilogue_mult=torch.tensor(mult), **kw)
    want = jref.masked_matmul(*(jnp.asarray(v) for v in (a, b, om, am, bmk)),
                              epilogue_mult=jnp.asarray(mult), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    dy = rng.standard_normal((32, 48)).astype(np.float32)
    got = tref.relu_bwd_masked(torch.tensor(dy), torch.tensor(b),
                               torch.tensor(mult), **kw)
    want = jref.relu_bwd_masked(jnp.asarray(dy), jnp.asarray(b),
                                jnp.asarray(mult), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    ty, tb = tref.relu_encode(torch.tensor(x[:32, :16]), bm=8, bn=8)
    jy, jb = jref.relu_encode(jnp.asarray(x[:32, :16]), bm=8, bn=8)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
