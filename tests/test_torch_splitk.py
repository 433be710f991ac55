"""The masked GEMM's launch plan (split-K and the group-major paths) and the
device-side queue-overflow counter, on the CPU.

``split_plan`` and ``gemm_path`` choose the kernel path and the split-K
slices from the shape and the mask block alone; these tests pin that they
never see the masks, the capacity or the live count, that the slices cover
the mask k blocks once on block edges, and that the plan fills the H100 at
the weight-gradient and depthwise shapes of the VGG16 and MobileNet steps.
The plain versions these paths share are held against the JAX reference at
small shapes that take each path.  The CUDA kernels themselves run only on
a GPU (tests/test_torch_cuda.py and chip_smoke.py).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro_torch.kernels import _build
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import queue_builder as tqueue
from repro_torch.kernels import stats as tstats
from repro_torch.kernels.shapes import grid_shape

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


B128 = (128, 128, 128)
# (G, M, K, N, block) of the launches the plan is for, from the full-width
# steps (224², batch 8): VGG16's conv1/conv2/conv4 WGs, MobileNet's conv0,
# pw1 and dw1 WGs, dw1's and dw2's dX GEMMs, dw13's WG, VGG16 conv13's FP.
STEP_SHAPES = {
    "vgg16 conv1 WG": (1, 27, 401408, 64, B128),
    "vgg16 conv2 WG": (1, 576, 401408, 64, B128),
    "vgg16 conv4 WG": (1, 1152, 100352, 128, B128),
    "mobilenet conv0 WG": (1, 27, 401408, 32, B128),
    "mobilenet pw1 WG": (1, 32, 100352, 64, B128),
    "mobilenet dw1 WG": (32, 9, 100352, 1, (9, 128, 1)),
    "mobilenet dw1 dX": (32, 100352, 9, 1, (128, 9, 1)),
    "mobilenet dw2 dX": (64, 100352, 9, 1, (128, 9, 1)),
    "mobilenet dw13 WG": (1024, 9, 392, 1, (9, 128, 1)),
    "vgg16 conv13 FP": (1, 1568, 4608, 512, B128),
}
UNSPLIT = {
    "vgg16 conv4 dX": (1, 100352, 1152, 128, B128),
    "ragged": (2, 333, 250, 77, (8, 16, 8)),
}


def test_plan_is_a_function_of_shape_and_block_only():
    for fn in (mm.split_plan, mm.gemm_path, mm.grid_blocks):
        assert list(inspect.signature(fn).parameters) == \
            ["g", "m", "k", "n", "block"]


@pytest.mark.parametrize("name", ["split", "rows", "k"])
def test_launch_args_plan_ignores_masks_capacity_and_live_count(
        name, monkeypatch):
    """Every launch of one shape (compact at any capacity, its predicated
    fallback, a plain predicated launch) gets the same path and splits,
    whatever the masks say."""
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    g, m, k, n, block = {"split": (1, 40, 3000, 20, (16, 32, 8)),
                         "rows": (40, 300, 9, 1, (128, 9, 1)),
                         "k": (40, 9, 1000, 1, (9, 128, 1))}[name]
    ni, nk, nj = grid_shape((m, k, n), block)
    a, b = torch.zeros(g, m, k), torch.zeros(g, k, n)
    out = torch.zeros(g, m, n)
    plans = set()
    for live in (0.0, 0.3, 1.0):
        rng = np.random.default_rng(0)
        om = torch.tensor(rng.random((g, ni, nj)) < live).to(torch.int32)
        am = torch.tensor(rng.random((g, ni, nk)) < live).to(torch.int32)
        total = g * ni * nj
        for cap in (total, max(total // 3, 1)):
            fi, jj, nl = tqueue.build_queue_plain(
                om.reshape(g * ni, nj), cap)
            for mode, args in (
                    (mm._COMPACT, (None, am, None, None, fi, jj, nl, cap)),
                    (mm._PREDICATED, (om, am, None, None, None, None, nl,
                                      cap)),
                    (mm._PREDICATED, (om, am, None, None, None, None, None,
                                      0))):
                c_args, r_args, splits, _ = mm.launch_args(
                    mode, a, b, out, None, *args, block, None)
                # (path, splits, the reduce plan)
                plans.add((c_args[-3], splits, (0, 0, 0) if r_args is None
                           else r_args[-4:-1]))
                assert r_args is None or (
                    r_args[:-4] == c_args[:-1] and r_args[-1] == c_args[-1])
    path = mm.gemm_path(g, m, k, n, block)
    splits = mm.split_plan(g, m, k, n, block)
    plan = tuple(mm.reduce_plan(path, g, m, n, splits)) if splits > 1 \
        else (0, 0, 0)
    assert plans == {(path, splits, plan)}
    assert len(plans) == 1 and (name != "split" or next(iter(plans))[1] > 1)


@pytest.mark.parametrize("name", sorted(STEP_SHAPES))
def test_splits_cover_every_k_block_once_on_block_edges(name):
    g, m, k, n, block = STEP_SHAPES[name]
    kb = grid_shape((m, k, n), block)[1]
    splits = mm.split_plan(g, m, k, n, block)
    bounds = mm.split_bounds(kb, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == kb
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert hi == lo2
    covered = [kbi for lo, hi in bounds for kbi in range(lo, hi)]
    assert covered == list(range(kb))         # each k block exactly once
    if splits > 1:
        assert min(hi - lo for lo, hi in bounds) >= mm.MIN_KBLOCKS_PER_SPLIT


@pytest.mark.parametrize("name", sorted(STEP_SHAPES))
def test_plan_fills_the_card_at_the_step_shapes(name):
    g, m, k, n, block = STEP_SHAPES[name]
    blocks = mm.grid_blocks(g, m, k, n, block) \
        * mm.split_plan(g, m, k, n, block)
    if name == "mobilenet dw13 WG":
        # 32 group blocks and 4 k blocks: two slices of two, no more.
        assert mm.split_plan(g, m, k, n, block) == 2
    else:
        assert blocks >= 2 * mm.SM_COUNT == 264


def test_paths_at_the_step_shapes():
    path = {name: mm.gemm_path(*shape) for name, shape in STEP_SHAPES.items()}
    assert path["mobilenet dw1 dX"] == path["mobilenet dw2 dX"] \
        == mm.GROUP_ROWS
    assert path["mobilenet dw1 WG"] == path["mobilenet dw13 WG"] \
        == mm.GROUP_K
    assert all(p == mm.STANDARD for name, p in path.items()
               if not name.startswith("mobilenet dw"))
    # G = 1 never leaves the standard path (K6/K7 share sparse_gemm's).
    assert mm.gemm_path(1, 100352, 9, 1, (128, 9, 1)) == mm.STANDARD


@pytest.mark.parametrize("name", sorted(UNSPLIT))
def test_grids_that_fill_the_card_keep_one_split(name):
    assert mm.split_plan(*UNSPLIT[name]) == 1
    assert mm.grid_blocks(*UNSPLIT[name]) >= 2 * mm.SM_COUNT


# ---------------------------------------------------------------------------
# The device-side overflow counter, driven through CPU tensors
# ---------------------------------------------------------------------------

def test_device_overflow_counter_folds_into_counts():
    key = "fallback:queue_overflow"
    tstats.record_on_device(key, torch.tensor([7], dtype=torch.int32) > 3)
    tstats.record("gemm:compact:1")
    assert tstats.counts() == {key: 1, "gemm:compact:1": 1}
    # folded once: a second read does not count it again
    assert tstats.counts()[key] == 1
    tstats.record_on_device(key, torch.tensor([2], dtype=torch.int32) > 3)
    assert tstats.counts() == {key: 1, "gemm:compact:1": 1}
    tstats.record_on_device(key, torch.tensor([9], dtype=torch.int32) > 3)
    tstats.record_on_device(key, torch.tensor([9], dtype=torch.int32) > 3)
    assert tstats.total("queue_overflow") == 3
    tstats.reset()
    tstats.record_on_device(key, torch.tensor([9], dtype=torch.int32) > 3)
    tstats.reset()
    assert tstats.counts() == {}


def test_no_overflow_adds_no_key():
    tstats.record_on_device("fallback:queue_overflow",
                            torch.tensor([3], dtype=torch.int32) > 3)
    assert tstats.counts() == {}
    assert tstats.total() == 0


# ---------------------------------------------------------------------------
# The plain versions at shapes that take each path, against the reference
# ---------------------------------------------------------------------------

PATH_CASES = {
    # (G, M, K, N, block, emit granularity, the path the card takes)
    "group rows": (4, 200, 9, 1, (128, 9, 1), (1, 1), mm.GROUP_ROWS),
    "group rows N2": (3, 150, 9, 2, (64, 9, 2), (1, 2), mm.GROUP_ROWS),
    "group k": (4, 9, 600, 1, (9, 128, 1), None, mm.GROUP_K),
    "split": (1, 40, 3000, 20, (16, 32, 8), (2, 4), mm.STANDARD),
}


@pytest.mark.parametrize("cap", ["unbounded", "overflow"])
@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_sparse_gemm_at_path_shapes_matches_reference(case, cap):
    g, m, k, n, block, emit, path = PATH_CASES[case]
    assert mm.gemm_path(g, m, k, n, block) == path
    assert path != mm.STANDARD or mm.split_plan(g, m, k, n, block) > 1
    ni, nk, nj = grid_shape((m, k, n), block)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((g, m, k)).astype(np.float32)
    b = rng.standard_normal((g, k, n)).astype(np.float32)
    om = (rng.random((g, ni, nj)) < 0.6).astype(np.int32)
    am = (rng.random((g, ni, nk)) < 0.7).astype(np.int32)
    bmk = (rng.random((g, nk, nj)) < 0.7).astype(np.int32)
    mult = (rng.random((g, m, n)) < 0.5).astype(np.float32)
    stages = ("sigma_prime",) + (("bitmap_emit",) if emit else ())
    kw = dict(block=block, groups=g, schedule="compact", epilogue=stages,
              emit_gran=emit,
              max_active_blocks=int(om.sum()) // 2 if cap == "overflow"
              else None)
    jres = jops.sparse_gemm(
        jnp.asarray(a), jnp.asarray(b),
        jops.GemmMasks(*(jnp.asarray(x) for x in (om, am, bmk))),
        jops.GemmSpec(**kw), epilogue_mult=jnp.asarray(mult))
    tres = tops.sparse_gemm(
        torch.tensor(a), torch.tensor(b),
        tops.GemmMasks(*(torch.tensor(x) for x in (om, am, bmk))),
        tops.GemmSpec(**kw), epilogue_mult=torch.tensor(mult))
    if emit:
        (jout, jbits), (tout, tbits) = jres, tres
        np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    else:
        jout, tout = jres, tres
    # K up to 3,000: the two f32 sums differ in order, so the absolute part
    # of the tolerance scales with the output, 1e-5·max|ref|.
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jout, rtol=TOL,
                               atol=TOL * float(np.abs(jout).max()))
    np.testing.assert_array_equal(tout.numpy() == 0, jout == 0)
    assert tstats.counts() == jstats.counts()
    assert (tstats.counts().get("fallback:queue_overflow") == 1) \
        == (cap == "overflow")


# ---------------------------------------------------------------------------
# The split-K reduce's plan and its plain sum
# ---------------------------------------------------------------------------

def _split_shapes():
    """(name, path, G, M, N, S) of every split launch in STEP_SHAPES."""
    out = []
    for name, (g, m, k, n, block) in sorted(STEP_SHAPES.items()):
        splits = mm.split_plan(g, m, k, n, block)
        if splits > 1:
            out.append((name, mm.gemm_path(g, m, k, n, block), g, m, n,
                        splits))
    return out


def test_reduce_plan_is_a_function_of_path_shape_and_splits_only(
        monkeypatch):
    assert list(inspect.signature(mm.reduce_plan).parameters) == \
        ["path", "g", "m", "n", "splits"]

    def no_device(*_a, **_k):
        raise AssertionError("reduce_plan asked the device")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    for _, path, g, m, n, s in _split_shapes():
        plan = mm.reduce_plan(path, g, m, n, s)
        assert plan == mm.reduce_plan(path, g, m, n, s)
        assert plan.chunks * plan.quads == mm.REDUCE_THREADS
        assert 1 <= plan.chunks <= min(s, mm.REDUCE_MAX_CHUNKS)
    with pytest.raises(ValueError):
        mm.reduce_plan(mm.STANDARD, 1, 8, 8, 1)


@pytest.mark.parametrize("splits", [2, 3, 5, 7, 8])
def test_reduce_plan_keeps_one_chunk_at_small_split_counts(splits):
    """The FP/dX reduces of VGG16's conv8-13 and head (2-7 splits on grids
    of 10^4-10^5 outputs) sum in split order, as before the plan."""
    for g, m, n in ((1, 1568, 512), (1, 4608, 512), (1, 8, 1000)):
        if g * m * -(-n // 4) >= mm.REDUCE_FILL_THREADS:
            assert mm.reduce_plan(mm.STANDARD, g, m, n, splits).chunks == 1


@pytest.mark.parametrize("case", [c[0] for c in _split_shapes()])
def test_reduce_chunks_cover_the_splits_in_order(case):
    name, path, g, m, n, s = next(c for c in _split_shapes() if c[0] == case)
    plan = mm.reduce_plan(path, g, m, n, s)
    bounds = mm.split_bounds(s, plan.chunks)
    assert [z for lo, hi in bounds for z in range(lo, hi)] == list(range(s))
    assert all(hi - lo >= 1 for lo, hi in bounds)
    # every thread's chunk fits one batch of loads in flight
    assert max(hi - lo for lo, hi in bounds) <= mm.REDUCE_LOADS
    # the grid covers the units: the flat workspace (group k) or a piece
    units = -(-g * m * n // 4) if path == mm.GROUP_K \
        else min(m, 128) * -(-min(n, 128) // 4)
    assert plan.grid * plan.quads >= units > (plan.grid - 1) * plan.quads


def test_reduce_plan_at_the_step_shapes():
    plans = {c[0]: (c[5], mm.reduce_plan(*c[1:])) for c in _split_shapes()}
    # conv2's WG: 79 partials of 9,216 units, 16 chunks of 4-5 splits
    assert plans["vgg16 conv2 WG"][0] == 79
    assert plans["vgg16 conv2 WG"][1].chunks == 16
    # dw1's WG: 392 partials of 288 outputs across 32 groups, one grid of
    # the flat workspace, the most chunks
    s, plan = plans["mobilenet dw1 WG"]
    assert s == 392 and plan.chunks == mm.REDUCE_MAX_CHUNKS
    assert plan.grid == 72 // plan.quads == 18     # 288 outputs, 72 units


@pytest.mark.parametrize("chunks", [1, 2, 4, 7])
def test_splitk_reduce_plain_sums_in_plan_order(chunks):
    rng = np.random.default_rng(chunks)
    ws = torch.tensor(rng.standard_normal((7, 2, 5, 6)).astype(np.float32))
    plan = mm.ReducePlan(chunks, mm.REDUCE_THREADS // chunks, 1)
    got = mm.splitk_reduce_plain(ws, plan)
    want = None
    for lo, hi in mm.split_bounds(7, chunks):
        part = ws[lo].clone()
        for z in range(lo + 1, hi):
            part = part + ws[z]
        want = part if want is None else want + part
    assert torch.equal(got, want)
    seq = ws[0].clone()
    for z in range(1, 7):
        seq = seq + ws[z]
    if chunks == 1:
        assert torch.equal(got, seq)          # C = 1: the sequential sum
    assert float((got - seq).abs().max()) <= 1e-5 * float(seq.abs().max())
    assert not torch.equal(ws[0], got)        # the sum, not a copy


def test_queue_member_and_emit_fixup_plain_versions():
    fi = torch.tensor([0, 2, 3, 0], dtype=torch.int32)
    jj = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    member = torch.full((4 * 2,), 7, dtype=torch.int32)   # zero-filled
    mm.queue_member(fi, jj, torch.tensor([3], dtype=torch.int32), member,
                    n_cols=2)
    assert member.tolist() == [0, 1, 0, 0, 1, 0, 0, 1]
    over = torch.full((8,), 7, dtype=torch.int32)
    mm.queue_member(fi, jj, torch.tensor([5], dtype=torch.int32), over,
                    n_cols=2)
    assert int(over.sum()) == 0                # overflow: nothing marked
    out = torch.ones(1, 4, 6)
    out[0, 1, 4] = float("nan")
    bits = mm.emit_bits(out.nan_to_num(1.0), (2, 3))
    mm.emit_nan_fixup(out, bits, (2, 3))
    assert bits.tolist() == [[[1, 0], [1, 1]]]
