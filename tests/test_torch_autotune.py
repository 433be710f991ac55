"""The port's autotuner against the JAX package's: ``clamp_schedule``,
``_refined_block`` and ``key_for``; a scripted observe / report_suspect /
demote / resolve sequence on both caches giving equal decision logs row
for row; a reference ``export_state`` document imported into the port and
resolving the same; ``apply_quarantine`` through ``gemm_spec``; and the
dispatcher's live-tile fractions — recorded at once on the CPU, and folded
from device-side counts (``fold_pending``) as on the card — equal to the
reference's ``_observe_live_tiles``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import policy as jpol
from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro_torch.core import policy as tpol
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()
    yield
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()


def _specs(**kw):
    return jops.GemmSpec(**kw), tops.GemmSpec(**kw)


@pytest.mark.parametrize("schedule", ["compact", "predicated", "dense"])
def test_clamp_schedule_and_refined_block(schedule):
    for level in range(-1, 5):
        assert tat.clamp_schedule(schedule, level) == \
            jat.clamp_schedule(schedule, level)
    for block in [(128, 128, 128), (8, 16, 8), (1, 9, 1), (64, 3, 5)]:
        for grans in [(1, 1, 1), (1, 4, 4), (8, 1, 2), (4, 3, 5)]:
            assert tat._refined_block(block, grans) == \
                jat._refined_block(block, grans)


@pytest.mark.parametrize("dims", [None, (33, 40, 29), (100352, 9, 1)])
def test_key_for_matches(dims):
    for kw in ({}, {"block": (8, 16, 8), "groups": 3,
                    "schedule": "compact", "queue_builder": "argsort"},
               {"block": (64, 9, 1), "epilogue": ("sigma_prime",)}):
        js, ts = _specs(**kw)
        jk, tk = jat.key_for(js, dims), tat.key_for(ts, dims)
        assert (tk.block, tk.groups, tk.queue_builder, tk.padded) == \
            (jk.block, jk.groups, jk.queue_builder, jk.padded)
        assert tk.stats_key == jk.stats_key


def _script(at, ops_mod):
    """One scripted sequence of cache calls; returns the resolved
    (schedule, block) of every resolve."""
    cache = at.reset(min_samples=2, overflow_demote_after=3)
    dims = (64, 48, 32)
    spec = ops_mod.GemmSpec(block=(16, 16, 16), schedule="compact")
    other = ops_mod.GemmSpec(block=(8, 8, 8), groups=2)
    key = at.key_for(spec, dims)
    okey = at.key_for(other, None)
    got = [at.resolve(spec, dims=dims, grans=(1, 4, 4))]
    for frac in (0.3, 0.35):
        cache.observe(key, frac, 0.9)
    got.append(at.resolve(spec, dims=dims, grans=(1, 4, 4)))   # measured
    got.append(at.resolve(spec, dims=dims, grans=(1, 4, 4)))   # hit
    for frac in (0.99, 0.99, 0.99, 0.99):
        cache.observe(key, frac, 0.995)
    got.append(at.resolve(spec, dims=dims, grans=(1, 4, 4)))   # retune
    got.append(at.resolve(other))
    for frac in (0.8, 0.85, 0.9):
        cache.observe(okey, frac)
    got.append(at.resolve(other))
    for _ in range(3):
        at.report_overflow(spec, dims)                          # auto-demote
    cache.report_suspect(other, None, "bitmap")
    cache.demote_suspects(reason="guard")
    cache.demote(okey, reason="manual")
    cache.demote(okey, reason="manual")                         # at bottom
    got.append(at.resolve(spec, dims=dims, grans=(1, 4, 4)))
    got.append(at.resolve(other))
    got.append(at.apply_quarantine(ops_mod.GemmSpec(block=(8, 8, 8),
                                                    groups=2,
                                                    schedule="compact")))
    return [(s.schedule, tuple(s.block)) for s in got]


def test_scripted_sequence_gives_equal_logs():
    want = _script(jat, jops)
    jrows, jdoc = jat.log_rows(), jat.export_state()
    jcounts = jstats.counts()
    got = _script(tat, tops)
    assert got == want
    assert tat.log_rows() == jrows
    assert tat.export_state() == jdoc
    assert tstats.counts() == jcounts
    c = tat.get_cache()
    assert (c.hits, c.misses, c.retunes, c.demotions) == \
        (jat.get_cache().hits, jat.get_cache().misses,
         jat.get_cache().retunes, jat.get_cache().demotions)


def test_reference_state_imports_into_the_port():
    _script(jat, jops)
    doc = json.loads(json.dumps(jat.export_state()))
    tat.reset(min_samples=2, overflow_demote_after=3)
    tat.import_state(doc)
    assert tat.export_state() == jat.export_state()
    dims = (64, 48, 32)
    js, ts = _specs(block=(16, 16, 16), schedule="compact")
    for _ in range(2):
        jr = jat.resolve(js, dims=dims, grans=(1, 4, 4))
        tr = tat.resolve(ts, dims=dims, grans=(1, 4, 4))
        assert (tr.schedule, tr.block) == (jr.schedule, jr.block)
    assert tat.log_rows() == jat.log_rows()
    # and the port's document imports into the reference
    jat.reset()
    jat.import_state(json.loads(json.dumps(tat.export_state())))
    assert jat.export_state() == tat.export_state()


@pytest.mark.parametrize("autotune", [False, True])
def test_quarantine_clamps_through_gemm_spec(autotune):
    out = []
    for pol, at in ((jpol, jat), (tpol, tat)):
        p = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8),
                                autotune=autotune)
        dims = (16, 16, 16)
        first = p.gemm_spec(dims=dims)
        key = at.key_for(first, dims)
        at.get_cache().demote(key, reason="test")
        second = p.gemm_spec(dims=dims)
        at.get_cache().demote(key, reason="test")
        third = p.gemm_spec(dims=dims)
        out.append(([s.schedule for s in (first, second, third)],
                    [s.block for s in (first, second, third)]))
    assert out[0] == out[1]
    assert out[1][0] == ["compact", "predicated", "dense"]
    assert tstats.counts() == jstats.counts()
    assert tat.log_rows() == jat.log_rows()


def _mask(rng, shape, p):
    return (rng.random(shape) < p).astype(np.int32)


@pytest.mark.parametrize("defer", [False, True])
def test_dispatch_fractions_match_reference(defer):
    """Dispatches through an autotuned policy in both packages; the port's
    fractions recorded at once (the CPU) or queued as device-side counts
    and folded (the card's path) equal the reference's."""
    rng = np.random.default_rng(0)
    block = (8, 8, 8)
    cases = [((24, 40, 16), 0.5, 0.7, 0.9), ((17, 9, 33), 0.2, 1.0, 0.4),
             ((8, 8, 8), 1.0, 0.0, 1.0)]
    for (m, k, n), po, pa, pb in cases:
        ni, nk, nj = -(-m // 8), -(-k // 8), -(-n // 8)
        om, am, bmk = (_mask(rng, s, p) for s, p in
                       (((ni, nj), po), ((ni, nk), pa), ((nk, nj), pb)))
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
        for pol, ops_mod, conv in ((jpol, jops, jnp.asarray),
                                   (tpol, tops, torch.from_numpy)):
            p = pol.IN_OUT.with_(kernel_impl="pallas", block=block,
                                 autotune=True)
            spec = p.gemm_spec(dims=(m, k, n))
            masks = ops_mod.GemmMasks(conv(om), conv(am), conv(bmk))
            if ops_mod is tops:
                lifted = tops.GemmMasks(*(x[None] for x in masks))
                if defer:       # the card's path, on CPU tensors
                    tops._defer_live_tiles(spec, (m, k, n), lifted)
                else:
                    tops._observe_live_tiles(spec, conv(a)[None],
                                             conv(b)[None], lifted)
            else:
                ops_mod.sparse_gemm(conv(a), conv(b), masks, spec)
    assert bool(tat._PENDING) == defer
    assert tat.fold_pending() == (3 if defer else 0)
    assert sorted(tstats.live_tile_keys()) == sorted(jstats.live_tile_keys())
    for key in jstats.live_tile_keys():
        assert tstats.live_tile_stats(key) == jstats.live_tile_stats(key)


def test_deferred_overflow_is_folded_before_the_quarantine_is_read():
    tat.reset(overflow_demote_after=2)
    spec = tops.GemmSpec(block=(8, 8, 8), schedule="compact")
    dims = (16, 16, 16)
    for flag in (True, False, True):
        tat.defer_overflow(spec, dims, torch.tensor(flag))
    assert tat._PENDING_OVERFLOWS == 3
    clamped = tat.apply_quarantine(spec, dims=dims)    # folds first
    assert not tat._PENDING
    assert clamped.schedule == "predicated"
    assert [r["event"] for r in tat.log_rows()] == ["demote:overflow"]
