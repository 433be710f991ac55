"""The port's StepGuard against the JAX package's: equal verdict sequences
and ``guard_counts`` from the same inputs to ``observe_step``,
``scan_counters``, ``probe_emit`` (with the suspect it books), export and
import of the guard state, ``reference_bitmap``; and the port's chaos
matrix on the CPU at 8/8, its rows named as the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro.runtime import faults as jfaults
from repro.runtime import guards as jg
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import guards as tg


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()
    yield
    jfaults.disarm()
    tfaults.disarm()
    for s in (jstats, tstats):
        s.reset()
    jat.reset()
    tat.reset()


NAN = float("nan")
# (loss, grad_norm, skipped) per step: clean, a skip, a persistent fault
# past the skip budget (rollback), clean steps cooling down, then faults
# again until the rollbacks run out (degrade).
SEQUENCE = ([(2.0, 1.0, 0.0)] * 2 + [(NAN, NAN, 1.0)]
            + [(2.0, 1.0, 0.0)] + [(1.0, float("inf"), 1.0)] * 4
            + [(1.9, 0.9, 0.0)] * 3 + [(NAN, 1.0, 0.0)] * 12
            + [(1.8, 0.8, None)] * 20 + [(None, None, 1.0)] * 5)


@pytest.mark.parametrize("config", [
    {}, {"max_consecutive_skips": 1, "rollback_backoff": 2},
    {"max_consecutive_skips": 0, "max_rollbacks": 1, "history": 8}])
def test_verdict_sequences_match(config):
    jgd, tgd = jg.StepGuard(jg.GuardConfig(**config)), \
        tg.StepGuard(tg.GuardConfig(**config))
    jv, tv = [], []
    for i, (loss, gn, sk) in enumerate(SEQUENCE):
        jv.append(jgd.observe_step(i, loss=loss, grad_norm=gn, skipped=sk))
        tv.append(tgd.observe_step(i, loss=loss, grad_norm=gn, skipped=sk))
    assert tv == jv
    assert {"ok", "rollback", "degrade"} <= set(tv)
    assert tgd.verdicts == jgd.verdicts
    assert tstats.guard_counts() == jstats.guard_counts()
    assert tgd.export_state() == jgd.export_state()
    fresh = tg.StepGuard(tg.GuardConfig(**config))
    fresh.import_state(jgd.export_state())
    assert fresh.export_state() == jgd.export_state()


def test_scan_counters_match():
    out = []
    for stats, guards in ((jstats, jg), (tstats, tg)):
        g = guards.StepGuard(guards.GuardConfig(registry_miss_budget=1))
        g.scan_counters()
        for _ in range(4):
            stats.record("registry:miss")
        stats.record("fallback:queue_overflow")
        first = g.scan_counters(expected_registry_misses=1)
        stats.record("registry:miss")
        second = g.scan_counters(expected_registry_misses=1)
        out.append((first, second, stats.guard_counts()))
    assert out[0] == out[1]
    assert out[1][2] == {"guard:registry_miss": 1}


@pytest.mark.parametrize("flip", [None, 5])
def test_probe_emit_matches(flip):
    rng = np.random.default_rng(3)
    out = rng.standard_normal((2, 13, 10)).astype(np.float32)
    out[:, :4] = 0
    gran = (4, 4)
    bits = tg.reference_bitmap(out, gran)
    np.testing.assert_array_equal(bits, jg.reference_bitmap(out, gran))
    if flip is not None:
        bits.reshape(-1)[flip] ^= 1
    js = jops.GemmSpec(block=(8, 8, 8), groups=2)
    ts = tops.GemmSpec(block=(8, 8, 8), groups=2)
    jok, jfix = jg.StepGuard().probe_emit(jnp.asarray(out),
                                          jnp.asarray(bits), gran, spec=js,
                                          dims=(13, 8, 10))
    tok, tfix = tg.StepGuard().probe_emit(torch.from_numpy(out),
                                          torch.from_numpy(bits), gran,
                                          spec=ts, dims=(13, 8, 10))
    assert tok == jok == (flip is None)
    assert torch.is_tensor(tfix) and tfix.dtype == torch.int32
    np.testing.assert_array_equal(tfix.numpy(), np.asarray(jfix))
    assert tstats.guard_counts() == jstats.guard_counts()
    tsus = {k.stats_key: v for k, v in tat.get_cache().suspects().items()}
    jsus = {k.stats_key: v for k, v in jat.get_cache().suspects().items()}
    assert tsus == jsus
    assert [k.stats_key for k in tg.StepGuard().degrade()] == \
        [k.stats_key for k in jg.StepGuard().degrade()]
    assert tat.log_rows() == jat.log_rows()


def test_chaos_matrix_on_the_cpu():
    rows = tfaults.run_matrix(device="cpu")
    assert [r.ok for r in rows] == [True] * 8, [r.detail for r in rows]
    assert [c.__name__ for c in tfaults.CASES] == \
        [c.__name__ for c in jfaults.CASES]
    # the rows carry the reference's names, sites and attribution keys
    import inspect
    for case, row in zip(tfaults.CASES, rows):
        src = inspect.getsource(getattr(jfaults, case.__name__))
        for field in (row.fault, row.site, row.kind, row.guard_key):
            assert f'"{field}"' in src, (case.__name__, field)
    assert tfaults.SITES == jfaults.SITES


def test_matrix_cli_reports_the_unported_case(capsys):
    """Nothing is left unported: the CLI's summary reads as the
    reference's, over every case it ran."""
    assert tfaults.main(["--matrix", "--only", "ckpt", "collective",
                         "--device", "cpu", "--fail-on-undetected"]) == 0
    text = capsys.readouterr().out
    assert "3/3 fault classes detected and survived" in text
    assert "PASS  collective-drop-contrib" in text
    assert "NOT PORTED" not in text and "not ported" not in text
