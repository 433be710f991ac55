"""The port's wall-clock harness (``repro_torch.benchmarks.wallclock``)
against the reference's ``benchmarks/wallclock.py``, on the CPU.

* ``measure`` takes the warm-up calls out of the timed window;
* ``cnn_gemm_dims`` gives the reference's dims at every geometry the
  harness uses;
* the three checkers give the reference's error lists on the port's own
  smoke documents and on the reference tests' mutations of them;
* the port's smoke documents (BENCH_9 on 4 gloo CPU ranks) pass the
  reference's checkers;
* the scripted autotune session equals the reference's in selections,
  counters and decision log, and ``autotune_audit`` (in ``run.TABLES``)
  gives the reference's summary.

No committed result file is read.
"""
import copy
import dataclasses
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

from benchmarks import kernel_audit as jaudit
from benchmarks import wallclock as jwc
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro_torch.benchmarks import kernel_audit as taudit
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import wallclock as twc
from repro_torch.benchmarks.common import GEOMETRIES
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats

LIVE_FRAC_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_both_packages():
    for s, a in ((jstats, jautotune), (tstats, tautotune)):
        s.reset()
        a.reset()
    yield
    for s, a in ((jstats, jautotune), (tstats, tautotune)):
        s.reset()
        a.reset()


@pytest.fixture(scope="module")
def ref_session():
    return jwc.autotune_session()


@pytest.fixture(scope="module")
def port_session():
    return twc.autotune_session(device="cpu")


@pytest.fixture(scope="module")
def port_docs():
    """The port's three smoke documents, and whether runtime counting was
    on again after the collective table."""
    docs = {"BENCH_7": twc.run_bench(smoke=True, device="cpu"),
            "BENCH_8": twc.run_emit_bench(smoke=True, device="cpu"),
            "BENCH_9": twc.run_collective_bench(smoke=True, device="cpu")}
    return docs, tstats.set_runtime_counting(True)


# ---------------------------------------------------------------------------
# measure(): warm-up excluded, fenced, median-of-k
# ---------------------------------------------------------------------------

def test_measure_excludes_compile_and_reports_median():
    calls = {"n": 0}

    def fake_compile_then_fast():
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.05)               # the "first-use build" call
        return torch.zeros(())

    out = twc.measure(fake_compile_then_fast, warmup=1, reps=5)
    assert calls["n"] == 6                 # warmup + reps, nothing more
    assert set(out) == {"us_median", "us_iqr", "reps", "warmup"}
    # a harness that timed the first call would report >= 50ms here
    assert 0 < out["us_median"] < 25_000
    assert out["us_iqr"] >= 0


def test_barrier_runs_before_every_call_outside_the_window():
    seen = []
    times = twc._samples(lambda: seen.append("call"), warmup=2, reps=3,
                         before=lambda: (seen.append("before"),
                                         time.sleep(0.05)))
    assert seen == ["before", "call"] * 5
    assert len(times) == 3 and max(times) < 25_000


# ---------------------------------------------------------------------------
# Workload dims and the session's mask generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geo", [
    dict(image_size=8, width=0.125, batch=2),            # gemm, smoke
    dict(image_size=10, width=0.25, batch=2),            # gemm, full
    dict(image_size=32, width=0.5, batch=2, layer="pw1", net="mobilenet"),
    dict(image_size=32, width=0.5, batch=8, layer="pw1", net="mobilenet"),
], ids=["gemm_smoke", "gemm_full", "emit_smoke", "emit_full"])
def test_cnn_gemm_dims_equal_the_reference(geo):
    assert twc.cnn_gemm_dims(**geo) == jwc.cnn_gemm_dims(**geo)


@pytest.mark.parametrize("seed,live,shape", [
    (0, 0.25, (4, 3)), (17, 1.0, (2, 2)), (29, 0.25, (4, 3)),
    (123_456, 0.6, (5, 7))])
def test_session_masks_are_the_references_draws(seed, live, shape):
    _, _, ko = jax.random.split(jax.random.key(seed), 3)
    kb, _ = jax.random.split(ko)
    want = np.asarray(jax.random.bernoulli(kb, live, shape))
    _, _, tko = twc._tf_split(twc._tf_key(seed), 3)
    tkb, _ = twc._tf_split(tko, 2)
    np.testing.assert_array_equal(twc._tf_bernoulli(tkb, live, shape), want)


# ---------------------------------------------------------------------------
# The autotune session and its audit table
# ---------------------------------------------------------------------------

def test_autotune_session_equals_the_reference(ref_session, port_session):
    jsel, jlog, jc = ref_session
    tsel, tlog, tc = port_session
    assert tc == jc == {"hits": 21, "misses": 3, "retunes": 6}
    assert tsel == jsel

    def by_phase(sel):
        out = {}
        for s in sel:
            out.setdefault(s["phase"], []).append(s["schedule"])
        return out
    assert by_phase(tsel) == by_phase(jsel)
    assert len(tlog) == len(jlog)
    for t, j in zip(tlog, jlog):
        assert set(t) == set(jwc.AUTOTUNE_LOG_KEYS) == set(j)
        for k in ("seq", "event", "key", "shape", "groups", "schedule",
                  "block", "samples"):
            assert t[k] == j[k], (k, t, j)
        for k in ("live_frac", "operand_frac"):
            assert (t[k] is None) == (j[k] is None), (k, t, j)
            if j[k] is not None:
                assert abs(t[k] - j[k]) <= LIVE_FRAC_ATOL, (k, t, j)


def test_autotune_audit_runs_in_tables_with_the_references_summary(
        ref_session, monkeypatch):
    assert trun.TABLES["autotune_audit"] is taudit.autotune_audit
    cap = dataclasses.replace(GEOMETRIES["reference"], device="cpu")
    rows, summary = trun.TABLES["autotune_audit"](cap)
    # The reference's table over its own session (already run for this
    # module): its assertions and summary string.
    monkeypatch.setattr(jwc, "autotune_session", lambda: ref_session)
    jrows, jsummary = jaudit.autotune_audit()
    assert summary == jsummary
    assert [r["event"] for r in rows] == [r["event"] for r in jrows]


# ---------------------------------------------------------------------------
# The checkers: the reference's error lists on every document
# ---------------------------------------------------------------------------

def _errors_both(checker: str, doc: dict):
    got, want = getattr(twc, checker)(doc), getattr(jwc, checker)(doc)
    assert got == want
    return got


def _drop_compact_gemm(d):
    d["rows"][:] = [r for r in d["rows"]
                    if not (r["table"] == "gemm"
                            and r["schedule"] == "compact")]


@pytest.mark.parametrize("mutate,frag", [
    (None, None),
    (lambda d: d.pop("autotune"), "missing top-level"),
    (lambda d: d["rows"][0].pop("us_median"), "key drift"),
    (lambda d: d["rows"][0].update(extra=1), "key drift"),
    (_drop_compact_gemm, "missing schedules"),
    (lambda d: d["autotune"].update(log=[]), "not traceable"),
], ids=["clean", "no_autotune", "no_median", "extra_key", "no_compact",
        "empty_log"])
def test_bench7_checker_equals_the_reference(port_docs, port_session,
                                             mutate, frag):
    docs, _ = port_docs
    selections, log, counters = port_session
    doc = copy.deepcopy({**docs["BENCH_7"], "autotune": {
        "counters": counters, "selections": selections, "log": log}})
    if mutate is not None:
        mutate(doc)
    errs = _errors_both("check_schema", doc)
    assert (not errs) if frag is None else any(frag in e for e in errs), \
        (frag, errs)


def _fused_slow_at_full(d):
    d["geometry"] = "full"
    next(r for r in d["rows"] if r["variant"] == "fused").update(
        us_median=10 ** 9)


@pytest.mark.parametrize("mutate,frag", [
    (None, None),
    (lambda d: d.pop("rows"), "missing top-level"),
    (lambda d: d["rows"][0].pop("emit_gran"), "key drift"),
    (lambda d: d["rows"][0].update(extra=1), "key drift"),
    (lambda d: d["rows"].__setitem__(
        slice(None), [r for r in d["rows"] if r["variant"] != "gemm_scan"]),
     "missing cells"),
    (_fused_slow_at_full, "not faster"),
], ids=["clean", "no_rows", "no_emit_gran", "extra_key", "no_gemm_scan",
        "fused_slow_full"])
def test_bench8_checker_equals_the_reference(port_docs, mutate, frag):
    docs, _ = port_docs
    doc = copy.deepcopy(docs["BENCH_8"])
    if mutate is not None:
        mutate(doc)
    errs = _errors_both("check_emit_schema", doc)
    assert (not errs) if frag is None else any(frag in e for e in errs), \
        (frag, errs)


def _bench9_doc(geometry, us, m=512, n=256, block="32x256", reps=3,
                warmup=1):
    rows = [{"table": "collective", "mesh": "8", "devices": 8, "m": m,
             "n": n, "block": block, "live_frac": live,
             "cutoff": twc.COLLECTIVE_CUTOFF, "variant": variant,
             "us_median": us[variant], "us_iqr": 1.0, "reps": reps,
             "warmup": warmup}
            for live in twc.COLLECTIVE_LIVE_FRACS
            for variant in twc.COLLECTIVE_VARIANTS]
    return {"schema_version": twc.SCHEMA_VERSION, "bench": "BENCH_9",
            "jax_backend": "cpu", "geometry": geometry, "rows": rows}


EVEN = {"dense_psum": 100.0, "bitmap": 100.0}
BITMAP_LOSES = {"dense_psum": 100.0, "bitmap": 150.0}
FULL = dict(m=8192, n=2048, block="128x2048", reps=7, warmup=2)


@pytest.mark.parametrize("doc,mutate,frags", [
    (_bench9_doc("smoke", EVEN), None, ()),
    (_bench9_doc("smoke", EVEN),
     lambda d: [r.update(extra=1) for r in d["rows"]], ("key drift",)),
    (_bench9_doc("smoke", EVEN),
     lambda d: [r.update(variant="gossip") for r in d["rows"]],
     ("variant",)),
    (_bench9_doc("smoke", EVEN), lambda d: d["rows"].__delitem__(
        slice(2, None)), ("coverage",)),
    # smoke documents are exempt from the claim …
    (_bench9_doc("smoke", BITMAP_LOSES, **FULL), None, ()),
    # … full documents are not: losing at the lowest live fraction and
    # past the cutoff both fail
    (_bench9_doc("full", BITMAP_LOSES, **FULL), None,
     ("not faster", "fallback")),
], ids=["clean", "extra_key", "gossip", "two_rows", "smoke_claim_exempt",
        "full_claim"])
def test_bench9_checker_equals_the_reference(doc, mutate, frags):
    doc = copy.deepcopy(doc)
    if mutate is not None:
        mutate(doc)
    errs = _errors_both("check_collective_schema", doc)
    assert bool(errs) == bool(frags), errs
    for frag in frags:
        assert any(frag in e for e in errs), (frag, errs)


def test_port_collective_document_equals_on_its_own_rows(port_docs):
    docs, _ = port_docs
    doc = copy.deepcopy(docs["BENCH_9"])
    doc["geometry"] = "full"          # the claim, on the port's CPU medians
    _errors_both("check_collective_schema", doc)


# ---------------------------------------------------------------------------
# The port's smoke documents
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bench,checker", [
    ("BENCH_7", "check_schema"), ("BENCH_8", "check_emit_schema"),
    ("BENCH_9", "check_collective_schema")])
def test_port_smoke_documents_pass_both_checkers(port_docs, bench, checker):
    docs, _ = port_docs
    doc = docs[bench]
    assert (doc["bench"], doc["jax_backend"], doc["geometry"]) == \
        (bench, "cpu", "smoke")
    assert twc._checker_for(doc) is getattr(twc, checker)
    assert _errors_both(checker, doc) == []


def test_port_collective_rows_cover_both_meshes_on_four_ranks(port_docs):
    docs, counting_was = port_docs
    rows = docs["BENCH_9"]["rows"]
    assert counting_was is True       # restored after the table
    assert {r["mesh"] for r in rows} == {"4", "2x2"}
    assert {r["devices"] for r in rows} == {twc.COLLECTIVE_RANKS}
    assert len(rows) == 2 * len(twc.COLLECTIVE_LIVE_FRACS) * len(
        twc.COLLECTIVE_VARIANTS)
    assert {(r["m"], r["n"], r["block"]) for r in rows} == {
        (512, 256, "32x256")}


def test_port_gemm_rows_cover_every_schedule(port_docs):
    docs, _ = port_docs
    rows = docs["BENCH_7"]["rows"]
    for fam in ("cnn", "ffn"):
        assert {r["schedule"] for r in rows if r["table"] == "gemm"
                and r["workload"].startswith(fam)} == set(twc.SCHEDULES)
    train = {r["workload"]: r for r in rows if r["table"] == "train_step"}
    assert set(train) == {"cnn:vgg16", "ffn:relu"}
    assert train["ffn:relu"]["params"] == 2 * 16 * 32


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_cli_writes_beside_its_outputs_and_checks(tmp_path, capsys):
    out7, out8 = tmp_path / "b7.json", tmp_path / "b8.json"
    assert twc.main(["--smoke", "--device", "cpu", "--out", str(out7),
                     "--emit-out", str(out8)]) == 0
    for name in ("b7.json", "b8.json", "wallclock_gemm.csv",
                 "wallclock_train_step.csv", "wallclock_emit.csv",
                 "wallclock_autotune.csv"):
        assert (tmp_path / name).exists(), name
    assert twc.main(["--check", str(out7)]) == 0
    assert jwc.main(["--check", str(out8)]) == 0
    with pytest.raises(SystemExit):
        twc.main(["--smoke", "--device", "cpu", "--out",
                  os.path.join(ROOT, "BENCH_TORCH_7.json")])
    assert not os.path.exists(os.path.join(ROOT, "BENCH_TORCH_7.json"))
