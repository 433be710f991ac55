"""The paper's tables from the port (``repro_torch.benchmarks``) against the
reference's ``benchmarks/`` package, on the CPU.

* ``capture_traces`` after 0 and 1 steps at a tiny geometry, both packages
  fed the same numpy batches and the reference's weights: activations at
  1e-5, densities at 1e-6.
* ``build_cost_inputs``, ``layer_speedups``, ``network_totals``, every
  figure and the audits that read captures or shapes give the reference's
  rows from the SAME captured activations: the reference's
  ``capture_traces`` is monkeypatched (in each of its modules) to return
  the port's captures.  Timing columns are left out of the comparison.
* ``python -m repro_torch.benchmarks.run --device cpu ...`` exits 0.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from benchmarks import common as jcommon
from benchmarks import figures as jfigures
from benchmarks import kernel_audit as jaudit
from repro.kernels import stats as jstats
from repro.models import cnn as jcnn
from repro_torch import cnn_training
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import figures as tfigures
from repro_torch.benchmarks import kernel_audit as taudit
from repro_torch.kernels import stats as tstats
from repro_torch.models.cnn import params_from_jax


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


# ---------------------------------------------------------------------------
# capture_traces against the reference's
# ---------------------------------------------------------------------------

def _np_batch(step, batch, image_size, num_classes):
    rng = np.random.default_rng(100 + step)
    img = rng.standard_normal((batch, image_size, image_size, 3)) \
        .astype(np.float32)
    img -= img.mean(axis=(1, 2, 3), keepdims=True)
    return img, rng.integers(0, num_classes, batch).astype(np.int32)


def _ref_batch(seed, step, *, batch, image_size, num_classes=100, **_):
    img, lbl = _np_batch(step, batch, image_size, num_classes)
    return jnp.asarray(img), jnp.asarray(lbl)


def _port_batch(seed, step, *, batch, image_size, num_classes=100,
                device="cuda", **_):
    img, lbl = _np_batch(step, batch, image_size, num_classes)
    return torch.tensor(img, device=device), torch.tensor(lbl, device=device)


TINY = dict(image_size=16, width=0.125, batch=2)


@pytest.mark.parametrize("net,train_steps", [
    ("vgg16", 1), ("resnet18", 0), ("resnet18", 1), ("googlenet", 0),
    ("googlenet", 1)])
def test_capture_traces_match_reference(net, train_steps, monkeypatch):
    monkeypatch.setattr(jcommon, "image_batch", _ref_batch)
    monkeypatch.setattr(cnn_training, "image_batch", _port_batch)
    monkeypatch.setattr(tcommon, "image_batch", _port_batch)
    # the reference's capture, uncached
    jacts, jdens = jcommon.capture_traces.__wrapped__(
        net, train_steps=train_steps, **TINY)
    jparams = jax.tree.map(np.asarray, jcnn.build_cnn(
        net, image_size=TINY["image_size"], width=TINY["width"],
        num_classes=100).init(jax.random.key(0)))
    cap = tcommon.Capture(train_steps=train_steps, device="cpu", **TINY)
    tacts, tdens = tcommon.capture_traces(
        net, cap, params=params_from_jax(jparams, "cpu"))
    assert list(tacts) == list(jacts)
    for k in jacts:
        np.testing.assert_allclose(tacts[k], jacts[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert abs(tdens[k] - jdens[k]) <= 1e-6, k
    assert (net, cap) not in tcommon._RUNS      # given params: not cached


def test_capture_run_is_cached_per_capture():
    cap = tcommon.Capture(train_steps=0, device="cpu", **TINY)
    try:
        first = tcommon.capture_run("resnet18", cap)
        assert tcommon.capture_run("resnet18", cap) is first
        other = tcommon.capture_run("resnet18", dataclasses.replace(
            cap, policy="IN_OUT_WR", kernel_impl="pallas"))
        assert other is not first and list(other.acts) == list(first.acts)
        assert first.steps == [] and set(first.dens) == set(first.acts)
    finally:
        tcommon.clear_captures()
    assert not tcommon._RUNS


# ---------------------------------------------------------------------------
# Every table from the same captured activations
# ---------------------------------------------------------------------------

CAP = tcommon.Capture(train_steps=1, image_size=16, width=0.125,
                      num_classes=10, batch=2, device="cpu")
NETS = ("vgg16", "googlenet", "resnet18", "densenet121", "mobilenet")


@pytest.fixture(scope="module")
def shared_captures():
    """The port's captures of all five networks; the reference's
    ``capture_traces`` returns the same arrays."""
    caps = {net: tcommon.capture_traces(net, CAP) for net in NETS}
    yield caps
    tcommon.clear_captures()


@pytest.fixture
def same_captures(shared_captures, monkeypatch):
    def fake(name, **_):
        acts, dens = shared_captures[name]
        return acts, dens
    for mod in (jcommon, jfigures, jaudit):
        monkeypatch.setattr(mod, "capture_traces", fake)
    return shared_captures


@pytest.mark.parametrize("net", NETS)
def test_cost_inputs_and_totals_match_reference(net, same_captures):
    jspecs, jtraces = jcommon.build_cost_inputs(net)
    tspecs, ttraces = tcommon.build_cost_inputs(net, CAP)
    assert [dataclasses.asdict(s) for s in tspecs] == \
        [dataclasses.asdict(s) for s in jspecs]
    for jt, tt in zip(jtraces, ttraces):
        for f in ("x_density", "g_in_density", "out_mask_density"):
            assert getattr(tt, f) == getattr(jt, f), f
        for f in ("fp_active_map", "bp_active_map"):
            a, b = getattr(tt, f), getattr(jt, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b)
    for phase in ("fp", "bp", "wg"):
        assert tcommon.layer_speedups(net, CAP, phase=phase) == \
            jcommon.layer_speedups(net, phase=phase)
    assert tcommon.network_totals(net, CAP) == jcommon.network_totals(net)


@pytest.mark.parametrize("name", sorted(tfigures.ALL_FIGURES))
def test_figure_rows_match_reference(name, same_captures):
    assert sorted(jfigures.ALL_FIGURES) == sorted(tfigures.ALL_FIGURES)
    jrows, jderived = jfigures.ALL_FIGURES[name]()
    trows, tderived = tfigures.ALL_FIGURES[name](CAP)
    assert trows == jrows
    assert tderived == jderived


def _without(rows, prefix):
    return [{k: v for k, v in r.items() if not k.startswith(prefix)}
            for r in rows]


@pytest.mark.parametrize("name", ["kernel_audit", "queue_cost_audit",
                                  "launch_shape_audit"])
def test_audit_rows_match_reference(name, same_captures):
    """The audits that read captures or shapes (bitmap_op_audit and
    depthwise_audit are in tests/test_torch_paper_audits.py)."""
    jrows, jderived = getattr(jaudit, name)()
    trows, tderived = getattr(taudit, name)(CAP)
    if name == "queue_cost_audit":           # times differ by nature
        jrows, trows = _without(jrows, "us_"), _without(trows, "us_")
    if name == "launch_shape_audit":         # the port adds its CUDA plan
        assert all(set(t) - set(j) == {"cuda_path", "cuda_splits",
                                       "cuda_grid_blocks"}
                   for t, j in zip(trows, jrows))
        trows = _without(trows, "cuda_")
    assert trows == jrows
    assert tderived == jderived


def test_launch_shape_audit_reports_the_cuda_plan():
    from repro_torch.kernels import masked_matmul as mm
    rows, _ = taudit.launch_shape_audit(CAP)
    dw = [r for r in rows if r["layer"] == "dw1" and r["stage"] == "bp_dx"]
    assert dw and all(r["cuda_path"] == "group_rows" for r in dw)
    for r in rows:
        block = tuple(int(e) for e in r["block"].split("x"))
        dims = (r["groups"], r["m"], r["k"], r["n"])
        assert r["cuda_splits"] == mm.split_plan(*dims, block) >= 1
        assert r["cuda_grid_blocks"] == mm.grid_blocks(*dims, block)


def test_run_cli_named_tables_exit_0(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--device",
         "cpu", "--out", str(tmp_path), "queue_cost_audit",
         "launch_shape_audit"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "name,us_total,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        ["queue_cost_audit", "launch_shape_audit"]
    assert "queues_match_reference=True" in lines[1]
    assert "geometry_ok=True" in lines[2]
    assert sorted(os.listdir(tmp_path)) == ["launch_shape_audit.csv",
                                            "queue_cost_audit.csv"]


def test_run_cli_named_table_error_fails_the_run(tmp_path, monkeypatch,
                                                 capsys):
    from repro_torch.benchmarks import run

    def broken(cap):
        raise AssertionError("planted")

    monkeypatch.setitem(run.TABLES, "fig16_reconfig", broken)
    assert run.main(["--device", "cpu", "--out", str(tmp_path),
                     "fig16_reconfig"]) == 1
    assert "fig16_reconfig,ERROR" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "no_such_table"])
