"""The port's dry run (``repro_torch.launch.dryrun``), ``input_specs``
(``repro_torch.configs.registry``) and roofline renderer
(``repro_torch.benchmarks.roofline``) against the JAX package's: every
input spec's shape and dtype on every registry architecture and shape (the
decode caches' tree included); params on ``meta``; the meta-trace counter
against ``FlopCounterMode``; ``lower_cell`` in process on the SMOKE
configs, its numbers against the reference's own functions on the
reference's abstract mesh and its argument bytes against the reference's
partition specs; the CLI on the reference's failing cell; and
``roofline_rows`` against the reference's renderer on the same records."""
import ast
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import input_specs as j_input_specs
from repro.kernels import stats as jstats
from repro.launch import flops as jflops
from repro.launch import hlo_analysis as jha
from repro.launch.mesh import make_abstract_mesh as j_abstract
from repro.models.transformer import lm_init as j_lm_init
from repro.optim.optimizer import adamw_init as j_adamw_init
from repro.sharding import partition as jpart
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs.base import ALL_SHAPES as T_SHAPES
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.registry import input_specs as t_input_specs
from repro_torch.device import resolve_device
from repro_torch.kernels import stats as tstats
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import flops as tflops
from repro_torch.models.transformer import lm_init as t_lm_init
from repro_torch.optim.optimizer import adamw_init as t_adamw_init

REPO = os.path.join(os.path.dirname(__file__), "..")
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16}
# One shape of each kind, small enough for a test (a train cell with two
# microbatches on the 16x16 mesh, so that it is traced at one sequence).
SMALL = (("train", 1024, 256), ("prefill", 512, 32), ("decode", 512, 128))
# The record's keys that differ from the reference's: ``memory`` is
# rebuilt from the partition specs (``fits_16g`` → ``fits_hbm``), the
# compiler's keys are absent, and the port adds the meta trace's and the
# record's provenance.
ABSENT = {"lower_s", "compile_s", "hlo_static_flops", "hlo_static_bytes",
          "collectives_static", "hlo_lines"}
ADDED = {"opt_dtype", "shard_stash", "donate", "unroll_decode", "layout",
         "sources", "memory_source", "counted_flops", "counted_at",
         "count_s", "counted_on", "counted_flops_per_device"}
REF_KEYS = {"arch", "shape", "kind", "mesh", "n_chips", "params_b",
            "active_params_b", "fsdp", "tag", "pure_dp", "schedule",
            "lower_s", "compile_s", "memory", "hlo_static_flops",
            "hlo_static_bytes", "collectives_static", "hlo_lines",
            "analytic", "model_flops", "roofline", "ok", "total_s"}


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _j_leaves(tree):
    return [(jax.tree_util.keystr(kp), tuple(x.shape), DTYPES[x.dtype])
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _t_leaves(tree):
    return [(kp, tuple(x.shape), x.dtype)
            for kp, x in ttree.leaves_with_paths(tree)]


@pytest.mark.parametrize("shape_i", range(len(J_SHAPES)),
                         ids=[s.name for s in J_SHAPES])
@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_input_specs_equal(arch, shape_i):
    want = j_input_specs(J_ARCHS[arch], J_SHAPES[shape_i])
    got = t_input_specs(T_ARCHS[arch], T_SHAPES[shape_i])
    assert all(t.device.type == "meta" for t in ttree.leaves(got))
    assert _t_leaves(got) == _j_leaves(want)


@functools.lru_cache(maxsize=None)
def _j_params(arch, smoke=False):
    cfg = (J_SMOKE if smoke else J_ARCHS)[arch]
    return jax.eval_shape(lambda: j_lm_init(jax.random.key(0), cfg))


@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_meta_params_and_opt_state_equal(arch):
    got = t_lm_init(0, T_ARCHS[arch], device="meta")
    assert _t_leaves(got) == _j_leaves(_j_params(arch))
    want_opt = jax.eval_shape(
        lambda p: j_adamw_init(p, moment_dtype=jnp.bfloat16),
        _j_params(arch))
    got_opt = t_adamw_init(got, moment_dtype=torch.bfloat16)
    assert _t_leaves(got_opt) == _j_leaves(want_opt)


def test_meta_device_and_wrappers_take_the_plain_version():
    from repro_torch.kernels import bitmap_scan, relu_encode
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        resolve_device("xla")
    z = torch.empty(256, 96, device="meta")
    y, bits = relu_encode.relu_encode(z, (8, 32))
    assert y.device.type == bits.device.type == "meta"
    assert tuple(bits.shape) == tuple(relu_encode.relu_encode_plain(
        torch.zeros(256, 96), (8, 32))[1].shape)
    assert bitmap_scan.bitmap_scan(z, (8, 32)).device.type == "meta"
    assert relu_encode.launches == bitmap_scan.launches == 0


# ---------------------------------------------------------------------------
# The meta-trace counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(T_SMOKE))
def test_meta_counter_equals_flop_counter_mode(arch):
    cfg = T_SMOKE[arch]
    params = tflops.param_shapes(cfg)
    for kind in ("train", "prefill", "decode"):
        shape = TShape("t", 64, 2, kind)
        got, at = tdry.count_step_flops(cfg, shape, params, microbatches=1)
        want, _ = tdry.count_step_flops(
            cfg, shape, params, microbatches=1,
            counter=FlopCounterMode(display=False))
        assert at == "full batch"
        assert got == want > 0, (kind, got, want)


def test_meta_counter_keeps_host_tensors_on_the_host():
    """A pure op repeated on host tensors of a meta op's shapes, strides
    and dtypes runs on the host: the remembered outputs are meta's."""
    counter = tdry.MetaFlopCounter()
    with counter:
        a = torch.ones(4, 8, device="meta") + torch.ones(4, 8, device="meta")
        b = torch.ones(4, 8) + torch.ones(4, 8)
        c = torch.ones(4, 8, device="meta") + torch.ones(4, 8, device="meta")
    assert a.device.type == c.device.type == "meta"
    assert b.device.type == "cpu" and torch.equal(b, torch.full((4, 8), 2.))


# ---------------------------------------------------------------------------
# lower_cell against the reference's functions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_pick_microbatches():
    """The reference's ``pick_microbatches``, compiled from its source:
    importing ``repro.launch.dryrun`` would set XLA_FLAGS to 512 host
    devices in this process."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    module = ast.parse(open(path).read())
    fn = next(n for n in module.body if isinstance(n, ast.FunctionDef)
              and n.name == "pick_microbatches")
    ns = {"partition": jpart, "ShapeConfig": JShape}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["pick_microbatches"]


def _j_bytes(tree, specs, mesh):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, s in zip(leaves, spec_leaves):
        n = 1
        for entry in s:
            if entry is not None:
                n *= jpart.axis_size(mesh, entry)
        total += math.prod(x.shape) * x.dtype.itemsize // n
    return total


def _j_argument_bytes(arch, jshape, mesh, fsdp, opt_dtype):
    cfg = J_SMOKE[arch]
    params = _j_params(arch, smoke=True)
    out = {"params_bytes": _j_bytes(
        params, jpart.params_pspecs(params, mesh, fsdp=fsdp), mesh)}
    specs = j_input_specs(cfg, jshape)
    if jshape.kind == "train":
        opt = jax.eval_shape(lambda p: j_adamw_init(
            p, moment_dtype=jnp.dtype(opt_dtype)), params)
        out["opt_state_bytes"] = _j_bytes(
            opt, jpart.opt_state_pspecs(opt, params, mesh, fsdp=fsdp), mesh)
    if jshape.kind == "decode":
        out["cache_bytes"] = _j_bytes(
            specs["caches"], jpart.cache_pspecs(specs["caches"], mesh), mesh)
        batch = {k: v for k, v in specs.items() if k != "caches"}
        out["batch_bytes"] = sum(
            _j_bytes(v, JP() if k == "index" else jpart.batch_pspecs(v, mesh),
                     mesh) for k, v in batch.items())
    else:
        out["batch_bytes"] = _j_bytes(specs, jpart.batch_pspecs(specs, mesh),
                                      mesh)
    return out


def _check_record(rec, arch, kind, t, b, fsdp=False, opt_dtype="float32"):
    jcfg = J_SMOKE[arch]
    jshape = JShape(f"{kind}_small", t, b, kind)
    mesh = j_abstract((16, 16), ("data", "model"))
    assert set(rec) - ADDED == (REF_KEYS - ABSENT) | (
        {"microbatches"} if kind == "train" else set())
    assert rec["ok"] and rec["memory_source"] == "specs"
    assert rec["sources"]["counted_flops"] == "meta trace"
    assert "count_error" not in rec, rec.get("count_traceback")
    assert rec["counted_flops"] > 0
    params = _j_params(arch, smoke=True)
    n = float(sum(np.prod(x.shape) for x in jax.tree.leaves(params)))
    n_active = jha.active_param_count(params, jcfg)
    assert rec["params_b"] == n / 1e9
    assert rec["active_params_b"] == n_active / 1e9
    assert rec["fsdp"] == fsdp
    mb = _j_pick_microbatches()(jcfg, jshape, mesh)
    assert rec.get("microbatches", 1) == mb
    if kind == "train":
        assert mb == 2 and rec["counted_at"] == "1 sequence × B"
    dp_n = jpart.axis_size(mesh, jpart.dp_axis_names(mesh))
    ac = jflops.analytic_cost(jcfg, jshape, dp_n=dp_n,
                              model_n=jpart.axis_size(mesh, "model"),
                              microbatches=mb, fsdp=fsdp)
    assert rec["analytic"] == {
        "flops_per_device": ac.flops_per_device,
        "hbm_bytes_per_device": ac.hbm_bytes_per_device,
        "coll_bytes_per_device": ac.coll_bytes_per_device,
        "detail": {k: float(v) for k, v in ac.detail.items()}}
    assert rec["model_flops"] == jha.model_flops(jcfg, jshape, n_active)
    want = _j_argument_bytes(arch, jshape, mesh, fsdp, opt_dtype)
    mem = rec["memory"]
    for k, v in want.items():
        assert mem[k] == v, (k, mem[k], v)
    assert mem["argument_size_in_bytes"] == sum(want.values())
    assert mem["fits_hbm"] and mem["temp_size_in_bytes"] is None
    rl = rec["roofline"]
    assert rl["peak_flops"] == 989e12 and rl["hbm_bw"] == 3.35e12
    assert rl["compute_s"] == ac.flops_per_device / 989e12


@pytest.mark.parametrize("arch", list(T_SMOKE))
def test_lower_cell_matches_the_reference(arch):
    for kind, t, b in SMALL:
        rec = tdry.lower_cell(arch, T_SMOKE[arch], TShape(f"{kind}_small", t,
                                                          b, kind),
                              multi_pod=False, smoke=True)
        _check_record(rec, arch, kind, t, b)


def test_lower_cell_fsdp_bf16_moments_and_sparse_ffn():
    kind, t, b = SMALL[0]
    shape = TShape(f"{kind}_small", t, b, kind)
    rec = tdry.lower_cell("grok-1-314b", T_SMOKE["grok-1-314b"], shape,
                          multi_pod=False, smoke=True, fsdp=True,
                          opt_dtype="bfloat16")
    _check_record(rec, "grok-1-314b", kind, t, b, fsdp=True,
                  opt_dtype="bfloat16")
    # --sparse-ffn: the relu2 FFN through the sparse units, plain on meta
    cfg = T_SMOKE["seamless-m4t-medium"].with_(
        ffn_activation="relu2", sparse_ffn_scenario="IN_OUT")
    rec = tdry.lower_cell("seamless-m4t-medium", cfg, shape,
                          multi_pod=True, smoke=True)
    assert rec["ok"] and rec["counted_flops"] > 0, rec.get("count_traceback")
    assert tstats.counts().get("gemm:dense:1", 0) > 0


def test_cli_runs_the_reference_failing_cell(tmp_path):
    out = tmp_path / "cell.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-1.6b", "--shape", "train_4k", "--mesh", "multi",
         "--smoke", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    assert "[ok]" in run.stdout and "0 failed" in run.stdout
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["mesh"] == "2x16x16" and rec["n_chips"] == 512
    assert rec["counted_flops"] > 0 and rec["memory_source"] == "specs"


def test_cli_jobs_keep_the_cells_in_order(tmp_path):
    out = tmp_path / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "stablelm-1.6b,gemma3-12b", "--shape",
         "decode_32k,long_500k,train_4k", "--mesh", "single", "--jobs",
         "2", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    # the train cells run first (the longest traces) but are written in
    # the cells' order
    assert [(r["arch"], r["shape"], bool(r.get("skipped"))) for r in recs] \
        == [("stablelm-1.6b", "decode_32k", False),
            ("stablelm-1.6b", "long_500k", True),
            ("stablelm-1.6b", "train_4k", False),
            ("gemma3-12b", "decode_32k", False),
            ("gemma3-12b", "long_500k", False),
            ("gemma3-12b", "train_4k", False)]
    assert "5 ok (0 with count_error), 0 failed, 1 skipped" in run.stdout
    assert [tdry._trace_tokens(s) for s in T_SHAPES] \
        == [3 * 4096, 32768, 1, 1]


def test_roofline_rows_match_the_reference_renderer(tmp_path):
    from repro_torch.benchmarks import roofline as troof
    spec = importlib.util.spec_from_file_location(
        "reference_roofline", os.path.join(REPO, "benchmarks",
                                           "roofline.py"))
    jroof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jroof)
    path = tmp_path / "dryrun.jsonl"
    with open(path, "w") as f:
        for arch in ("smollm-360m", "gemma3-12b"):
            for kind, t, b in SMALL[1:]:
                shape = TShape("train_4k" if kind == "prefill" else kind,
                               t, b, kind)
                for multi in (False, True):
                    f.write(json.dumps(tdry.lower_cell(
                        arch, T_SMOKE[arch], shape, multi_pod=multi,
                        smoke=True)) + "\n")
        f.write(json.dumps({"arch": "x", "shape": "y", "mesh": "16x16",
                            "skipped": True, "reason": "r"}) + "\n")
    got, got_sum = troof.roofline_rows(str(path), "16x16")
    want, want_sum = jroof.roofline_rows(str(path), "16x16")
    assert len(got) == 4 and got_sum == want_sum
    for g, w in zip(got, want):
        assert g.pop("fits_hbm") is True and w.pop("fits_16g") is None
        assert g == w
    assert troof.markdown_table(str(path)).count("\n") == 5


def test_path_row_bounds_a_measured_path():
    from repro_torch.benchmarks import roofline as troof
    cfg, shape = T_ARCHS["smollm-360m"], TShape("train_8x128", 128, 8,
                                                "train")
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        row = troof.path_row("smollm", cfg, shape, 150.0, dtype="float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    # bounded at the remat the path ran: the config's own (True)
    ac = tflops.analytic_cost(cfg, shape, dp_n=1, model_n=1)
    assert row["remat"] is True
    assert row["flops"] == ac.flops_per_device
    assert row["peak_flops"] == 67e12 and row["dominant"] == "compute"
    assert row["bound_ms"] == ac.flops_per_device / 67e12 * 1e3
    assert row["roofline_fraction"] == row["bound_ms"] / 150.0
    tick = troof.path_row("tick", T_ARCHS["gemma3-12b"],
                          TShape("decode_4x256", 256, 4, "decode"), None,
                          dtype="bfloat16")
    assert tick["dominant"] == "memory" and tick["roofline_fraction"] is None
    table = troof.paths_table([row, tick])
    assert "not measured" in table and table.count("\n") == 3
