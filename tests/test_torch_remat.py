"""Per-period rematerialisation in the port (``cfg.remat``, ROADMAP A22):
each encoder layer and each decoder period's body checkpointed as the
reference's ``jax.checkpoint`` does (``models.common.remat``), its
recomputation counting nothing again and replaying the first forward's
decisions (``kernels.stats.remat_scopes``).

Held here, on the CPU at the SMOKE configs: the port at ``remat=True``
against the reference at ``remat=True`` (loss and every gradient leaf at
1e-5, f32, the reference's weights carried by ``params_from_jax``); the
port at ``remat=True`` equal to the port at ``remat=False`` in values,
count dicts, registry hits and autotune decisions; fewer bytes saved for
the backward; the meta trace's extra FLOPs exactly one forward of the
checkpointed regions; the trace audit's codes equal to the reference's
``audit_fn``'s; ``make_train_step`` with microbatches; one TP/FSDP
``train_loop`` on 4 gloo ranks; ``chip_smoke.py``'s phase 14 rehearsed.

Known difference: the reference counts its events at trace time, and
``jax.checkpoint`` traces each encoder layer's forward again in the
backward pass, so at ``remat=True`` its count dict of seamless's smoke
step holds 4 more ``gemm:dense:1`` and 2 more ``scan:act`` than at
``remat=False`` (the scanned decoder periods are traced once either
way).  The port counts the step's work once at both settings, as the
reference does at ``remat=False``.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.analysis import jaxpr_audit as jta
from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.launch import steps as jsteps
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro_torch import tree as ttree
from repro_torch.analysis import trace_audit as tta
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import policy as tpol
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import flops as tflops
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizer as topt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-5
SEAMLESS = "seamless-m4t-medium"
# (reference arch, sparse_ffn_scenario): seamless dense and IN_OUT_WR,
# the dense decoder, the MoE config, and the Mamba hybrid
CASES = {
    "seamless": (SEAMLESS, None),
    "seamless-in-out-wr": (SEAMLESS, "IN_OUT_WR"),
    "smollm": ("smollm-360m", None),
    "deepseek-moe": ("deepseek-v2-lite-16b", None),
    "jamba-mamba": ("jamba-1.5-large-398b", None),
}
# jamba's SSM/MoE layers amplify f32 rounding beyond 1e-5 in both
# packages (tests/test_torch_lm.py's GRAD_TOL): 1e-4 there
GRAD_TOL = {"jamba-mamba": 1e-4}
# The audit policy: IN_OUT_WR on the kernels at a small block, as the
# audit's own workloads take it, registered in both packages under a
# scenario name of its own.
AUDIT_SCENARIO = "IN_OUT_WR_AUDIT"


@pytest.fixture(autouse=True)
def _reset():
    for s in (jstats, tstats):
        s.reset()
    tautotune.reset()
    yield
    for s in (jstats, tstats):
        s.reset()
    tautotune.reset()
    tstats.set_recompute_hook(None)


@pytest.fixture
def scenario(monkeypatch):
    """Register ``name`` → the IN_OUT_WR policy with ``changes`` in both
    packages' scenario tables for the test."""
    def register(name, jchanges, tchanges):
        monkeypatch.setitem(jpol.SCENARIOS, name,
                            jpol.IN_OUT_WR.with_(**jchanges))
        monkeypatch.setitem(tpol.SCENARIOS, name,
                            tpol.IN_OUT_WR.with_(**tchanges))
        return name
    return register


def _cfgs(case, remat=True, **kw):
    arch, scen = CASES[case]
    return (J_SMOKE[arch].with_(remat=remat, sparse_ffn_scenario=scen, **kw),
            T_SMOKE[arch].with_(remat=remat, sparse_ffn_scenario=scen, **kw))


def _batch(cfg, b=2, t=17, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.enc_dec or cfg.frontend:
        out["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(tcfg, seed=0):
    """f32 weights for both packages as numpy: the port's ``lm_init``,
    whose tree is the reference's (``params_from_jax`` maps one onto the
    other), at a fraction of the reference's eager init's time."""
    return ttree.tree_map(lambda t: t.numpy(), ttr.lm_init(
        seed, tcfg, dtype=torch.float32, device="cpu"))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(cfg, params, batch):
    leaves = [x.detach().requires_grad_(True) for x in ttree.leaves(params)]
    loss = ttr.lm_loss(ttree.unflatten_like(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.detach().numpy() - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# The port at remat=True against the reference at remat=True
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_the_reference_at_remat(case):
    jcfg, tcfg = _cfgs(case)
    pn = _weights(tcfg)
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr.lm_loss(p, b, jcfg)))(
            pn, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = _loss_and_grads(tcfg, ttr.params_from_jax(pn, device="cpu"),
                             _torch_batch(batch))
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    jl_ = jax.tree.leaves(jg)
    assert len(tg) == len(jl_)
    for got, want in zip(tg, jl_):
        _close(got, want, GRAD_TOL.get(case, TOL))


# ---------------------------------------------------------------------------
# The port at remat=True equal to the port at remat=False
# ---------------------------------------------------------------------------

# Port-only configs beside CASES: (SMOKE arch, param dtype)
PORT_ONLY = {"xlstm": ("xlstm-350m", torch.float32),
             "internvl2-frontend": ("internvl2-1b", torch.float32),
             "jamba-bf16": ("jamba-1.5-large-398b", torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(PORT_ONLY))
def test_remat_equals_no_remat_bit_for_bit(case):
    """Loss, every gradient leaf and the count dict (registry hits and
    misses among its keys) equal at both settings; xlstm's mLSTM/sLSTM
    stack, internvl2's ViT frontend and jamba's bf16 params too."""
    out = {}
    for remat in (False, True):
        if case in PORT_ONLY:
            arch, dtype = PORT_ONLY[case]
            tcfg = T_SMOKE[arch].with_(remat=remat)
        else:
            (_, tcfg), dtype = _cfgs(case, remat=remat), torch.float32
        params = ttr.lm_init(0, tcfg, dtype=dtype, device="cpu")
        tstats.reset()
        loss, grads = _loss_and_grads(tcfg, params,
                                      _torch_batch(_batch(tcfg)))
        out[remat] = (loss, grads, tstats.counts())
    (l0, g0, c0), (l1, g1, c1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c0 == c1


def test_kernel_path_counts_registry_and_autotune_decisions(scenario):
    """seamless's ReLU FFN on the kernels' plain versions with the
    autotuner on: three AdamW steps at each setting give the same losses,
    params, count dicts (encode, queues, GEMMs, emits, registry hits and
    misses) and autotune decision logs.  The CPU observes every dispatch
    at once, so a recomputation that resolved or observed again would
    move the log."""
    name = scenario("AUTOTUNED", {}, dict(kernel_impl="pallas",
                                          block=(8, 8, 8), autotune=True))
    out = {}
    for remat in (False, True):
        cfg = T_SMOKE[SEAMLESS].with_(remat=remat, sparse_ffn_scenario=name)
        params = ttr.lm_init(0, cfg, dtype=torch.float32, device="cpu")
        opt = topt.adamw_init(params)
        step = tsteps.make_train_step(cfg, topt.OptConfig())
        tstats.reset()
        tautotune.reset(min_samples=2)
        losses = []
        for i in range(3):
            params, opt, m = step(params, opt, _torch_batch(
                _batch(cfg, seed=i)))
            losses.append(float(m["loss"]))
        out[remat] = (losses, params, tstats.counts(),
                      tautotune.get_cache().log)
    (l0, p0, c0, log0), (l1, p1, c1, log1) = out[False], out[True]
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in
               zip(ttree.leaves(p0), ttree.leaves(p1)))
    assert c0 == c1 and c0["encode:act"] > 0
    assert c0["registry:hit"] > 0 and c0["registry:miss"] > 0
    assert log0 == log1
    events = {r["event"] for r in log0}
    assert "default" in events and events & {"measured", "retune"}


def test_recomputed_preactivations_equal_the_first_forwards(scenario,
                                                            monkeypatch):
    """Each recomputed FFN pre-activation (the K1 encode's input) equals
    the first forward's bit for bit: the recomputation encodes once per
    FFN, and its ``encode:act`` is not counted again."""
    from repro_torch.core import sparse_linear
    name = scenario("KERNELS", {}, dict(kernel_impl="pallas",
                                        block=(8, 8, 8)))
    seen = {False: [], True: []}
    real = sparse_linear._encode_act

    def encode(x_pre, policy, gran):
        seen[tstats.recomputing()].append(x_pre.detach().clone())
        return real(x_pre, policy, gran)
    monkeypatch.setattr(sparse_linear, "_encode_act", encode)
    cfg = T_SMOKE[SEAMLESS].with_(remat=True, sparse_ffn_scenario=name)
    params = ttr.lm_init(0, cfg, dtype=torch.float32, device="cpu")
    tstats.reset()
    _loss_and_grads(cfg, params, _torch_batch(_batch(cfg)))
    first, again = seen[False], seen[True]
    assert len(first) == len(again) == cfg.n_enc_layers + cfg.n_layers
    assert tstats.counts()["encode:act"] == len(first)
    for x in again:
        assert sum(torch.equal(x, y) for y in first) == 1


def test_reference_counts_the_encoder_twice_at_remat():
    """The known difference, stated: the reference's seamless smoke step
    counts 4 more dense GEMMs and 2 more scans at remat=True (its encoder
    traced again in the backward); the port counts the same at both
    settings."""
    def ref_counts(remat):
        jcfg, tcfg = _cfgs("seamless-in-out-wr", remat=remat)
        pn = _weights(tcfg)
        jstats.reset()           # counted at trace time: trace only
        jax.make_jaxpr(jax.value_and_grad(
            lambda p, b: jtr.lm_loss(p, b, jcfg)))(
                pn, {k: jnp.asarray(v) for k, v in _batch(jcfg).items()})
        return jstats.counts()

    def port_counts(remat):
        _, tcfg = _cfgs("seamless-in-out-wr", remat=remat)
        tstats.reset()
        _loss_and_grads(tcfg, ttr.lm_init(0, tcfg, dtype=torch.float32,
                                          device="cpu"),
                        _torch_batch(_batch(tcfg)))
        return tstats.counts()

    off, on = ref_counts(False), ref_counts(True)
    assert {k: on[k] - off.get(k, 0) for k in on} == {"gemm:dense:1": 4,
                                                      "scan:act": 2}
    assert port_counts(True) == port_counts(False)


# ---------------------------------------------------------------------------
# What remat saves, what it costs, where it nests
# ---------------------------------------------------------------------------

def _saved_bytes(cfg, params, batch):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    leaves = [x.detach().requires_grad_(True) for x in ttree.leaves(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttr.lm_loss(ttree.unflatten_like(params, leaves), batch, cfg)
    return total[0]


@pytest.mark.parametrize("case", ["seamless-in-out-wr", "smollm"])
def test_remat_saves_fewer_bytes_for_the_backward(case):
    got = {}
    for remat in (False, True):
        _, tcfg = _cfgs(case, remat=remat)
        params = ttr.lm_init(0, tcfg, dtype=torch.float32, device="cpu")
        got[remat] = _saved_bytes(tcfg, params, _torch_batch(
            _batch(tcfg, b=2, t=65)))
    assert 0 < got[True] < got[False] / 2, got


def test_nested_checkpoints_recompute_once_per_backward(monkeypatch):
    """The attention q-chunk and Mamba chunk checkpoints nest inside the
    period's: with remat each chunk body runs once more (the period's
    recomputation), so 3 times a step against 2 without; none twice
    within one recomputation."""
    calls = {"q": 0, "ssm": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap
    monkeypatch.setattr(tattn, "_one_q_chunk",
                        counted("q", tattn._one_q_chunk))
    monkeypatch.setattr(tssm, "_chunk_body",
                        counted("ssm", tssm._chunk_body))
    got = {}
    for remat in (False, True):
        cfg = T_SMOKE["jamba-1.5-large-398b"].with_(remat=remat)
        params = ttr.lm_init(0, cfg, dtype=torch.float32, device="cpu")
        calls.update(q=0, ssm=0)
        with torch.no_grad():
            ttr.lm_loss(params, _torch_batch(_batch(cfg)), cfg)
        once = dict(calls)
        calls.update(q=0, ssm=0)
        _loss_and_grads(cfg, params, _torch_batch(_batch(cfg)))
        got[remat] = {k: v / once[k] for k, v in calls.items()}
        assert min(once.values()) > 0
    assert got == {False: {"q": 2, "ssm": 2}, True: {"q": 3, "ssm": 3}}


@pytest.mark.parametrize("arch", [SEAMLESS, "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_meta_flop_delta_is_one_forward_of_the_regions(arch, monkeypatch):
    """The dry run's counted FLOPs of a train cell on meta: remat=True
    less remat=False is exactly the forward matmul FLOPs of the
    checkpointed regions (every encoder layer and decoder period), counted
    region by region in the remat=False step."""
    shape = ShapeConfig("train_4k", 64, 2, "train")
    counter = tdry.MetaFlopCounter()
    regions = [0]

    def counted(fn):
        def wrap(*a, **k):
            before = counter.get_total_flops()
            out = fn(*a, **k)
            regions[0] += counter.get_total_flops() - before
            return out
        return wrap

    counts = {}
    for remat in (False, True):
        cfg = T_SMOKE[arch].with_(remat=remat)
        ps = tflops.param_shapes(cfg)
        with monkeypatch.context() as m:
            if not remat:
                m.setattr(ttr, "_period_body", counted(ttr._period_body))
                m.setattr(ttr, "_encoder_layer",
                          counted(ttr._encoder_layer))
            counts[remat], _ = tdry.count_step_flops(
                cfg, shape, ps, microbatches=1,
                counter=counter if not remat else None)
    assert regions[0] > 0
    assert counts[True] - counts[False] == regions[0]


def test_path_row_bounds_at_the_remat_it_ran():
    from repro_torch.benchmarks import roofline as troof
    from repro_torch.configs import ARCHS as T_ARCHS
    shape = ShapeConfig("train_8x128", 128, 8, "train")
    rows = {r: troof.path_row("p", T_ARCHS["smollm-360m"].with_(remat=r),
                              shape, 100.0, dtype="float32")
            for r in (False, True)}
    assert rows[True]["remat"] and not rows[False]["remat"]
    for r, row in rows.items():
        ac = tflops.analytic_cost(T_ARCHS["smollm-360m"].with_(remat=r),
                                  shape, dp_n=1, model_n=1)
        assert row["flops"] == ac.flops_per_device
    assert rows[True]["flops"] > rows[False]["flops"]


# ---------------------------------------------------------------------------
# Recomputation scope: counts, replay, tags, hooks
# ---------------------------------------------------------------------------

def test_recompute_scope_counts_nothing_and_replays():
    fwd, rec = tstats.remat_scopes()
    draws = iter(range(100))
    with fwd:
        tstats.record("encode:act")
        tstats.record_live_tiles("k", 0.5)
        first = [tstats.replayed_call(lambda: next(draws)) for _ in range(3)]
        assert not tstats.recomputing()
    for _ in range(2):                   # a second backward replays again
        with rec:
            assert tstats.recomputing()
            assert tstats.open_tags()[-1].startswith("repro:remat:")
            tstats.record("encode:act")
            tstats.record_live_tiles("k", 0.9)
            tstats.record_on_device("fallback:queue_overflow",
                                    torch.ones(2, dtype=torch.bool))
            again = [tstats.replayed_call(lambda: next(draws))
                     for _ in range(3)]
        assert again == first
    assert tstats.counts() == {"encode:act": 1}
    assert tstats.live_tile_stats("k") == (0.5, 1.0, 1)
    assert not tstats.recomputing() and tstats.open_tags() == ()


def test_moe_routing_hook_runs_once_a_layer_under_remat():
    """The routing hook (the float64 check's seam) sees each MoE layer's
    routing once a step: the recomputation replays the first forward's
    routing and capacity drops without calling it."""
    seen = {}
    for remat in (False, True):
        cfg = T_SMOKE["deepseek-v2-lite-16b"].with_(remat=remat)
        params = ttr.lm_init(0, cfg, dtype=torch.float32, device="cpu")
        names = []
        prev = tmoe.set_routing_hook(
            lambda n, t: names.append((n, t.clone())) or t)
        try:
            _loss_and_grads(cfg, params, _torch_batch(_batch(cfg)))
        finally:
            tmoe.set_routing_hook(prev)
        seen[remat] = names
    assert len(seen[True]) == len(seen[False]) > 0
    for (n0, t0), (n1, t1) in zip(seen[False], seen[True]):
        assert n0 == n1 and torch.equal(t0, t1)


def test_profile_summary_splits_out_the_recomputed_regions():
    """``profile_step``'s summary of a remat step: the ``repro:remat:``
    ranges the backward thread opens, the host time inside them and the
    device time of the work launched from inside them, apart from the
    layer ranges."""
    from repro_torch.profile_step import summarize_trace

    def rng(name, tid, ts, dur):
        return {"cat": "user_annotation", "name": name, "tid": tid,
                "ts": ts, "dur": dur}

    def launch(corr, tid, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, dur):
        return {"cat": "kernel", "name": "gemm", "tid": 7,
                "ts": 1000 + corr, "dur": dur, "args": {"correlation": corr}}

    # the forward on thread 1; two recomputed regions on the backward's
    # thread 2 with one launch each, and one backward launch between them
    events = [rng("layer:forward", 1, 0, 50), rng("repro:remat:3", 2, 100, 20),
              rng("repro:remat:9", 2, 150, 30),
              launch(1, 1, 10), launch(2, 2, 110), launch(3, 2, 130),
              launch(4, 2, 160), launch(5, 1, 115),
              kernel(1, 1000), kernel(2, 2000), kernel(3, 4000),
              kernel(4, 500), kernel(5, 250)]
    res = summarize_trace(events)
    assert res["remat"] == {"regions": 2, "host_ms": 0.05,
                            "device_ms": 2.5,
                            "runtime": [("cudaLaunchKernel", 0.002, 2)]}
    assert res["busy_ms"] == 7.75
    no_remat = summarize_trace(events[:1] + events[3:])
    assert no_remat["remat"] == {"regions": 0, "host_ms": 0.0,
                                 "device_ms": 0.0, "runtime": []}


# ---------------------------------------------------------------------------
# The trace audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
def test_audit_codes_equal_the_references(kernels, scenario):
    """A remat=True step of seamless's smoke config: the port's trace
    audit gives the reference's ``audit_fn`` codes, with the FFN on the
    masked plain path (DENSE_SCHEDULE expected) and on the kernels."""
    if kernels:
        name = scenario(AUDIT_SCENARIO,
                        dict(kernel_impl="pallas", block=(8, 8, 8)),
                        dict(kernel_impl="pallas", block=(8, 8, 8)))
    else:
        name = "IN_OUT_WR"
    jcfg = J_SMOKE[SEAMLESS].with_(remat=True, sparse_ffn_scenario=name)
    tcfg = T_SMOKE[SEAMLESS].with_(remat=True, sparse_ffn_scenario=name)
    pn = _weights(tcfg)
    batch = _batch(jcfg)
    ref = jta.audit_fn(jax.value_and_grad(
        lambda p, b: jtr.lm_loss(p, b, jcfg)), pn,
        {k: jnp.asarray(v) for k, v in batch.items()}, workload="remat")

    def step(p, b):
        return _loss_and_grads(tcfg, p, b)
    _, trace = tta.trace_fn(step, ttr.params_from_jax(pn, device="cpu"),
                            _torch_batch(batch))
    port = tta.audit_trace(trace, workload="remat")
    assert sorted({v.code for v in port}) == sorted({v.code for v in ref})
    regions = trace.region_counts()
    assert regions["remat"] == tcfg.n_enc_layers + tcfg.n_layers
    assert any(op.remat for op in trace.ops)
    if kernels:
        # every encode of the first forward once more in the recomputation
        encodes = [r for r in trace.regions().values()
                   if r[0].tag.kind == "encode"]
        assert sum(r[0].remat for r in encodes) * 2 == len(encodes)


def test_rescan_spares_a_recomputed_encode_of_the_same_activation():
    """RESCAN: a second encode of one tensor in one layer is a violation,
    unless it runs inside a recomputation (a ``repro:remat`` tag)."""
    z = torch.randn(16, 16)

    def twice(recompute):
        fwd, rec = tstats.remat_scopes()
        with tstats.layer_scope("ffn_down"):
            tops.relu_encode(z, block=(8, 8))
            with (rec if recompute else fwd):
                tops.relu_encode(z, block=(8, 8))

    codes = {r: [v.code for v in tta.audit_fn(twice, r)]
             for r in (False, True)}
    assert codes == {False: ["RESCAN"], True: []}


# ---------------------------------------------------------------------------
# Steps, microbatches, TP/FSDP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_the_reference_and_no_remat(microbatches):
    """Three AdamW steps of seamless's IN_OUT_WR smoke config: the port at
    remat=True bit-equal to the port at remat=False, and its loss and
    gradient norm within TOL of the reference's remat=True step."""
    jcfg, tcfg = _cfgs("seamless-in-out-wr")
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt.OptConfig(**ocfg), microbatches=microbatches))
    jp = jax.tree.map(jnp.asarray, _weights(tcfg, seed=1))
    jo = jopt.adamw_init(jp)
    states = {r: (ttr.params_from_jax(_np_tree(jp), device="cpu"),
                  ttr.params_from_jax(_np_tree(jo), device="cpu"))
              for r in (False, True)}
    tsteps_ = {r: tsteps.make_train_step(tcfg.with_(remat=r),
                                         topt.OptConfig(**ocfg),
                                         microbatches=microbatches)
               for r in (False, True)}
    for i in range(3):
        batch = _batch(jcfg, b=4, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        ms = {}
        for r in (False, True):
            p, o, ms[r] = tsteps_[r](*states[r], _torch_batch(batch))
            states[r] = (p, o)
        for k in ("loss", "grad_norm"):
            assert float(ms[True][k]) == float(ms[False][k])
            assert abs(float(ms[True][k]) - float(jm[k])) <= \
                TOL * abs(float(jm[k]))
    for a, b in zip(ttree.leaves(states[False]), ttree.leaves(states[True])):
        assert torch.equal(a, b)


N_RANKS = 4


def _rank_tp_loops():
    """One rank of the (2, 2) ("data", "model") mesh: three FSDP
    ``train_loop`` steps at each setting; then one step's gradients on
    the FSDP layout at remat=False, and at remat=True with the backward
    pass on a thread of its own, where the sharding rules (kept per
    thread) were never installed, as on autograd's device threads."""
    import threading
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding import partition
    from repro_torch.sharding.context import sharding_rules
    mesh = init_mesh((2, 2), ("data", "model"), backend="gloo", device="cpu")
    base = T_SMOKE["smollm-360m"].with_(vocab_size=49152)
    out = {}
    for remat in (False, True):
        tcfg = TrainConfig(total_steps=3, checkpoint_every=0,
                           learning_rate=1e-3, seed=3)
        res = train_loop(base.with_(remat=remat), tcfg, batch_size=4,
                         seq_len=8, steps=3, log_every=0, device="cpu",
                         mesh=mesh, fsdp=True)
        out[remat] = (res["losses"], [
            partition.full(x).numpy() for x in ttree.leaves(res["params"])])

    params = ttr.lm_init(3, base, dtype=torch.float32, device="cpu")
    params = partition.place(params, partition.params_shardings(
        params, mesh, fsdp=True))
    batch = lm_batch(3, 0, batch=4, seq_len=8, vocab=base.vocab_size,
                     device="cpu")
    batch = partition.place(batch, partition.to_shardings(
        partition.batch_pspecs(batch, mesh), mesh))
    rules = {**partition.activation_rules(mesh), "__mesh__": mesh}

    def grads(remat, threaded):
        leaves = [x.detach().requires_grad_(True)
                  for x in ttree.leaves(params)]
        got = []
        with partition.placed_scope(params), sharding_rules(rules):
            loss = ttr.lm_loss(ttree.unflatten_like(params, leaves), batch,
                               base.with_(remat=remat))

            def backward():
                try:
                    got.append(torch.autograd.grad(loss, leaves))
                except Exception as e:           # re-raised on this thread
                    got.append(e)

            def backward_in(scope):
                # autograd's device threads inherit the caller's C++
                # thread-local state (DTensor's implicit replication), not
                # Python's threading.local (the sharding rules)
                with scope:
                    backward()
            if threaded:
                t = threading.Thread(target=lambda: backward_in(
                    partition.placed_scope(params)))
                t.start()
                t.join(timeout=300)
                assert not t.is_alive()
            else:
                backward()
        if isinstance(got[0], Exception):
            raise got[0]
        return [partition.full(g).numpy() for g in got[0]]
    out["grads"] = (grads(False, False), grads(True, True))
    return out


def test_tp_and_fsdp_train_loop_equal_at_both_settings():
    """``train_loop(mesh=..., fsdp=True)`` on a (2, 2) ("data", "model")
    mesh of 4 gloo CPU ranks, DTensor params under the non-reentrant
    checkpoint (the ``local_map`` regions and ``context.reshape`` inside
    each period): three steps at remat=True equal to remat=False on every
    rank; and a backward pass run on another thread than the forward's
    recomputes under the forward's rules (``models.common.remat``
    restores them), its gradients equal to remat=False's."""
    from repro_torch.launch.mesh import RankPool
    with RankPool(N_RANKS, backend="gloo", device="cpu") as pool:
        rows = pool.run(_rank_tp_loops)
    for r in rows:
        l0, p0 = r[False]
        l1, p1 = r[True]
        assert l0 == l1
        assert all(np.array_equal(a, b) for a, b in zip(p0, p1))
        g0, g1 = r["grads"]
        assert len(g0) == len(g1) > 0
        assert all(np.array_equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("path", ["seamless", "smollm"])
def test_chip_smoke_phase14_rehearses_on_the_cpu(path, monkeypatch):
    """Phase 14's checks at the SMOKE configs on the CPU (no kernel
    launches, no peak): every check passes, the planted fault included."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        monkeypatch.setattr(chip_smoke, "FAILURES", [])
        names = {"seamless": "lm_remat_seamless",
                 "smollm": "lm_remat_smollm360m"}
        out = chip_smoke.remat_phase(torch.device("cpu"), small=True,
                                     paths=(names[path],))
        assert list(out) == [names[path]]
        assert chip_smoke.FAILURES == []
    finally:
        sys.path.remove(ROOT)
