"""The port's lifecycle audit and lint (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``), case for case of
``tests/test_analysis.py``: the same violation codes on the same numpy
inputs — ``[]`` on each of the five standard workloads, the same code on
each planted fault — and, per workload, the regions of each kind that the
port's executed step shows against those of the reference's jaxpr walk.

The port's audit RUNS the step (under a ``TorchDispatchMode``); the
reference only traces it.  So where the reference's jaxpr holds both sides
of a ``lax.cond``, the port's log holds the side the step took: the one
pinned difference, in ``ffn_relu_spmd``'s collective regions.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

from repro.analysis import jaxpr_audit as jta
from repro.analysis import lint as jlint
from repro.core import policy as jpol
from repro.core.sparse_tensor import coarsen_bitmap as j_coarsen
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.kernels import stats as jstats
from repro.models.cnn import build_cnn as j_build_cnn
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro.models.ffn import ffn_init as j_ffn_init
from repro.sharding import spmd_step as j_spmd
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import trace_audit as tta
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.core import policy as tpol
from repro_torch.core.sparse_tensor import coarsen_bitmap as t_coarsen
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stats as tstats
from repro_torch.models.cnn import params_from_jax
from repro_torch.optim import compression as tcomp
from repro_torch.sharding import collectives as tcoll

J_POLICY = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
T_POLICY = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    jautotune.reset()
    tstats.reset()
    tautotune.reset()
    yield
    jstats.reset()
    jautotune.reset()
    tstats.reset()
    tautotune.reset()


def codes(violations):
    return sorted({v.code for v in violations})


# ---------------------------------------------------------------------------
# The five standard workloads, on the same numpy inputs in both packages
# ---------------------------------------------------------------------------

CNN_GEOM = {"vgg16": ("vgg16", 0.125), "mobilenet": ("mobilenet", 0.25),
            "vgg16_spmd": ("vgg16", 0.125)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_mesh():
    return jax.make_mesh((1,), ("data",))


def _cnn_pair(name):
    """(reference thunk, port step context) on the same params and batch."""
    net, width = CNN_GEOM[name]
    images, labels = tta.cnn_batch(16, 2, 10, seed=0)
    model = j_build_cnn(net, image_size=16, width=width, num_classes=10)
    params = model.init(jax.random.PRNGKey(0))
    pt = params_from_jax(_np_tree(params), "cpu")
    ji, jl = jnp.asarray(images), jnp.asarray(labels)
    if name.endswith("_spmd"):
        f = j_spmd.make_spmd_grad_fn(
            lambda p, b: model.loss(p, b["images"], b["labels"], J_POLICY),
            _ref_mesh())
        ref = lambda: f(params, {"images": ji, "labels": jl})  # noqa: E731

        def port():
            with tta.world_of_one("cpu") as mesh:
                yield tta.cnn_spmd_step(mesh, net, image_size=16,
                                        width=width, device="cpu",
                                        params=pt, images=images,
                                        labels=labels)
    else:
        ref = lambda: jax.grad(  # noqa: E731
            lambda p: model.loss(p, ji, jl, J_POLICY))(params)

        def port():
            yield tta.cnn_step(net, image_size=16, width=width,
                               device="cpu", params=pt, images=images,
                               labels=labels)
    return ref, port


def _ffn_pair(name):
    cfg_j = tta.ffn_config()
    from repro.models.ffn import FFNConfig as JFFNConfig
    jcfg = JFFNConfig(d_model=cfg_j.d_model, d_ff=cfg_j.d_ff,
                      activation="relu", sparse_policy=J_POLICY)
    params = j_ffn_init(jax.random.PRNGKey(0), jcfg)
    pt = {k: torch.tensor(np.asarray(v)).requires_grad_(True)
          for k, v in params.items()}
    x = np.random.RandomState(0).randn(4, jcfg.d_model).astype(np.float32)
    jx = jnp.asarray(x)

    def loss(p, xb):
        return (j_ffn_apply(p, xb, jcfg) ** 2).sum()

    if name.endswith("_spmd"):
        f = j_spmd.make_spmd_grad_fn(loss, _ref_mesh())
        ref = lambda: f(params, jx)  # noqa: E731

        def port():
            with tta.world_of_one("cpu") as mesh:
                yield tta.ffn_spmd_step(mesh, device="cpu", params=pt, x=x)
    else:
        ref = lambda: jax.grad(lambda p: loss(p, jx))(params)  # noqa: E731

        def port():
            yield tta.ffn_step(device="cpu", params=pt, x=x)
    return ref, port


def _ref_regions(thunk):
    with jops.collect_gemm_events() as events:
        closed = jax.make_jaxpr(thunk)()
    walk = jta._Walk(closed)
    regions = jta._region_map(walk.infos)
    kinds = {}
    for eqns in regions.values():
        t = eqns[0].tag
        key = f"{t.kind}:{t.detail}" if t.detail else t.kind
        kinds[key] = kinds.get(key, 0) + 1
    return jta.audit_jaxpr(closed, workload="ref"), kinds, len(events)


# The port runs one side of each lax.cond the reference traces whole:
# ffn_relu_spmd's two WG leaves take either the compressed all-reduce or
# its dense fallback (the reference's jaxpr holds both, 2 + 2), and the
# port all-reduces both leaves' bitmaps in one flat buffer (the
# reference: one bitmap psum a leaf).
PINNED = {"ffn_relu_spmd": [(("collective:bitmap",), 2, 1),
                            (("collective:compressed", "collective:dense"),
                             4, 2)]}


@pytest.mark.parametrize("name", sorted(tta.WORKLOADS))
def test_workload_clean_with_the_reference_regions(name):
    ref_thunk, port_ctx = (_ffn_pair if name.startswith("ffn")
                           else _cnn_pair)(name)
    ref_vs, ref_kinds, ref_specs = _ref_regions(ref_thunk)
    ctx = port_ctx()
    step = next(ctx)
    try:
        out, trace = tta.trace_fn(step)
    finally:
        ctx.close()
    vs = tta.audit_trace(trace, workload=name)
    assert codes(vs) == codes(ref_vs) == []
    got = trace.region_counts(detail=True)
    assert len(trace.gemm_specs) == ref_specs
    assert all(s.origin == "policy" for s in trace.gemm_specs)
    # One encode region per counted encode, one gemm region per dispatch.
    c = tstats.counts()
    assert got.get("encode:act", 0) == c.get("encode:act", 0) > 0
    assert sum(v for k, v in got.items() if k.startswith("gemm:")) \
        == len(trace.gemm_specs)
    pinned = PINNED.get(name, [])
    for names, want_ref, want_port in pinned:
        assert sum(ref_kinds.get(k, 0) for k in names) == want_ref
        assert sum(got.get(k, 0) for k in names) == want_port
    pinned_keys = {k for names, _, _ in pinned for k in names}
    assert {k: v for k, v in got.items() if k not in pinned_keys} \
        == {k: v for k, v in ref_kinds.items() if k not in pinned_keys}


def test_audited_step_equals_unaudited():
    """The mode only observes: loss and gradients bit-equal."""
    step = tta.cnn_step("vgg16", image_size=16, width=0.125, device="cpu")
    loss, grads = step()
    (loss_a, grads_a), _ = tta.trace_fn(step)
    assert torch.equal(loss, loss_a)
    assert all(torch.equal(g, h) for g, h in zip(grads, grads_a))


def test_audit_workloads_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tta.audit_workloads(["ffn_relu"])


# ---------------------------------------------------------------------------
# Planted faults in the trace, the same numpy inputs to both packages
# ---------------------------------------------------------------------------

def _rescan(ops, like):
    def f(dy):
        b1 = ops.bitmap_scan(dy, block=(8, 8), kind="grad")
        b2 = ops.bitmap_scan(dy, block=(8, 8), kind="grad")  # the fault
        return b1.sum() + b2.sum()
    return f


def _derive(ops, coarsen):
    def f(dy):
        b = ops.bitmap_scan(dy, block=(8, 8), kind="grad")
        return coarsen(b, (1, 1), (2, 2)).sum()
    return f


def _dense(ops, _):
    return lambda x, w: (x @ w).sum()


def _adhoc(ops, _):
    def f(x, w):
        spec = ops.GemmSpec(block=(8, 8, 8), schedule="predicated")
        bm = ops.bitmap_scan(x, block=(8, 8), kind="act")
        return ops.sparse_gemm(x, w, (bm, None), spec).sum()
    return f


def _hand_rolled(ops, policy, xp):
    def f(x, w):
        if xp is jnp:
            bm = (jnp.abs(x[:8, :8]).sum() > 0).astype(jnp.int32) \
                * jnp.ones((2, 2), jnp.int32)
        else:
            bm = (x[:8, :8].abs().sum() > 0).to(torch.int32) \
                * torch.ones((2, 2), dtype=torch.int32)
        spec = policy.gemm_spec(dims=(16, 16, 16))
        return ops.sparse_gemm(x, w, (bm, None), spec).sum()
    return f


def _dense_schedule(ops, policy):
    def f(x, w):
        bm = ops.bitmap_scan(x, block=(8, 8), kind="act")
        spec = policy.gemm_spec(dims=(16, 16, 16))
        return ops.sparse_gemm(x, w, (bm, None), spec).sum()
    return f


PLANTS = {
    # name: (reference fn, port fn, inputs, codes required in both)
    "rescanned_dy_bitmap": (_rescan(jops, None), _rescan(tops, None), 1,
                            ["RESCAN"]),
    "scan_then_derive": (_derive(jops, j_coarsen), _derive(tops, t_coarsen),
                         1, []),
    "dense_fallback_gemm": (_dense(jops, None), _dense(tops, None), 2,
                            ["DENSE_GEMM"]),
    "adhoc_spec": (_adhoc(jops, None), _adhoc(tops, None), 2,
                   ["SPEC_UNRESOLVED"]),
    "hand_rolled_mask": (_hand_rolled(jops, J_POLICY, jnp),
                         _hand_rolled(tops, T_POLICY, torch), 2,
                         ["UNDERIVED_MASK"]),
    "dense_schedule": (
        _dense_schedule(jops, jpol.IN_OUT.with_(kernel_impl="xla")),
        _dense_schedule(tops, tpol.IN_OUT.with_(kernel_impl="xla_ref")), 2,
        ["DENSE_SCHEDULE"]),
}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_planted_trace_faults(name):
    ref_fn, port_fn, n_in, want = PLANTS[name]
    r = np.random.RandomState(7)
    arrays = [r.randn(16, 16).astype(np.float32) for _ in range(n_in)]
    ref = jta.audit_fn(ref_fn, *map(jnp.asarray, arrays), workload="mut",
                       expect_pallas=True)
    port = tta.audit_fn(port_fn, *map(torch.from_numpy, arrays),
                        workload="mut", expect_kernels=True)
    if want:
        assert set(want) <= set(codes(ref)) and set(want) <= set(codes(port))
    else:
        assert ref == [] and port == []


def test_untagged_collective_caught():
    """An all-reduce outside any collective region: COLLECTIVE_UNTAGGED in
    both packages (the reference inside a one-device shard_map, the port
    on a gloo world of one rank); the tagged reduce is clean."""
    import torch.distributed as dist

    x = np.random.RandomState(8).randn(8, 8).astype(np.float32)
    mesh = _ref_mesh()
    untagged = shard_map(lambda v: jax.lax.psum(v, "data"), mesh=mesh,
                         in_specs=JP(), out_specs=JP(), check_rep=False)
    ref = jta.audit_fn(untagged, jnp.asarray(x), workload="mut")
    with tta.world_of_one("cpu") as tmesh:
        xt = torch.from_numpy(x)
        port = tta.audit_fn(lambda v: dist.all_reduce(v.clone()), xt,
                            workload="mut")
        clean = tta.audit_fn(
            lambda v: tcoll.dense_psum(v, "data", mesh=tmesh), xt,
            workload="ok")
    assert "COLLECTIVE_UNTAGGED" in codes(ref)
    assert "COLLECTIVE_UNTAGGED" in codes(port)
    assert clean == []


def test_compressed_psum_tagged_and_counted():
    """compressed_psum's all-reduce goes through sharding/collectives in a
    collective region: the same values, f32 bytes on the wire counted, no
    COLLECTIVE_UNTAGGED, and no collective:* count."""
    r = np.random.RandomState(9)
    grads = {"a": torch.from_numpy(r.randn(6, 5).astype(np.float32)),
             "b": torch.from_numpy(r.randn(7).astype(np.float32))}
    err = tcomp.init_error_state(grads)
    want = {}
    for k, g in grads.items():
        q, scale, e1 = tcomp.quantize(g, err[k])
        want[k] = (tcomp.dequantize(q, scale), e1)
    with tta.world_of_one("cpu") as mesh:
        tcoll.reset_wire_bytes()
        (mean, new_err), trace = tta.trace_fn(
            lambda: tcomp.compressed_psum(grads, err, mesh, "data"))
        wire = tcoll.wire_bytes()
    for k in grads:
        assert torch.equal(mean[k], want[k][0])
        assert torch.equal(new_err[k], want[k][1])
    assert wire == 4 * (6 * 5 + 7)
    assert tta.audit_trace(trace) == []
    assert not any(k.startswith("collective:") for k in tstats.counts())


# ---------------------------------------------------------------------------
# The lint: the same codes on the same sources (the port's dense conv is
# F.conv2d where the reference's is lax.conv_general_dilated)
# ---------------------------------------------------------------------------

LINT_CASES = {
    "loose_kwarg_callsite": (
        "y = relu_matmul(x, w, compact=True, queue_builder='argsort')\n",
        None, "src/{pkg}/core/sparse_linear.py", ["LOOSE_KWARG"]),
    "loose_kwargs_in_spec_construction": (
        "spec = policy.gemm_spec(dims=dims)\n"
        "p2 = SparsityPolicy(queue_builder='prefix_sum')\n"
        "p3 = p2.with_(queue_builder='argsort')\n",
        None, "src/{pkg}/core/x.py", []),
    "shim_call": ("out = ops.masked_matmul(a, b, m)\n", None,
                  "src/{pkg}/models/x.py", ["SHIM_CALL"]),
    "shim_ref_exemption": ("want = ref.masked_matmul(a, b, m)\n", None,
                           "tests/x.py", []),
    "shim_call_in_kernels": ("out = masked_matmul(a, b, m)\n", None,
                             "src/{pkg}/kernels/ops.py", ["SHIM_CALL"]),
    "conv_fallback": (
        "def f(x, w):\n"
        "    return F.conv2d(x, w, stride=1)\n",
        "def f(x, w):\n"
        "    return jax.lax.conv_general_dilated(x, w, (1, 1), 'SAME')\n",
        "src/{pkg}/models/x.py", ["CONV_FALLBACK"]),
    "conv_fallback_full_path": (
        "def f(x, w):\n"
        "    return torch.nn.functional.conv2d(x, w)\n",
        "def f(x, w):\n"
        "    return lax.conv_general_dilated(x, w, (1, 1), 'SAME')\n",
        "src/{pkg}/models/x.py", ["CONV_FALLBACK"]),
    "conv_fallback_counted": (
        "def f(x, w):\n"
        "    stats.record('conv:dense_fallback')\n"
        "    return F.conv2d(x, w)\n",
        "def f(x, w):\n"
        "    stats.record('conv:dense_fallback')\n"
        "    return jax.lax.conv_general_dilated(x, w, (1, 1), 'SAME')\n",
        "src/{pkg}/models/x.py", []),
    "conv_fallback_waived": (
        "def f(x, w):\n"
        "    # dense oracle  # repro-lint: allow(CONV_FALLBACK)\n"
        "    return torch.conv2d(x, w)\n",
        "def f(x, w):\n"
        "    # dense oracle  # repro-lint: allow(CONV_FALLBACK)\n"
        "    return jax.lax.conv_general_dilated(x, w, (1, 1), 'SAME')\n",
        "benchmarks/x.py", []),
    "stats_key_bad_schedule": ("stats.record('gemm:blocked:x')\n", None,
                               "a.py", ["STATS_KEY"]),
    "stats_key_bad_head": ("stats.record('bitmap:scan')\n", None, "a.py",
                           ["STATS_KEY"]),
    "stats_key_families": (
        "stats.record('gemm:compact:4')\n"
        "stats.record('queue:prefix_sum')\n"
        "stats.record('conv:dense_fallback')\n", None, "a.py", []),
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_lint_mutations(name):
    port_src, ref_src, path, want = LINT_CASES[name]
    ref = jlint.lint_source(ref_src or port_src,
                            path=path.format(pkg="repro"))
    port = tlint.lint_source(port_src, path=path.format(pkg="repro_torch"))
    assert codes(port) == codes(ref) == want


def test_lint_clean():
    assert tlint.lint_paths([os.path.join(REPO, "src", "repro_torch")]) == []
    assert jlint.lint_paths([os.path.join(REPO, r) for r in
                             ("src", "benchmarks", "examples")]) == []


@pytest.mark.parametrize("skip", [["trace"], []])
def test_cli_passes(tmp_path, capsys, skip):
    out = tmp_path / "v.json"
    args = ["--fail-on-violation", "--device", "cpu", "--json", str(out)]
    if skip:
        args += ["--skip", *skip]
    assert analysis_main(args) == 0
    assert out.read_text() == "[]"


# ---------------------------------------------------------------------------
# Instrumentation plumbing the checkers rely on
# ---------------------------------------------------------------------------

def test_gemm_event_provenance():
    x = np.ones((16, 16), np.float32)
    masks = np.ones((2, 2), np.int32)
    with jops.collect_gemm_events() as j_events:
        jax.make_jaxpr(lambda a, b: jops.sparse_gemm(
            a, b, (jnp.asarray(masks), None),
            J_POLICY.gemm_spec(dims=(16, 16, 16))))(x, x)
    with tops.collect_gemm_events() as t_events:
        tops.sparse_gemm(torch.from_numpy(x), torch.from_numpy(x),
                         (torch.from_numpy(masks), None),
                         T_POLICY.gemm_spec(dims=(16, 16, 16)))
    assert [e.origin for e in t_events] == [e.origin for e in j_events] \
        == ["policy"]
    # origin is provenance, not identity: equality and hashing ignore it.
    s1 = tops.GemmSpec(block=(8, 8, 8), schedule="compact")
    s2 = tops.GemmSpec(block=(8, 8, 8), schedule="compact",
                       origin="whatever")
    assert s1 == s2 and hash(s1) == hash(s2)
    assert T_POLICY.gemm_spec(dims=(16, 16, 16)).origin == "policy"
    assert T_POLICY.gemm_spec().with_(epilogue="sigma_prime").origin \
        == "policy"
    assert tautotune.key_for(s1, (16, 16, 16)) \
        == tautotune.key_for(s2, (16, 16, 16))


def test_lifecycle_scopes_reach_the_trace():
    def f(x):
        with tstats.layer_scope("L0"):
            return tops.bitmap_scan(x, block=(8, 8), kind="act").sum()

    _, trace = tta.trace_fn(f, torch.ones(16, 16))
    tags = {op.tag.tag for op in trace.ops if op.tag is not None}
    assert any(t.startswith("repro:scan:act:") for t in tags)
    assert {op.layer for op in trace.ops} == {"L0"}
    assert tstats.open_tags() == ()


def test_kernel_notes_enter_the_trace():
    """A wrapper's note (``stats.note_kernel``) is an op of the log whose
    outputs are the storages the kernel wrote."""
    a = torch.ones(4)
    b = torch.zeros(4)

    def f():
        with tstats.lifecycle_scope("encode", "act"):
            tstats.note_kernel("relu_encode", (a,), (b, None))
        return b + 1

    _, trace = tta.trace_fn(f)
    note = [op for op in trace.ops if op.name == "kernel:relu_encode"]
    assert len(note) == 1 and note[0].tag.kind == "encode"
    add = [op for op in trace.ops if op.name == "add"][0]
    assert [w.index for w in trace.writers_before(add.ins[0].key,
                                                  add.index)] \
        == [note[0].index]
