"""Tensor parallelism and FSDP in the port (ROADMAP A18b): params,
optimizer state and batches placed as DTensors by the partition rules
(``sharding.partition.NamedSharding``), activations laid out by the
installed rules (``sharding.context.constraint``), ``train_loop(mesh=...)``
with and without ``fsdp``, and checkpoints restored onto any layout.

The multi-rank cases run on one pool of 4 gloo ranks on the CPU, spawned
once for the module, as a ("data", "model") = (2, 2) mesh, and are held
against the single-process port step on the same inputs: the loss within
1e-6 absolute, the global gradient norm (``optim.global_norm`` over the
placed gradients, summed over the mesh) within 1e-5 relative, every
gathered gradient within 1e-5 relative L2 (or, for a
leaf the single-process f32 step itself leaves more than 1e-5 from the
float64 step, no farther from the float64 step than 2x that: jamba's SSM
leaves), and each rank's count dict equal to the single-process step's.
The sparse FFN on tensor-parallel shards is held against the reference's
``ffn_apply``; ``chip_smoke.py``'s phase 13 is rehearsed on the same
ranks.
"""
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.models import ffn as jffn
from repro_torch import tree as ttree
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.kernels import stats as tstats
from repro_torch.launch.mesh import RankPool, init_mesh, make_abstract_mesh
from repro_torch.sharding import context as tctx
from repro_torch.sharding import partition as tpart

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_RANKS = 4
LOSS_ATOL, GRAD_RTOL, F64_FACTOR = 1e-6, 1e-5, 2.0
LOOP_ATOL = 1e-5                # tests/test_torch_spmd.py's
FAMILIES = ("smollm-360m", "stablelm-1.6b", "gemma3-12b", "grok-1-314b",
            "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "xlstm-350m")
FSDP_VOCAB = 49152              # smollm's embedding at 4.72 M elements


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


@pytest.fixture(scope="module")
def pool():
    """4 gloo ranks on the CPU; they import ``chip_smoke`` too, so the
    checkout's root is on the path while they live.  As every gloo rank,
    they run DTensor's collectives through ``sharding.shared_card``."""
    sys.path.insert(0, ROOT)
    try:
        with RankPool(N_RANKS, backend="gloo", device="cpu") as p:
            yield p
    finally:
        sys.path.remove(ROOT)


def _mesh(shape=(2, 2), axes=("data", "model")):
    return init_mesh(shape, axes, backend="gloo", device="cpu")


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# Placements from specs, on abstract meshes
# ---------------------------------------------------------------------------

def _want_placements(spec, axis_names):
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch", sorted(SMOKE_ARCHS))
def test_to_shardings_gives_each_specs_placements(arch, mesh_shape):
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim.optimizer import adamw_init
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    mesh = make_abstract_mesh(mesh_shape, axes)
    params = lm_init(0, SMOKE_ARCHS[arch], dtype=torch.float32,
                     device="meta")
    opt = adamw_init(params)
    for fsdp in (False, True):
        specs = {"params": tpart.params_pspecs(params, mesh, fsdp=fsdp),
                 "opt": tpart.opt_state_pspecs(opt, params, mesh,
                                               fsdp=fsdp)}
        shardings = tpart.to_shardings(specs, mesh)
        leaves = ttree.leaves({"params": params, "opt": opt})
        pairs = tpart.spec_leaves(specs)
        sh = tpart.leaves_of_shardings(shardings)
        assert len(sh) == len(pairs) == len(leaves)
        for (path, spec), s, leaf in zip(pairs, sh, leaves):
            assert s.spec == spec, path
            assert s.placements == _want_placements(spec, axes), path
            want = [n // tpart.axis_size(mesh, tpart._spec_axes(e))
                    for n, e in zip(leaf.shape, list(spec) + [None] * 8)]
            assert s.local_shape(leaf.shape) == tuple(want), path
    # the same trees of shardings through params_shardings
    got = tpart.leaves_of_shardings(tpart.params_shardings(params, mesh))
    assert [s.spec for s in got] == [
        s for _, s in tpart.spec_leaves(tpart.params_pspecs(params, mesh))]


def test_named_sharding_refuses_specs_out_of_mesh_order():
    mesh = make_abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="axis order"):
        tpart.NamedSharding(mesh, tpart.P(("data", "pod"), None))
    with pytest.raises(ValueError, match="does not split"):
        tpart.NamedSharding(mesh, tpart.P("model")).local_shape((3,))


# ---------------------------------------------------------------------------
# constraint and the activation rules
# ---------------------------------------------------------------------------

def test_constraint_cases_without_ranks():
    """No rule: the identity.  A plain tensor under a rule that places
    nothing on its mesh (axes of size 1): the identity.  Where the rule
    would shard it: a TypeError naming the rule, never a silent pass."""
    x = torch.ones(4, 2, 2)
    assert tctx.constraint(x, "act_btd") is x
    one = init_mesh((1, 1), ("data", "model"), backend=None, device="cpu")
    with tctx.sharding_rules({**tpart.activation_rules(one),
                              "__mesh__": one}):
        assert tctx.constraint(x, "act_btd") is x
        assert tctx.constraint(x, "not_a_rule") is x
    two = make_abstract_mesh((2, 2), ("data", "model"))
    with tctx.sharding_rules({**tpart.activation_rules(two),
                              "__mesh__": two}):
        with pytest.raises(TypeError, match="act_btd"):
            tctx.constraint(x, "act_btd")
    rule = tpart.NamedSharding(two, tpart.P(None, "model"))
    with tctx.sharding_rules({"head_dv": rule}):
        with pytest.raises(TypeError, match="head_dv"):
            tctx.constraint(x[0], "head_dv")


def test_stash_sharding_rule_plumbing():
    """The reference's test (tests/test_perf_features.py): the act_stash
    constraint is a no-op without rules and valid with one, on a
    one-device mesh."""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import lm_init, lm_loss
    cfg = SMOKE_ARCHS["stablelm-1.6b"]
    params = lm_init(0, cfg, dtype=torch.float32, device="cpu")
    batch = lm_batch(1, 0, batch=2, seq_len=16, vocab=cfg.vocab_size,
                     device="cpu")
    base = float(lm_loss(params, batch, cfg))
    mesh = init_mesh((1,), ("model",), backend=None, device="cpu")
    with tctx.sharding_rules({"act_stash": tpart.NamedSharding(
            mesh, tpart.P())}):
        with_rule = float(lm_loss(params, batch, cfg))
    np.testing.assert_allclose(base, with_rule, rtol=1e-6)


def _rank_constraint():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh()
    x = tpart.NamedSharding(mesh, tpart.P(None, "model")).shard(
        torch.arange(24.0).reshape(4, 6))
    with tctx.sharding_rules({"act": tpart.P("data", None),
                              "__mesh__": mesh}):
        y = tctx.constraint(x, "act")
        z = tctx.constraint(y, "act")
    return (tuple(y.placements) == (Shard(0), Replicate()), z is y,
            torch.equal(tpart.full(y), torch.arange(24.0).reshape(4, 6)))


def test_constraint_redistributes_a_dtensor(pool):
    for row in pool.run(_rank_constraint):
        assert row == (True, True, True)


# ---------------------------------------------------------------------------
# One SMOKE step per family on (2, 2) against the single-process step
# ---------------------------------------------------------------------------

def _rank_family_step(arch):
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import common
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.optim.optimizer import global_norm
    mesh = _mesh()
    cfg = SMOKE_ARCHS[arch]
    params = lm_init(0, cfg, dtype=torch.float32, device="cpu")
    batch = lm_batch(0, 0, batch=4, seq_len=16, vocab=cfg.vocab_size,
                     device="cpu")

    def value_and_grad(p, b):
        leaves = [x.detach().requires_grad_(True) for x in ttree.leaves(p)]
        loss = lm_loss(ttree.unflatten_like(p, leaves), b, cfg)
        return loss, torch.autograd.grad(loss, leaves)

    tstats.reset()
    loss1, grads1 = value_and_grad(params, batch)
    single_counts = tstats.counts()
    out = {"single": (float(loss1), [g.numpy() for g in grads1])}
    if mesh.rank == 0:
        p64 = ttree.tree_map(lambda x: x.double(), params)
        with common.upcast(torch.float64):
            _, g64 = value_and_grad(p64, batch)
        out["f64"] = [g.numpy() for g in g64]
    sh = tpart.params_shardings(params, mesh)
    placed = tpart.place(params, sh)
    tokens = tpart.place(batch, tpart.to_shardings(
        tpart.batch_pspecs(batch, mesh), mesh))
    rules = {**tpart.activation_rules(mesh), "__mesh__": mesh}
    tstats.reset()
    with tctx.sharding_rules(rules), tpart.placed_scope(placed):
        loss, grads = value_and_grad(placed, tokens)
        grads = [tctx.with_sharding_constraint(g, s) for g, s in
                 zip(grads, tpart.leaves_of_shardings(sh))]
        norm = tpart.full(global_norm(grads))
    out["counts"], out["single_counts"] = tstats.counts(), single_counts
    out["tp"] = (float(tpart.full(loss)),
                 [tpart.full(g).numpy() for g in grads])
    out["norms"] = (float(norm), float(global_norm(list(grads1))))
    out["placed"] = all(tpart.is_placed(x) for x in ttree.leaves(placed))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_smoke_step_per_family_matches_single_process(arch, pool):
    rows = pool.run(_rank_family_step, arch)
    f64 = [torch.from_numpy(g) for g in rows[0]["f64"]]
    for r in rows:
        assert r["placed"]
        assert r["counts"] == r["single_counts"]
        np.testing.assert_allclose(*r["norms"], rtol=GRAD_RTOL)
        loss, grads = r["tp"]
        loss1, grads1 = r["single"]
        assert abs(loss - loss1) <= LOSS_ATOL
        for g, g1, g64 in zip(grads, grads1, f64):
            g, g1 = torch.from_numpy(g), torch.from_numpy(g1)
            rel, own = _rel(g, g1), _rel(g1.double(), g64)
            assert rel <= GRAD_RTOL or (
                own > GRAD_RTOL
                and _rel(g.double(), g64) <= F64_FACTOR * own), (rel, own)


# ---------------------------------------------------------------------------
# train_loop(mesh=...) with and without FSDP; restores onto any layout
# ---------------------------------------------------------------------------

def _loop(steps, mesh_shape=None, fsdp=False, spmd=False, ckpt_dir=None):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    cfg = SMOKE_ARCHS["smollm-360m"].with_(vocab_size=FSDP_VOCAB)
    mesh = None if mesh_shape is None else _mesh(mesh_shape)
    tcfg = TrainConfig(total_steps=4, checkpoint_every=0,
                       learning_rate=1e-3, seed=3)
    return train_loop(cfg, tcfg, batch_size=4, seq_len=8, steps=steps,
                      ckpt_dir=ckpt_dir, log_every=0, device="cpu",
                      mesh=mesh, fsdp=fsdp, spmd=spmd)


def _rank_fsdp_loops():
    out = {}
    for fsdp in (False, True):
        res = _loop(4, (2, 2), fsdp=fsdp)
        out[fsdp] = (res["losses"], sum(
            tpart.local(x).numel() * x.element_size() for x in
            ttree.leaves({"p": res["params"], "o": res["opt_state"]})))
    return out


def test_train_loop_on_a_mesh_with_and_without_fsdp(pool):
    """4 AdamW steps: the losses of both layouts within LOOP_ATOL of the
    single-process loop's; FSDP leaves each rank fewer bytes (the
    reference's test_fsdp_reduces_resident_bytes)."""
    single = _loop(4)["losses"]
    for r in pool.run(_rank_fsdp_loops):
        for fsdp in (False, True):
            np.testing.assert_allclose(r[fsdp][0], single, atol=LOOP_ATOL)
        assert r[True][1] < r[False][1]


def _rank_elastic(root):
    import torch.distributed as dist
    out = {"full": _loop(3, (2, 2), fsdp=True)["losses"]}
    _loop(2, (2, 2), fsdp=True, ckpt_dir=os.path.join(root, "saved"))
    for name, shape, spmd in (("1x4", (1, 4), False), ("4x1", (4, 1), False),
                              ("spmd", (2, 2), True)):
        sub = os.path.join(root, name)
        if dist.get_rank() == 0:
            shutil.copytree(os.path.join(root, "saved"), sub)
        dist.barrier()
        res = _loop(3, shape, spmd=spmd, ckpt_dir=sub)
        out[name] = (res["losses"], res["resumed_from"])
    return out


def test_fsdp_checkpoint_restores_onto_every_layout(pool, tmp_path):
    """A checkpoint saved by the (2, 2) FSDP layout (full tensors on disk)
    resumes on (1, 4), on (4, 1), on the replicated spmd layout and
    without a mesh; each resumed step within LOOP_ATOL of the
    uninterrupted run."""
    rows = pool.run(_rank_elastic, str(tmp_path))
    shutil.copytree(tmp_path / "saved", tmp_path / "none")
    single = _loop(3, ckpt_dir=str(tmp_path / "none"))
    for r in rows:
        tail = r["full"][2:]
        for name in ("1x4", "4x1", "spmd"):
            losses, frm = r[name]
            assert frm == 2
            np.testing.assert_allclose(losses, tail, atol=LOOP_ATOL)
        assert single["resumed_from"] == 2
        np.testing.assert_allclose(single["losses"], tail, atol=LOOP_ATOL)


def _rank_restore_leaves(path):
    from repro_torch import checkpoint as ckpt
    mesh = _mesh()
    tpl = {"w": torch.zeros(4, 6), "b": [torch.zeros(6)]}
    sh = tpart.to_shardings({"w": tpart.P("data", "model"),
                             "b": [tpart.P("model")]}, mesh)
    step, back = ckpt.restore_resharded(path, tpl, sh)
    return (step, back["w"].to_local().tolist(),
            back["b"][0].to_local().tolist(),
            torch.equal(tpart.full(back["w"]),
                        torch.arange(24.0).reshape(4, 6)))


def test_restore_resharded_keeps_each_ranks_block(pool, tmp_path):
    from repro_torch import checkpoint as ckpt
    w = torch.arange(24.0).reshape(4, 6)
    ckpt.save(str(tmp_path), 5, {"w": w, "b": [torch.arange(6.0)]})
    for rank, (step, wl, bl, whole) in enumerate(
            pool.run(_rank_restore_leaves, str(tmp_path))):
        d, m = divmod(rank, 2)
        assert step == 5 and whole
        assert wl == w[2 * d:2 * d + 2, 3 * m:3 * m + 3].tolist()
        assert bl == [3.0 * m, 3.0 * m + 1, 3.0 * m + 2]


# ---------------------------------------------------------------------------
# The vocab-sharded embedding lookup
# ---------------------------------------------------------------------------

def _rank_embed_lookup():
    from repro_torch.models.transformer import _embed_lookup
    from repro_torch.sharding import collectives
    mesh = _mesh()
    g = torch.Generator().manual_seed(0)
    table = torch.randn(16, 4, generator=g)
    tokens = torch.tensor([[0, 3, 15, -1], [16, 7, 21, 8]])
    plain = _embed_lookup(table, tokens)
    placed = tpart.NamedSharding(mesh, tpart.P("model", None)).shard(
        table).requires_grad_(True)
    toks = tpart.NamedSharding(mesh, tpart.P("data", None)).shard(tokens)
    collectives.reset_wire_bytes()
    with tctx.sharding_rules({"__mesh__": mesh, "embed_vocab_axis": "model"}
                             ), tpart.placed_scope([placed]):
        out = _embed_lookup(placed, toks)
        wire = collectives.wire_bytes()
        (grad,) = torch.autograd.grad((out * out).sum(), [placed])
    t = table.clone().requires_grad_(True)
    (want_grad,) = torch.autograd.grad(
        (_embed_lookup(t, tokens) ** 2).sum(), [t])
    return (torch.equal(tpart.full(out), plain), wire,
            torch.allclose(tpart.full(grad), want_grad, atol=1e-6),
            bool((plain[0, 3] == 0).all() and (plain[1, 0] == 0).all()))


def test_vocab_sharded_embed_lookup_equals_the_plain_lookup(pool):
    """Each rank gathers from its quarter of the vocabulary on its rows
    and the vocab axis sums them (counted on the wire): equal to the plain
    lookup, out-of-vocabulary ids (-1, 16, 21) giving zero rows, with the
    table's gradient."""
    for equal, wire, grad_ok, oov_zero in pool.run(_rank_embed_lookup):
        assert equal and grad_ok and oov_zero
        assert wire == 1 * 4 * 4 * 4       # this rank's (1, 4, 4) f32 rows


# ---------------------------------------------------------------------------
# The sparse FFN on tensor-parallel shards against the reference
# ---------------------------------------------------------------------------

def _rank_sparse_ffn(x, w_up, w_down, dy):
    from repro_torch.core import policy as tpol
    from repro_torch.models.ffn import FFNConfig, ffn_apply
    mesh = _mesh()
    pol = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 16, 8))
    cfg = FFNConfig(w_up.shape[0], w_up.shape[1], "relu", pol)
    lay = [tpart.NamedSharding(mesh, s) for s in (
        tpart.P("data", None), tpart.P(None, "model"),
        tpart.P("model", None), tpart.P("data", None))]
    t = [s.shard(torch.from_numpy(a)) for s, a in
         zip(lay, (x, w_up, w_down, dy))]
    for v in t[:3]:
        v.requires_grad_(True)
    tstats.reset()
    with tpart.placed_scope(t):
        y = ffn_apply({"w_up": t[1], "w_down": t[2]}, t[0], cfg)
        grads = torch.autograd.grad((y * t[3]).sum(), t[:3])
    return ([tpart.full(v).detach().numpy() for v in (y, *grads)],
            tstats.counts())


def test_sparse_ffn_on_tp_shards_matches_the_reference(pool):
    """``ffn_tp``'s plain-version rehearsal at SMOKE width (seamless's
    ReLU FFN under IN_OUT_WR, d 64, ff 128): each rank's K1 encodes its
    own ff columns, K2/K3 skip on them; output and gradients equal the
    reference's ``ffn_apply`` (through its plain reference, ``xla_ref``)
    on the weights carried across, and each rank counts the reference's
    single-call encodes and emits."""
    d, f, rows = 64, 128, 32
    jcfg = jffn.FFNConfig(d, f, "relu", jpol.IN_OUT_WR.with_(
        kernel_impl="xla_ref", block=(8, 16, 8)))
    jp = jax.tree.map(np.asarray, jffn.ffn_init(jax.random.key(1), jcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jffn.ffn_apply(p, xx, jcfg) * dy)

    jstats.reset()
    y_ref = np.asarray(jffn.ffn_apply(jp, jnp.asarray(x), jcfg))
    jstats.reset()
    g_ref = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    # the port's gradients come in the order x, w_up, w_down
    want = [y_ref, np.asarray(g_ref[1]), np.asarray(g_ref[0]["w_up"]),
            np.asarray(g_ref[0]["w_down"])]
    ref_counts = {k: v for k, v in jstats.counts().items()
                  if k.startswith(("encode:", "emit:", "registry:"))}
    for got, counts in pool.run(_rank_sparse_ffn, x, jp["w_up"],
                                jp["w_down"], dy):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        assert {k: counts.get(k) for k in ref_counts} == ref_counts


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 13, rehearsed on the CPU
# ---------------------------------------------------------------------------

PHASE13_PARTS = ("probe", "lm_tp", "lm_fsdp", "attn_heads", "ffn_tp")


@pytest.mark.parametrize("part", PHASE13_PARTS)
def test_chip_smoke_phase13_rehearses_on_the_cpu(part, pool, tmp_path):
    """Phase 13, part by part on the pool's four ranks at SMOKE size
    (SmolLM's vocabulary at 49,152): every check of the card's run holds,
    both planted faults rejected by both layouts."""
    import chip_smoke
    cpu = torch.device("cpu")
    chip_smoke.FAILURES.clear()
    if part == "probe":
        assert set(chip_smoke.tp_probe(pool, cpu).values()) == {"ok"}
    elif part == "ffn_tp":
        chip_smoke.ffn_tp_path(pool, cpu, small=True)
    elif part == "attn_heads":
        chip_smoke.attn_heads_path(pool, cpu, small=True)
    else:
        chip_smoke.lm_tp_path(pool, cpu, part == "lm_fsdp", smoke=True,
                              ckdir=str(tmp_path / "ckpt"))
    assert chip_smoke.FAILURES == []
