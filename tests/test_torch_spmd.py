"""The port's data-parallel step (``repro_torch.sharding.spmd_step``), its
int8 compressed all-reduce (``repro_torch.optim.compression``) and
``train_loop(spmd=True)`` against the JAX package's.

The FFN and the VGG16 smoke CNN run their SPMD gradients on a pool of 4
gloo ranks on the CPU (spawned once for the module), each rank taking its
rows of the global batch, and are held against the single-process port
step and the reference's ``jax.jit(jax.value_and_grad(loss_fn))`` on
the whole batch at the reference's tolerances
(tests/test_sparse_collectives.py): each rank's trace-time counts equal
the single-process step's and the reference's one-device SPMD trace's; the
runtime collective keys summed over the ranks give one decision per rank
and leaf.  The trainer runs on a ("data", "model") = (2, 2) mesh: 2
data-parallel ranks, each replicated over 2 model ranks, as the
reference's SPMD step replicates over its model axis.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

from repro.core import policy as jpol
from repro.kernels import stats as jstats
from repro.models.cnn import build_cnn as jbuild
from repro.models.ffn import FFNConfig as JFFNConfig
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro.models.ffn import ffn_init as j_ffn_init
from repro.optim.compression import compressed_psum as j_cpsum
from repro.optim.compression import init_error_state as j_init_err
from repro.sharding import spmd_step as jspmd
from repro_torch import tree as ttree
from repro_torch.core import policy as tpol
from repro_torch.kernels import stats as tstats
from repro_torch.launch.mesh import RankPool, init_mesh
from repro_torch.models import ffn as tffn
from repro_torch.models.cnn import build_cnn as tbuild
from repro_torch.models.cnn import params_from_jax
from repro_torch.optim import compression as tcomp
from repro_torch.sharding import spmd_step as tspmd

N_RANKS = 4
BLOCK = (8, 16, 8)
J_PALLAS = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)
T_PALLAS = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=BLOCK)
J_REF = jpol.IN_OUT_WR.with_(kernel_impl="xla_ref", block=BLOCK)
CNN_GEOM = dict(image_size=8, width=0.0625, num_classes=10)
RUNTIME_KEYS = ("collective:compressed", "collective:dense_fallback")


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N_RANKS, backend="gloo", device="cpu")
    yield p
    p.close()


def _trace_keys(c):
    return {k: v for k, v in c.items() if k not in RUNTIME_KEYS}


def _mesh(shape, axes):
    import torch.distributed as dist
    if dist.is_initialized():
        return init_mesh(shape, axes, backend="gloo", device="cpu")
    return init_mesh(shape, axes, backend=None, device="cpu")


# ---------------------------------------------------------------------------
# The models, the same in every rank
# ---------------------------------------------------------------------------

def _ffn_case():
    """The reference test's FFN: params, inputs and targets (numpy)."""
    cfg = JFFNConfig(d_model=16, d_ff=32, activation="relu",
                     sparse_policy=J_PALLAS)
    params = jax.tree.map(np.asarray, j_ffn_init(jax.random.key(20), cfg))
    x = np.asarray(jax.random.normal(jax.random.key(21), (64, 16)))
    y = np.asarray(jax.random.normal(jax.random.key(22), (64, 16)))
    return cfg, params, x, y


def _t_ffn_loss(p, batch):
    cfg = tffn.FFNConfig(d_model=16, d_ff=32, activation="relu",
                         sparse_policy=T_PALLAS)
    xb, yb = batch
    return torch.mean((tffn.ffn_apply(p, xb, cfg) - yb) ** 2)


def _t_cnn_loss(p, batch):
    return tbuild("vgg16", **CNN_GEOM).loss(p, batch["img"], batch["lbl"],
                                            T_PALLAS)


def _t_params(params):
    if "head" in params:
        return params_from_jax(params, "cpu")
    return {k: torch.tensor(v) for k, v in params.items()}


def _t_batch(kind, batch):
    if kind == "ffn":
        return tuple(torch.tensor(v) for v in batch)
    return {k: torch.tensor(v) for k, v in batch.items()}


LOSSES = {"ffn": _t_ffn_loss, "cnn": _t_cnn_loss}


def _rank_spmd_grads(kind, params, batch, shape, axes):
    """One rank's SPMD (loss, grads) of the global batch, and its counts
    and rows (a world of one outside the pool)."""
    mesh = _mesh(shape, axes)
    tstats.reset()
    fn = tspmd.make_spmd_grad_fn(LOSSES[kind], mesh)
    loss, grads = fn(_t_params(params), _t_batch(kind, batch))
    return (float(loss), [g.numpy() for g in ttree.leaves(grads)],
            tstats.counts())


def _single_step(kind, params, batch):
    tstats.reset()
    leaves = [p.detach().requires_grad_(True)
              for p in ttree.leaves(_t_params(params))]
    p = ttree.unflatten_like(_t_params(params), leaves)
    loss = LOSSES[kind](p, _t_batch(kind, batch))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads], tstats.counts()


def _j_spmd_counts(loss_fn, params, batch):
    """The reference's one-device SPMD trace's counts (its trace-time keys;
    the runtime keys of a traced-only step are not counted)."""
    jstats.reset()
    jax.make_jaxpr(jspmd.make_spmd_grad_fn(
        loss_fn, jax.make_mesh((1,), ("data",))))(params, batch)
    return jstats.counts()


def _hold(rows, want_loss, want_grads, single_counts, j_counts, *,
          loss_atol, atol, rtol, n_leaves_compressed):
    for loss, grads, c in rows:
        np.testing.assert_allclose(loss, want_loss, atol=loss_atol)
        for a, b in zip(grads, want_grads):
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)
        assert sum(v for k, v in c.items()
                   if k.startswith(("scan:", "scan_pallas:"))) == 0, c
        # each rank's trace-time counts: the single-process step's plus
        # the collective keys, which equal the reference's one trace's
        coll = {k: v for k, v in _trace_keys(c).items()
                if k.startswith("collective:")}
        assert {k: v for k, v in _trace_keys(c).items()
                if not k.startswith("collective:")} == single_counts
        assert coll == {k: v for k, v in _trace_keys(j_counts).items()
                        if k.startswith("collective:")}
        assert c.get("encode:act") == j_counts.get("encode:act")
    assert sum(c.get(k, 0) for _, _, c in rows for k in RUNTIME_KEYS) == \
        len(rows) * n_leaves_compressed


# ---------------------------------------------------------------------------
# int8 error-feedback compression (tests/test_optim.py's cases); first in
# the file, so the cheap case pays the pool's start
# ---------------------------------------------------------------------------

def _rank_compressed_psum(gs):
    mesh = _mesh((N_RANKS,) if gs.shape[0] > 1 else (1,), ("data",))
    g = {"w": torch.from_numpy(gs[mesh.rank])}
    err = tcomp.init_error_state(g)
    out, err2 = tcomp.compressed_psum(g, err, mesh, ("data",))
    return out["w"].numpy(), err2["w"].numpy()


def test_compressed_psum_matches_reference(pool):
    g = np.asarray([[0.1, -0.5, 0.25, 3.0]], np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    gj = {"w": jnp.asarray(g[0])}
    jout, jerr = shard_map(lambda a, e: j_cpsum(a, e, "data"), mesh=mesh,
                           in_specs=(JP(), JP()), out_specs=(JP(), JP()))(
        gj, j_init_err(gj))
    out, err = _rank_compressed_psum(g)
    np.testing.assert_allclose(out, np.asarray(jout["w"]), atol=1e-7)
    np.testing.assert_allclose(err, np.asarray(jerr["w"]), atol=1e-7)
    scale = float(np.abs(g).max()) / 127.0
    np.testing.assert_allclose(out, g[0], atol=scale + 1e-7)
    np.testing.assert_allclose(err, g[0] - out, atol=1e-6)

    gs = np.random.default_rng(4).standard_normal((N_RANKS, 33)) \
        .astype(np.float32)
    deq = []
    for r in range(N_RANKS):
        q, s, _ = tcomp.quantize(torch.from_numpy(gs[r]), torch.zeros(33))
        deq.append(tcomp.dequantize(q, s).numpy())
    for out, err in pool.run(_rank_compressed_psum, gs):
        np.testing.assert_allclose(out, np.mean(deq, 0), atol=1e-6)
        np.testing.assert_allclose(out, gs.mean(0),
                                   atol=np.abs(gs).max() / 127.0)


def test_compression_roundtrip_precision():
    from repro.optim.compression import quantize as jq
    g = np.linspace(-1, 1, 255).astype(np.float32)
    q, scale, err = tcomp.quantize(torch.from_numpy(g), torch.zeros(255))
    jqv, jscale, jerr = jq(jnp.asarray(g), jnp.zeros(255))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-7)
    back = tcomp.dequantize(q, scale)
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        float(scale) / 2 + 1e-7
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-7)


# ---------------------------------------------------------------------------
# The SPMD gradients
# ---------------------------------------------------------------------------

def test_ffn_spmd_grads_match_single_process_and_reference(pool):
    jcfg, params, x, y = _ffn_case()

    def jloss(p, batch):
        xb, yb = batch
        return jnp.mean((j_ffn_apply(p, xb, jcfg) - yb) ** 2)

    jp = jax.tree.map(jnp.asarray, params)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, (jnp.asarray(x),
                                                      jnp.asarray(y)))
    jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
    j_counts = _j_spmd_counts(jloss, jp, (jnp.asarray(x), jnp.asarray(y)))
    loss1, grads1, c1 = _single_step("ffn", params, (x, y))
    np.testing.assert_allclose(loss1, float(jl), atol=1e-5)
    for a, b in zip(grads1, jg):
        np.testing.assert_allclose(a, b, atol=1e-4)

    # a world of one is the reference's one-device mesh: EQUAL trace-time
    # counts, and one runtime branch a leaf
    one = _rank_spmd_grads("ffn", params, (x, y), (1,), ("data",))
    assert _trace_keys(one[2]) == j_counts
    assert sum(one[2].get(k, 0) for k in RUNTIME_KEYS) == 2
    rows = pool.run(_rank_spmd_grads, "ffn", params, (x, y), (N_RANKS,),
                    ("data",))
    assert j_counts.get("collective:bitmap_psum") == 2
    assert j_counts.get("collective:dense", 0) == 0
    _hold(rows, float(jl), jg, c1, j_counts, loss_atol=1e-5, atol=1e-4,
          rtol=0, n_leaves_compressed=2)
    for _, grads, _ in rows:
        for a, b in zip(grads, grads1):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_cnn_spmd_grads_match_single_process_and_reference(pool):
    """VGG16 smoke, batch 8 → 2 images a rank; conv dW carry no bitmaps
    (only linear layers register one), and neither does the head, whose
    input (pooled features) and incoming gradient have none: every leaf
    reduces dense, in the reference as in the port.  The reference's
    counts come from tracing its one-device SPMD step (``make_jaxpr``: its
    interpret-mode compile would take this test past its time budget);
    its loss and gradients from ``jax.jit(jax.value_and_grad(loss_fn))``
    on the whole batch under its ``xla_ref`` kernels, the plain semantics
    of its Pallas ones.  Params and batch are drawn with numpy."""
    jm = jbuild("vgg16", **CNN_GEOM)
    rng = np.random.default_rng(30)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    params = {layer: {k: (rng.standard_normal(v.shape)
                          * (2.0 / np.prod(v.shape[:-1])) ** 0.5)
                      .astype(np.float32) for k, v in leaves.items()}
              for layer, leaves in shapes.items()}
    img = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    lbl = rng.integers(0, 10, (8,)).astype(np.int32)
    batch = {"img": img, "lbl": lbl}

    def jloss(p, b):
        return jm.loss(p, b["img"], b["lbl"], J_PALLAS)

    def jloss_ref(p, b):
        return jm.loss(p, b["img"], b["lbl"], J_REF)

    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(jloss_ref))(jp, jb)
    jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
    jstats.reset()
    jax.make_jaxpr(jspmd.make_spmd_grad_fn(
        jloss, jax.make_mesh((1,), ("data",))))(jp, jb)
    j_counts = jstats.counts()
    loss1, grads1, c1 = _single_step("cnn", params, batch)
    np.testing.assert_allclose(loss1, float(jl), atol=1e-5)
    for a, b in zip(grads1, jg):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
    one = _rank_spmd_grads("cnn", params, batch, (1,), ("data",))
    assert one[2] == j_counts
    rows = pool.run(_rank_spmd_grads, "cnn", params, batch, (N_RANKS,),
                    ("data",))
    assert j_counts.get("collective:dense") == len(grads1) == 14
    assert j_counts.get("collective:bitmap_psum", 0) == 0
    _hold(rows, float(jl), jg, c1, j_counts, loss_atol=1e-5, atol=1e-3,
          rtol=1e-3, n_leaves_compressed=0)
    for _, grads, _ in rows:
        for a, b in zip(grads, grads1):
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    assert c1.get("encode:act") == j_counts.get("encode:act") == 8


def test_spmd_equivalent_across_mesh_shapes(pool):
    """(4,) and (2, 2) as ("pod", "data") give the same global grads."""
    _, params, x, y = _ffn_case()
    flat = pool.run(_rank_spmd_grads, "ffn", params, (x, y), (N_RANKS,),
                    ("data",))
    nested = pool.run(_rank_spmd_grads, "ffn", params, (x, y), (2, 2),
                      ("pod", "data"))
    for (l1, g1, _), (l2, g2, _) in zip(flat, nested):
        np.testing.assert_allclose(l1, l2, atol=1e-6)
        for a, b in zip(g1, g2):
            np.testing.assert_allclose(a, b, atol=1e-5)


# ---------------------------------------------------------------------------
# train_loop(spmd=True): losses, the guard, checkpoints and resume
# ---------------------------------------------------------------------------

# The SPMD loop against the single-process loop: the same loss at step 0
# to the all-reduce's summation order, and within LOOP_ATOL after AdamW
# steps (the largest difference measured over 6 steps on the CPU: 0).
LOOP_ATOL = 1e-5


def _smoke_loop(steps, ckpt_dir=None, mesh_shape=None, guard=False):
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.guards import StepGuard
    mesh = None if mesh_shape is None else _mesh(mesh_shape,
                                                 ("data", "model"))
    g = StepGuard() if guard else None
    tcfg = TrainConfig(total_steps=4, checkpoint_every=2,
                       learning_rate=1e-3, seed=3)
    out = train_loop(SMOKE_ARCHS["smollm-360m"], tcfg, batch_size=4,
                     seq_len=16, steps=steps, ckpt_dir=ckpt_dir,
                     log_every=0, device="cpu", mesh=mesh,
                     spmd=mesh is not None, guard=g)
    verdicts = [v for _, v in g.verdicts] if g else None
    return out, verdicts


def _rank_train(ckpt_dir):
    from repro_torch import checkpoint as ckpt
    commits = []
    prev = ckpt.set_crash_hook(
        lambda name: commits.append(name)
        if name == "checkpoint:pre_commit" else None)
    try:
        full, verdicts = _smoke_loop(4, mesh_shape=(2, 2), guard=True)
        first, _ = _smoke_loop(2, ckpt_dir, mesh_shape=(2, 2), guard=True)
        rest, _ = _smoke_loop(4, ckpt_dir, mesh_shape=(2, 2), guard=True)
    finally:
        ckpt.set_crash_hook(prev)
    return {"full": full["losses"], "verdicts": verdicts,
            "first": first["losses"], "rest": rest["losses"],
            "resumed_from": rest["resumed_from"], "commits": len(commits),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(
                ttree.leaves(rest["params"]), ttree.leaves(full["params"]))),
            "params": [p.numpy() for p in ttree.leaves(full["params"])]}


def test_spmd_train_loop_matches_single_process_and_resumes(pool, tmp_path):
    single, _ = _smoke_loop(4)
    rows = pool.run(_rank_train, str(tmp_path / "ckpt"))
    for rank, r in enumerate(rows):
        assert r["verdicts"] == ["ok"] * 4
        np.testing.assert_allclose(r["full"][0], single["losses"][0],
                                   atol=1e-6)
        np.testing.assert_allclose(r["full"], single["losses"],
                                   atol=LOOP_ATOL)
        assert r["first"] + r["rest"] == r["full"]
        assert r["resumed_from"] == 2 and r["bit_equal"]
        # only rank 0 writes: each run's save at step 2 or 4 and its final
        # save
        assert r["commits"] == (4 if rank == 0 else 0)
        for a, b in zip(r["params"], rows[0]["params"]):
            np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002",
                                                     "step_00000004"]


def test_spmd_train_loop_guards():
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.launch.train import train_loop
    cfg = SMOKE_ARCHS["smollm-360m"]
    kw = dict(batch_size=2, seq_len=4, steps=1, device="cpu")
    with pytest.raises(ValueError, match="requires a mesh"):
        train_loop(cfg, TrainConfig(), spmd=True, **kw)
    one = init_mesh((1,), ("data",), backend=None, device="cpu")
    with pytest.raises(ValueError, match="microbatch"):
        train_loop(cfg, TrainConfig(microbatches=2), mesh=one, spmd=True,
                   **kw)
    # a mesh without spmd places by the partition rules; on a mesh of one
    # rank nothing is placed, and the run is the run without a mesh
    one_dm = init_mesh((1, 1), ("data", "model"), backend=None,
                       device="cpu")
    placed = train_loop(cfg, TrainConfig(), mesh=one_dm, **kw)
    plain = train_loop(cfg, TrainConfig(), **kw)
    assert placed["losses"] == plain["losses"]
    assert all(torch.equal(a, b) for a, b in zip(
        ttree.leaves(placed["params"]), ttree.leaves(plain["params"])))
    with pytest.raises(ValueError, match="fsdp"):
        train_loop(cfg, TrainConfig(), fsdp=True, **kw)
    with pytest.raises(ValueError, match="data-parallel axis"):
        tspmd.data_axes(make_abstract_mesh((2,), ("model",)))


def test_restore_resharded_replicated_placement(tmp_path):
    """Every rank restores the whole tree onto its own device (the
    replicated placement the data-parallel path runs).  A bare
    PartitionSpec that shards has no mesh to place on: sharded restores
    take ``NamedSharding``s (tests/test_torch_tp.py).  A save of the
    reference restores too."""
    from repro import checkpoint as jckpt
    from repro_torch import checkpoint as tckpt
    from repro_torch.sharding.partition import P
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    tckpt.save(str(tmp_path / "t"), 2, tree)
    jckpt.save(str(tmp_path / "j"), 4, {"w": jnp.arange(6.0).reshape(2, 3),
                                        "b": [jnp.ones(2)]})
    tpl = {"w": torch.zeros(2, 3), "b": [torch.zeros(2)]}
    for sub, want_step, placement in (
            ("t", 2, P()), ("j", 4, {"w": P(None, None), "b": [P(None)]})):
        step, back = tckpt.restore_resharded(str(tmp_path / sub), tpl,
                                             placement)
        assert step == want_step
        assert torch.equal(back["w"], tree["w"])
        assert torch.equal(back["b"][0], tree["b"][0])
    with pytest.raises(ValueError, match="NamedSharding"):
        tckpt.restore_resharded(str(tmp_path / "t"), tpl,
                                {"w": P("data", None), "b": [P(None)]})


@pytest.fixture(scope="module")
def chip_smoke_pool():
    """``chip_smoke.py`` and a pool of its 2 gloo ranks on the CPU (the
    ranks import the script, so it stays importable while they live)."""
    import sys
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    try:
        import chip_smoke
        with RankPool(chip_smoke.DP_RANKS, backend="gloo",
                      device="cpu") as p:
            yield chip_smoke, p
    finally:
        sys.path.remove(root)


# Each part of phase 10 at a CPU size: a (2,048 × 512) reduce, VGG16 at
# 32², the SMOKE SmolLM at 8 × 32 tokens.
PHASE10_PARTS = {
    "collectives": ("dp_collectives_phase", (2048, 512)),
    "vgg16_spmd": ("vgg16_spmd_phase",
                   dict(image_size=32, width=0.0625, num_classes=10)),
    "lm_spmd": ("lm_spmd_phase", True),
}


@pytest.mark.parametrize("part", list(PHASE10_PARTS))
def test_chip_smoke_phase10_rehearses_on_the_cpu(part, chip_smoke_pool,
                                                 tmp_path):
    """``chip_smoke.py``'s phase 10, part by part on its two ranks: every
    check of the card's run holds, the planted fault's rejection
    included."""
    chip_smoke, pool = chip_smoke_pool
    fn, small = PHASE10_PARTS[part]
    kw = {"ckdir": str(tmp_path / "ckpt")} if part == "lm_spmd" else {}
    chip_smoke.FAILURES.clear()
    getattr(chip_smoke, fn)(pool, torch.device("cpu"), small, **kw)
    assert chip_smoke.FAILURES == []
