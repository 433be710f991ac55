"""The port's dense decoder LM against the JAX package's: blockwise
attention, ``lm_loss`` and its gradients from the reference's params
(``params_from_jax``) with equal count dicts, ``make_train_step`` over three
steps with and without microbatches, ``lm_batch``, and the trainer's
resume.  Same numpy inputs into both; tolerance 1e-5 (f32, different
summation orders).

Count dicts: the reference counts at trace time, and its ``lax.scan`` over
the layer periods traces the period body a fixed number of times whatever
the depth (twice forward under ``jax.value_and_grad``), so its LM count
dict is not a per-step count.  The port runs eagerly and counts per step;
it is held to the reference's counts of ONE unscanned block (forward and
backward) times the number of layers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as _T_SMOKE
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.data.pipeline import lm_batch
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train_loop
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizer as topt

# The port's SMOKE configs at remat=False: these tests hold values
# that rematerialisation leaves bit-equal (tests/test_torch_remat.py
# holds remat=True against remat=False), and the recomputed forward
# would only add time.
T_SMOKE = {name: cfg.with_(remat=False) for name, cfg in _T_SMOKE.items()}

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()
    yield
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()


def _relu2_lm(pkg_config):
    """``examples/train_lm.py``'s LM100M with ``--sparse-ffn`` (relu² FFN
    under ``IN_OUT``), cut to smoke width."""
    return pkg_config(
        name="lm-100m", family="dense", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab_size=128, ffn_activation="relu2",
        sparse_ffn_scenario="IN_OUT", tie_embeddings=True, dtype="float32",
        q_chunk=8, kv_chunk=8)


CONFIGS = {
    "smollm-360m": (J_SMOKE["smollm-360m"], T_SMOKE["smollm-360m"]),
    "lm100m-relu2-in-out": (_relu2_lm(JModelConfig), _relu2_lm(TModelConfig)),
}


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("causal,schedule,shape,window", [
    (True, "rect", (2, 10, 4, 2, 8), None),   # GQA 2:1, ragged last chunk
    (True, "tri", (2, 10, 6, 2, 8), None),    # GQA 3:1
    (False, "rect", (1, 7, 3, 3, 4), None),   # MHA, bidirectional
    (True, "rect", (2, 10, 4, 2, 8), 4),      # sliding window, every chunk
    (True, "tri", (2, 10, 4, 2, 8), 4),       # sliding window, causal prefix
    (True, "rect", (1, 9, 2, 1, 4), 1),       # a window of one: the diagonal
])
def test_blockwise_attention_matches_reference(causal, schedule, shape,
                                               window):
    b, t, hq, hk, d = shape
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hk, d)).astype(np.float32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=4, kv_chunk=3, schedule=schedule)
    got = tattn.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_chunk=4, kv_chunk=3,
        schedule=schedule)
    _close(got, want)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtr.lm_init(jax.random.key(seed), cfg,
                                                dtype=jnp.float32))


def _tokens(cfg, b=2, t=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_loss_and_grads_match_reference(name):
    jcfg, tcfg = CONFIGS[name]
    pn = _jax_params(jcfg)
    tok = _tokens(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: jtr.lm_loss(p, {"tokens": jnp.asarray(tok)}, jcfg))(pn)

    tp = ttr.params_from_jax(pn, device="cpu")
    leaves = [x.requires_grad_(True) for x in ttree.leaves(tp)]
    tl = ttr.lm_loss(ttree.unflatten_like(tp, leaves),
                     {"tokens": torch.from_numpy(tok)}, tcfg)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
    assert len(tg) == len(jax.tree.leaves(jg))
    for got, want in zip(tg, jax.tree.leaves(jg)):
        _close(got, want)
    # the reference's per-step counts: one unscanned block, times the depth
    jstats.reset()
    blk = jax.tree.map(lambda x: x[0], pn["layers"]["b0"])
    x = np.random.default_rng(1).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    jax.grad(lambda p, x: jtr.block_apply(p, x, jcfg, "A", False)[0].sum(),
             argnums=(0, 1))(blk, jnp.asarray(x))
    per_step = {k: v * jcfg.n_layers for k, v in jstats.counts().items()}
    assert tstats.counts() == per_step
    if name.startswith("lm100m"):
        assert per_step["gemm:dense:1"] == 6 * jcfg.n_layers


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """Three steps, each taken by both packages from the reference's state
    of that step (so that one package's drift does not feed the next
    step).  Loss, grad norm, lr and the moments at TOL; the weights at TOL
    too, except on the first step: from zero moments Adam's update is
    lr·sign(g), so an element whose gradient sits at f32 rounding noise
    may move the other way — there each weight is held to one flipped
    update (2·lr) and each leaf to 1e-4 in relative L2 norm."""
    jcfg, tcfg = CONFIGS["smollm-360m"]
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt.OptConfig(**ocfg), microbatches=microbatches))
    tstep = tsteps.make_train_step(tcfg, topt.OptConfig(**ocfg),
                                   microbatches=microbatches)
    jp = jtr.lm_init(jax.random.key(1), jcfg, dtype=jnp.float32)
    jo = jopt.adamw_init(jp)
    for step in range(3):
        tp, to = (ttr.params_from_jax(jax.tree.map(np.asarray, t),
                                      device="cpu") for t in (jp, jo))
        tok = _tokens(jcfg, b=4, seed=10 + step)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(tok)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(tok)})
        for k in ("loss", "grad_norm", "lr", "skipped"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                TOL * max(abs(float(jm[k])), 1e-6), k
        weights = list(zip(ttree.leaves(tp), jax.tree.leaves(jp)))
        for (path, got), want in zip(ttree.leaves_with_paths(to),
                                     jax.tree.leaves(jo)):
            if path.startswith("['master']"):
                weights.append((got, want))
            else:
                _close(got, want)
        for got, want in weights:
            if step > 0:
                _close(got, want)
                continue
            d = got.numpy() - np.asarray(want)
            assert float(np.abs(d).max()) <= 2 * float(jm["lr"])
            assert np.linalg.norm(d) <= 1e-4 * np.linalg.norm(want)


def test_lm_batch_shape_range_and_determinism():
    a = lm_batch(0, 3, batch=4, seq_len=9, vocab=50, device="cpu")["tokens"]
    b = lm_batch(0, 3, batch=4, seq_len=9, vocab=50, device="cpu")["tokens"]
    c = lm_batch(0, 4, batch=4, seq_len=9, vocab=50, device="cpu")["tokens"]
    d = lm_batch(0, 3, batch=4, seq_len=9, vocab=50, shard_index=1,
                 shard_count=2, device="cpu")["tokens"]
    assert a.shape == (4, 10) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 50
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert d.shape == (2, 10) and not torch.equal(d, a[:2])
    # without noise each row is the affine recurrence x' = (a·x + c) mod V
    # for one a in [1, 17): its differences scale by a
    clean = lm_batch(1, 0, batch=8, seq_len=12, vocab=1000, noise=0.0,
                     device="cpu")["tokens"].long()
    d = (clean[:, 1:] - clean[:, :-1]) % 1000
    for row in d:
        assert any(bool(((a * row[:-1] - row[1:]) % 1000 == 0).all())
                   for a in range(1, 17))


def test_train_loop_resume_equals_uninterrupted(tmp_path):
    cfg = T_SMOKE["smollm-360m"]
    tc = TTrainConfig(total_steps=6, checkpoint_every=0, learning_rate=1e-3,
                      seed=3, keep_checkpoints=1)
    kw = dict(batch_size=4, seq_len=16, log_every=0, device="cpu")
    full = train_loop(cfg, tc, steps=6, **kw)
    first = train_loop(cfg, tc, steps=3, ckpt_dir=str(tmp_path), **kw)
    assert first["resumed_from"] is None
    rest = train_loop(cfg, tc, steps=6, ckpt_dir=str(tmp_path), **kw)
    assert rest["resumed_from"] == 3
    assert first["losses"] + rest["losses"] == full["losses"]
    for a, b in zip(ttree.leaves(rest["params"]),
                    ttree.leaves(full["params"])):
        assert torch.equal(a, b)


def test_unported_families_raise():
    """Every SMOKE architecture builds, in f32 and in its config's bf16
    default (sliding windows, Mamba, xLSTM: ROADMAP A16c); FSDP without
    a mesh to place on is refused (A18b places with one)."""
    for name in sorted(T_SMOKE):
        p32 = ttr.lm_init(0, T_SMOKE[name], dtype=torch.float32,
                          device="cpu")
        p16 = ttr.lm_init(0, T_SMOKE[name], device="cpu")     # bf16 config
        assert p32["embed"].shape[0] == 512
        assert all(x.dtype == torch.float32 for x in ttree.leaves(p32))
        assert p16["embed"].dtype == torch.bfloat16
        assert [x.shape for x in ttree.leaves(p16)] == \
            [x.shape for x in ttree.leaves(p32)]
    with pytest.raises(ValueError, match="fsdp"):
        train_loop(T_SMOKE["smollm-360m"], TTrainConfig(), batch_size=2,
                   seq_len=4, steps=1, fsdp=True, device="cpu")
    full = T_ARCHS["smollm-360m"]
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab_size) == (32, 960, 15, 5, 2560, 49152)


NEW_FAMILIES = ("gemma3-12b", "jamba-1.5-large-398b", "xlstm-350m")
# jamba's eight SSM/MoE layers amplify f32 rounding beyond 1e-5 in both
# packages: the two are held to 1e-4 there, and each to F64_TOL in
# relative L2 of the port's float64 step (asserted in the test).
GRAD_TOL = {"jamba-1.5-large-398b": 1e-4}
F64_TOL = 1e-4
# bf16: a bf16 gradient leaf is far from the f32 one in both packages
# (jamba's SSM leaves up to 0.42 relative L2, gemma3's ~3e-2), so the two
# bf16 steps are not held to each other.  Each port leaf is held to the
# f32 gradient from the same values: no farther than BF16_FACTOR times the
# reference's bf16 leaf is, or BF16_TOL.  The reference is jitted with
# XLA's excess precision off, so that it rounds each bf16 op as PyTorch's
# eager ops do (with it on, its fusions carry f32 between bf16 ops and its
# jamba leaves read up to 3x closer to f32).  Two roundings of one step
# scatter: the port reads 0.7-1.45 times the reference per leaf (1.45 and
# 1.37 on two of jamba's SSM leaves, at most 1.21 elsewhere).
BF16_TOL, BF16_FACTOR = 2e-2, 2.0


def _loss_and_grads_both(name, dtype):
    jcfg, tcfg = J_SMOKE[name], T_SMOKE[name]
    jp = jtr.lm_init(jax.random.key(0), jcfg, dtype=dtype)
    tok = _tokens(jcfg)
    f = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, {"tokens": jnp.asarray(tok)}, jcfg)))
    jl, jg = f(jp)
    tp = ttr.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [x.requires_grad_(True) for x in ttree.leaves(tp)]
    tl = ttr.lm_loss(ttree.unflatten_like(tp, leaves),
                     {"tokens": torch.from_numpy(tok)}, tcfg)
    return (float(jl), jax.tree.leaves(jg), float(tl.detach()),
            torch.autograd.grad(tl, leaves), f, jp)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_loss_and_grads_match_reference(name):
    jl, jg, tl, tg, _, jp = _loss_and_grads_both(name, jnp.float32)
    assert abs(tl - jl) <= TOL * abs(jl)
    assert len(tg) == len(jg)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL.get(name, TOL))
    if name not in GRAD_TOL:
        return
    # the looser tolerance is the network's f32 rounding, not the port's:
    # both packages sit within F64_TOL of a float64 step
    tp = ttr.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = [x.double().requires_grad_(True) for x in ttree.leaves(tp)]
    with tcommon.upcast(torch.float64):
        loss64 = ttr.lm_loss(ttree.unflatten_like(tp, leaves),
                             {"tokens": torch.from_numpy(_tokens(
                                 J_SMOKE[name]))}, T_SMOKE[name])
        g64 = torch.autograd.grad(loss64, leaves)
    for got, want, exact in zip(tg, jg, g64):
        norm = float(exact.norm())
        assert float((got.double() - exact).norm()) <= F64_TOL * norm
        assert float((torch.from_numpy(np.asarray(want, np.float64))
                      - exact).norm()) <= F64_TOL * norm


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_bf16_loss_and_grads(name):
    """bf16 params from the reference's bf16 init: every leaf's dtype and
    its gradient's as the reference's (routers, SSM and xLSTM gate params
    stay f32), the loss within BF16_TOL of the reference's, each gradient
    leaf by the BF16_FACTOR rule against the f32 step from the same
    values."""
    jl, _, tl, tg, f, jp = _loss_and_grads_both(name, jnp.bfloat16)
    _, g32 = f(jax.tree.map(lambda t: t.astype(jnp.float32), jp))
    assert abs(tl - jl) <= BF16_TOL * abs(jl)
    jcfg = J_SMOKE[name]
    tok = jnp.asarray(_tokens(jcfg))
    _, jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.lm_loss(p, {"tokens": tok}, jcfg))).lower(jp).compile(
        compiler_options={"xla_allow_excess_precision": False})(jp)
    jg = jax.tree.leaves(jg)
    for got, want, exact, leaf in zip(tg, jg, jax.tree.leaves(g32),
                                      jax.tree.leaves(jp)):
        assert str(got.dtype) == f"torch.{want.dtype}" == \
            f"torch.{leaf.dtype}"
        exact = np.asarray(exact, np.float64)
        norm = np.linalg.norm(exact)
        d_port = np.linalg.norm(got.double().numpy() - exact) / norm
        d_ref = np.linalg.norm(np.asarray(want, np.float64) - exact) / norm
        assert d_port <= max(BF16_TOL, BF16_FACTOR * d_ref)


def test_bf16_train_loop_resume_equals_uninterrupted(tmp_path):
    """bf16 params with AdamW's f32 master copy: the bf16 leaves go
    through a checkpoint and the resumed run is bit-equal."""
    cfg = T_SMOKE["jamba-1.5-large-398b"]
    tc = TTrainConfig(total_steps=4, checkpoint_every=0, learning_rate=1e-3,
                      seed=3, keep_checkpoints=1)
    kw = dict(batch_size=2, seq_len=16, log_every=0, device="cpu",
              param_dtype=torch.bfloat16)
    full = train_loop(cfg, tc, steps=4, **kw)
    train_loop(cfg, tc, steps=2, ckpt_dir=str(tmp_path), **kw)
    rest = train_loop(cfg, tc, steps=4, ckpt_dir=str(tmp_path), **kw)
    assert rest["resumed_from"] == 2
    assert rest["losses"] == full["losses"][2:]
    assert all(np.isfinite(full["losses"]))
    assert full["params"]["embed"].dtype == torch.bfloat16
    assert full["opt_state"]["master"]["embed"].dtype == torch.float32
    for a, b in zip(ttree.leaves(rest["params"]),
                    ttree.leaves(full["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
