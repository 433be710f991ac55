"""The port's MLA and mixture-of-experts LMs against the JAX package's:
``_mla_apply``, ``moe_apply`` (output, aux loss and gradients, with and
without dropped tokens and with device-limited routing), ``lm_loss`` and
every gradient leaf of deepseek-v2-lite's and grok-1's smoke configs from
the reference's params (``params_from_jax``) with equal count dicts,
``make_train_step`` over three steps with microbatches 1 and 2, and a
``train_loop`` resume.  Same numpy inputs into both; tolerance 1e-5 (f32).

Ties in top-k: ``jax.lax.top_k`` puts the lower index first on a tie and
``torch.topk`` promises no order.  The inputs are continuous random f32, so
the router's probabilities are distinct; each routing test asserts that
no two of a token's probabilities around its k-th choice are equal, so a
tie cannot pass unseen.  Device-limited routing zeroes the probabilities
of the groups left out; the test draws at least ``k`` live experts per
token, so the zeros are never chosen."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro_torch import tree as ttree
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train_loop
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.optim import optimizer as topt

TOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()
    yield
    tmoe.set_routing_hook(None)
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_close(tg, jg):
    jl = jax.tree.leaves(jg)
    assert len(tg) == len(jl)
    for got, want in zip(tg, jl):
        _close(got, want)


def _value_and_grad(fn, tree):
    """fn(tree of torch leaves) → (value, gradients in flatten order)."""
    leaves = [x.requires_grad_(True) for x in ttree.leaves(tree)]
    out = fn(ttree.unflatten_like(tree, leaves))
    return out, torch.autograd.grad(out, leaves)


def test_mla_matches_reference():
    """MLA at the deepseek smoke widths: q/k head dim nope + rope = 24
    against v_head_dim 16, one RoPE key shared by the heads, the scale
    24 ** -0.5; a ragged last chunk."""
    acfg = dataclasses.replace(
        J_SMOKE["deepseek-v2-lite-16b"].attn_config(), q_chunk=4,
        kv_chunk=3)
    tcfg = tattn.AttnConfig(**dataclasses.asdict(acfg))
    p = _np_tree(jattn.attn_init(jax.random.key(2), acfg))
    assert sorted(p) == ["wdkv", "wkr", "wo", "wq", "wuk", "wuv"]
    x = np.random.default_rng(0).standard_normal(
        (2, 10, acfg.d_model)).astype(np.float32)
    want, jg = jax.jit(lambda p, x: (
        jattn.attn_apply(p, x, acfg),
        jax.grad(lambda p, x: jattn.attn_apply(p, x, acfg).sum(),
                 argnums=(0, 1))(p, x)))(p, jnp.asarray(x))
    tp = ttr.params_from_jax(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tattn.attn_apply(tp, xt, tcfg)
    _close(got, want)
    _, tg = _value_and_grad(lambda q: tattn.attn_apply(q, xt, tcfg).sum(),
                            tp)
    _grads_close(tg, jg[0])
    (gx,) = torch.autograd.grad(tattn.attn_apply(tp, xt, tcfg).sum(), xt)
    _close(gx, jg[1])


def _assert_no_ties(probs, k):
    """No token's k-th and (k+1)-th largest probabilities are equal."""
    s = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert (s[:, k - 1] > s[:, k]).all()


MOE_CASES = {
    # capacity 1.25 × T·k/E = 20 slots: some tokens dropped at T = 32
    "drops": (jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                             n_shared_experts=1, d_ff_shared=24), 32),
    "no_drops": (jmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                                capacity_factor=8.0, activation="gelu_glu"),
                 24),
    # top-1 would renormalize each gate to exactly 1, leaving the router a
    # gradient of rounding noise beside the aux loss's: top-2 here
    "relu_low_capacity": (jmoe.MoEConfig(n_experts=4, top_k=2,
                                         d_ff_expert=16, activation="relu",
                                         capacity_factor=0.5), 24),
    # the reference's own device-limited case (tests/test_perf_features.py)
    "device_limited": (jmoe.MoEConfig(n_experts=16, top_k=4, d_ff_expert=8,
                                      device_groups=4, top_groups=2,
                                      capacity_factor=8.0,
                                      n_shared_experts=2, d_ff_shared=16),
                       32),
}


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_apply_matches_reference(name):
    jcfg, t = MOE_CASES[name]
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    d = 16
    p = _np_tree(jmoe.moe_init(jax.random.key(3), d, jcfg))
    x = np.random.default_rng(1).standard_normal((t, d)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    if jcfg.device_groups:
        g = jcfg.device_groups
        pg = probs.reshape(t, g, -1)
        _assert_no_ties(pg.max(-1), jcfg.top_groups)
    else:
        _assert_no_ties(probs, jcfg.top_k)

    (jy, jaux), jg = jax.jit(lambda p, x: (
        jmoe.moe_apply(p, x, jcfg),
        jax.grad(lambda p, x: (lambda y, a: (y * y).sum() + a)(
            *jmoe.moe_apply(p, x, jcfg)), argnums=(0, 1))(p, x)))(
                p, jnp.asarray(x))

    seen = {}

    def record(tag, v):
        seen[tag] = v
        return v

    tmoe.set_routing_hook(record)
    tp = ttr.params_from_jax(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_apply(tp, xt, tcfg)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= TOL * abs(float(jaux))
    capacity = tmoe.capacity_of(t, tcfg)
    dropped = int((~seen["keep"]).sum())
    if name in ("drops", "relu_low_capacity"):
        assert dropped > 0
    else:
        assert dropped == 0
    if jcfg.device_groups:     # each token's experts lie in its groups
        groups = seen["gate_idx"] // (jcfg.n_experts // jcfg.device_groups)
        for row, allowed in zip(groups.tolist(), seen["group_idx"].tolist()):
            assert set(row) <= set(allowed)
    assert capacity == max(1, int(t * jcfg.top_k / jcfg.n_experts
                                  * jcfg.capacity_factor))

    def loss(q):
        y, a = tmoe.moe_apply(q, xt, tcfg)
        return (y * y).sum() + a
    _, tg = _value_and_grad(loss, tp)
    _grads_close(tg, jg[0])
    tp2 = ttr.params_from_jax(p, device="cpu")
    (gx,) = torch.autograd.grad(loss(tp2), xt)
    _close(gx, jg[1])


def test_routing_hook_replays_a_routing():
    """The float64 check's seam: a routing recorded in one call and
    replayed in another gives that call the recorded experts and drops,
    bit for bit, even where the replaying inputs would route otherwise."""
    jcfg, t = MOE_CASES["drops"]
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    tp = ttr.params_from_jax(_np_tree(jmoe.moe_init(jax.random.key(3), 16,
                                                    jcfg)), device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((t, 16), generator=g)
    rec = []
    tmoe.set_routing_hook(lambda tag, v: rec.append((tag, v)) or v)
    y, _ = tmoe.moe_apply(tp, x, tcfg)
    replay = iter(rec)

    def play(tag, v):
        tag0, v0 = next(replay)
        assert tag0 == tag
        return v0
    tmoe.set_routing_hook(play)
    y2, _ = tmoe.moe_apply(tp, x, tcfg)
    assert torch.equal(y, y2)
    replay = iter(rec)
    other = torch.randn((t, 16), generator=g)
    y3, _ = tmoe.moe_apply(tp, other, tcfg)
    tmoe.set_routing_hook(None)
    y4, _ = tmoe.moe_apply(tp, other, tcfg)
    assert not torch.equal(y3, y4)


def test_moe_backward_is_deterministic():
    """Two backward passes of one dispatch with drops give bit-equal
    gradients (the dispatch and combine gathers accumulate at most one
    value per used row)."""
    jcfg, t = MOE_CASES["drops"]
    tcfg = tmoe.MoEConfig(**dataclasses.asdict(jcfg))
    p = _np_tree(jmoe.moe_init(jax.random.key(4), 16, jcfg))
    x = torch.randn((t, 16), generator=torch.Generator().manual_seed(5))
    outs = []
    for _ in range(2):
        tp = ttr.params_from_jax(p, device="cpu")
        xt = x.clone().requires_grad_(True)
        _, g = _value_and_grad(
            lambda q: (lambda y, a: (y * y).sum() + a)(
                *tmoe.moe_apply(q, xt, tcfg)), tp)
        outs.append(g)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


CONFIGS = ("deepseek-v2-lite-16b", "grok-1-314b")


def _tokens(cfg, b=2, t=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("name", CONFIGS)
def test_lm_loss_and_grads_match_reference(name):
    """Loss (with the aux losses summed over layers) and every gradient
    leaf; the count dicts: no FFN of these configs is ReLU-family, so both
    packages count nothing."""
    jcfg, tcfg = J_SMOKE[name], T_SMOKE[name]
    pn = _np_tree(jtr.lm_init(jax.random.key(0), jcfg, dtype=jnp.float32))
    if name.startswith("deepseek"):
        assert isinstance(pn["prefix"], list) and len(pn["prefix"]) == 1
        assert "moe" in pn["layers"]["b0"] and "ffn" in pn["prefix"][0]
    tok = _tokens(jcfg)
    (jl, jg), (jh, jaux) = jax.jit(lambda p, tok: (
        jax.value_and_grad(lambda p: jtr.lm_loss(p, {"tokens": tok},
                                                 jcfg))(p),
        jtr.lm_hidden(p, tok[:, :-1], jcfg)))(pn, jnp.asarray(tok))
    jcounts = jstats.counts()
    tp = ttr.params_from_jax(pn, device="cpu")
    tl, tg = _value_and_grad(
        lambda q: ttr.lm_loss(q, {"tokens": torch.from_numpy(tok)}, tcfg),
        tp)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    _grads_close(tg, jg)
    h, aux = ttr.lm_hidden(tp, torch.from_numpy(tok[:, :-1]), tcfg)
    _close(h, jh)
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= TOL * float(jaux)
    assert tstats.counts() == jcounts == {}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """Three AdamW steps of deepseek-v2-lite's smoke config, each taken by
    both packages from the reference's state of that step; loss, grad
    norm, lr, moments and weights as ``tests/test_torch_lm.py`` holds the
    dense decoder's."""
    jcfg, tcfg = J_SMOKE["deepseek-v2-lite-16b"], \
        T_SMOKE["deepseek-v2-lite-16b"]
    ocfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt.OptConfig(**ocfg), microbatches=microbatches))
    tstep = tsteps.make_train_step(tcfg, topt.OptConfig(**ocfg),
                                   microbatches=microbatches)
    jp = jtr.lm_init(jax.random.key(1), jcfg, dtype=jnp.float32)
    jo = jopt.adamw_init(jp)
    for step in range(3):
        tp, to = (ttr.params_from_jax(_np_tree(t), device="cpu")
                  for t in (jp, jo))
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


def test_train_loop_resume_equals_uninterrupted(tmp_path):
    """deepseek-v2-lite's smoke config (MLA, the dense prefix, MoE): a run
    cut at step 3 and resumed from its checkpoint ends bit-equal to an
    uninterrupted one."""
    cfg = T_SMOKE["deepseek-v2-lite-16b"]
    tc = TTrainConfig(total_steps=6, checkpoint_every=0, learning_rate=1e-3,
                      seed=3, keep_checkpoints=1)
    kw = dict(batch_size=4, seq_len=16, log_every=0, device="cpu")
    full = train_loop(cfg, tc, steps=6, **kw)
    first = train_loop(cfg, tc, steps=3, ckpt_dir=str(tmp_path), **kw)
    rest = train_loop(cfg, tc, steps=6, ckpt_dir=str(tmp_path), **kw)
    assert first["resumed_from"] is None and rest["resumed_from"] == 3
    assert first["losses"] + rest["losses"] == full["losses"]
    assert all(np.isfinite(full["losses"]))
    for a, b in zip(ttree.leaves(rest["params"]),
                    ttree.leaves(full["params"])):
        assert torch.equal(a, b)
