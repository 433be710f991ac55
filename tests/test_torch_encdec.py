"""The port's encoder–decoder and modality-frontend LMs against the JAX
package's: cross-attention (memory length S ≠ T, S not a multiple of the kv
chunk), the encoder's bidirectional self-attention, ``encode``, ``lm_loss``
and every gradient leaf of seamless-m4t-medium's smoke config (dense, and
its ReLU FFN under ``IN_OUT_WR``) and internvl2-1b's from the reference's
params, the count dicts, ``make_train_step`` over three steps with
microbatches 1 and 2, ``train_batch``'s layout and the data iterators.
Same numpy inputs into both; tolerance 1e-5 (f32).

Count dicts: the decoder's periods are held as ``tests/test_torch_lm.py``
holds them (the reference's ``lax.scan`` counts at trace time, so the port
is held to one unscanned block × the depth); the unrolled encoder is
counted by both packages layer by layer, as the reference's ``encode``
counts it.  Both packages run the configs' ``remat=True`` (each encoder
layer and decoder period checkpointed); under it the reference's
``jax.checkpoint`` traces each encoder layer's forward again in the
backward pass and counts it twice, while the port counts the step's work
once (``tests/test_torch_remat.py`` states the difference), so the count
comparison takes the reference's counts at ``remat=False``, which changes
no number of the step."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import SMOKE_ARCHS as J_SMOKE
from repro.data import pipeline as jpipe
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.optim import optimizer as jopt
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import train_loop
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
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
    tffn.set_relu_mask_hook(None)
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
    """fn(tree of torch leaves) → (value, gradients in flatten order; zeros
    for leaves ``fn`` does not use, as ``jax.grad`` gives them)."""
    leaves = [x.requires_grad_(True) for x in ttree.leaves(tree)]
    out = fn(ttree.unflatten_like(tree, leaves))
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return out, [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_cross_attention_matches_reference():
    """GQA 4:2 queries over a memory of S = 11 against T = 6, kv chunk 4
    (S padded to 12 with masked keys), q chunk 4 (T ragged too)."""
    acfg = jattn.AttnConfig(d_model=16, n_heads=4, n_kv_heads=2, head_dim=4,
                            q_chunk=4, kv_chunk=4)
    tcfg = tattn.AttnConfig(**dataclasses.asdict(acfg))
    p = _np_tree(jattn.cross_attn_init(jax.random.key(0), acfg, 12))
    x, mem = _randn(2, 6, 16, seed=1), _randn(2, 11, 12, seed=2)
    want, jg = jax.jit(lambda p, x, m: (
        jattn.cross_attn_apply(p, x, m, acfg),
        jax.grad(lambda p, x, m: jattn.cross_attn_apply(p, x, m, acfg).sum(),
                 argnums=(0, 1, 2))(p, x, m)))(p, jnp.asarray(x),
                                               jnp.asarray(mem))
    tp = ttr.params_from_jax(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    got = tattn.cross_attn_apply(tp, xt, mt, tcfg)
    assert got.shape == (2, 6, 16)
    _close(got, want)
    _, tg = _value_and_grad(
        lambda q: tattn.cross_attn_apply(q, xt, mt, tcfg).sum(), tp)
    _grads_close(tg, jg[0])
    gx, gm = torch.autograd.grad(
        tattn.cross_attn_apply(tp, xt, mt, tcfg).sum(), (xt, mt))
    _close(gx, jg[1])
    _close(gm, jg[2])


def _seamless(**kw):
    return (J_SMOKE["seamless-m4t-medium"].with_(**kw),
            T_SMOKE["seamless-m4t-medium"].with_(**kw))


def test_encoder_block_matches_reference():
    """One encoder layer (``causal=False``): bidirectional self-attention
    with RoPE over 9 frames (q/kv chunk 4), then the ReLU FFN."""
    jcfg, tcfg = _seamless(q_chunk=4, kv_chunk=4)
    p = _np_tree(jtr.lm_init(jax.random.key(0), jcfg,
                             dtype=jnp.float32))["encoder"]["layers"][1]
    x = _randn(2, 9, jcfg.d_model, seed=3)
    want, jg = jax.jit(lambda p, x: (
        jtr.block_apply(p, x, jcfg, "A", False, causal=False)[0],
        jax.grad(lambda p, x: jtr.block_apply(
            p, x, jcfg, "A", False, causal=False)[0].sum(),
            argnums=(0, 1))(p, x)))(p, jnp.asarray(x))
    tp = ttr.params_from_jax(p, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux = ttr.block_apply(tp, xt, tcfg, "A", causal=False)
    _close(got, want)
    assert float(aux) == 0.0
    # bidirectional: the first frame's output sees the last frame
    causal, _ = ttr.block_apply(tp, xt, tcfg, "A")
    assert not torch.allclose(causal[:, 0], got[:, 0])
    _, tg = _value_and_grad(
        lambda q: ttr.block_apply(q, xt, tcfg, "A", causal=False)[0].sum(),
        tp)
    _grads_close(tg, jg[0])
    (gx,) = torch.autograd.grad(
        ttr.block_apply(tp, xt, tcfg, "A", causal=False)[0].sum(), xt)
    _close(gx, jg[1])


def test_encode_matches_reference():
    """The encoder trunk: the frontend projection (32 → 64), two
    bidirectional layers and the final norm."""
    jcfg, tcfg = _seamless()
    pn = _np_tree(jtr.lm_init(jax.random.key(0), jcfg, dtype=jnp.float32))
    fe = _randn(2, jcfg.frontend_len, jcfg.frontend_dim, seed=4)
    # a random readout: the sum of squares of a LayerNorm's output is
    # constant, and would leave every gradient at rounding noise
    r = _randn(2, jcfg.frontend_len, jcfg.d_model, seed=5)
    want, jg = jax.jit(lambda p, fe: (
        jtr.encode(p, fe, jcfg),
        jax.grad(lambda p: (jtr.encode(p, fe, jcfg) * r).sum())(p)))(
            pn, jnp.asarray(fe))
    tp = ttr.params_from_jax(pn, device="cpu")
    got = ttr.encode(tp, torch.from_numpy(fe), tcfg)
    assert got.shape == (2, jcfg.frontend_len, jcfg.d_model)
    _close(got, want)
    _, tg = _value_and_grad(lambda q: (ttr.encode(
        q, torch.from_numpy(fe), tcfg) * torch.from_numpy(r)).sum(), tp)
    _grads_close(tg, jg)


CONFIGS = {
    "seamless-m4t-medium": _seamless(),
    "seamless-m4t-medium-in-out-wr": _seamless(
        sparse_ffn_scenario="IN_OUT_WR"),
    "internvl2-1b": (J_SMOKE["internvl2-1b"], T_SMOKE["internvl2-1b"]),
}


def _batch(cfg, b=2, t=17, seed=0):
    """Tokens (B, t) and the frontend embeddings the config takes, as
    ``tests/test_models_smoke.py`` lays them out."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.enc_dec or cfg.frontend:
        out["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return out


def _per_step_counts(jcfg, pn, batch):
    """The reference's counts of one step of the port: its encoder as
    ``encode`` counts it at ``remat=False`` (once a layer), plus one
    unscanned decoder block × the depth."""
    jcfg = jcfg.with_(remat=False)
    jstats.reset()
    memory = None
    if jcfg.enc_dec:
        fe = jnp.asarray(batch["frontend_embeds"])
        jax.grad(lambda p: jtr.encode(p, fe, jcfg).sum())(pn)
        memory = jnp.asarray(_randn(2, jcfg.frontend_len, jcfg.d_model))
    enc = jstats.counts()
    jstats.reset()
    blk = jax.tree.map(lambda x: x[0], pn["layers"]["b0"])
    x = jnp.asarray(_randn(2, 16, jcfg.d_model, seed=1))
    jax.grad(lambda p, x: jtr.block_apply(p, x, jcfg, "A", False,
                                          memory=memory)[0].sum(),
             argnums=(0, 1))(blk, x)
    out = dict(enc)
    for k, v in jstats.counts().items():
        out[k] = out.get(k, 0) + v * jcfg.n_layers
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_loss_and_grads_match_reference(name):
    jcfg, tcfg = CONFIGS[name]
    pn = _np_tree(jtr.lm_init(jax.random.key(0), jcfg, dtype=jnp.float32))
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jtr.lm_loss(p, b, jcfg)))(
        pn, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = ttr.params_from_jax(pn, device="cpu")
    tstats.reset()
    tl, tg = _value_and_grad(lambda q: ttr.lm_loss(
        q, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg), tp)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    _grads_close(tg, jg)
    got_counts = tstats.counts()
    want_counts = _per_step_counts(jcfg, pn, batch)
    assert got_counts == want_counts
    if name.endswith("in-out-wr"):
        # 12 layers' worth of sparse FFN GEMMs: encoder 2 + decoder 2
        assert want_counts["gemm:dense:1"] == 6 * 4
        assert want_counts["scan:act"] == 4
    else:
        assert want_counts == {}


def test_frontend_positions_get_no_targets():
    """internvl2's frontend embeddings come before the tokens and carry no
    loss: the loss is unchanged by the targets' alignment only if the F
    frontend positions are padded."""
    _, tcfg = CONFIGS["internvl2-1b"]
    tp = ttr.lm_init(0, tcfg, dtype=torch.float32, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    h, aux = ttr.lm_hidden(tp, batch["tokens"][:, :-1], tcfg,
                           frontend_embeds=batch["frontend_embeds"])
    f = tcfg.frontend_len
    assert h.shape == (2, f + 16, tcfg.d_model) and float(aux) == 0.0
    want = ttr.chunked_xent(h[:, f:].reshape(-1, tcfg.d_model),
                            batch["tokens"][:, 1:].reshape(-1),
                            ttr.lm_head_weight(tp, tcfg))
    _close(ttr.lm_loss(tp, batch, tcfg), want.detach().numpy())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    """Three AdamW steps of seamless's smoke config under ``IN_OUT_WR``,
    frontend embeddings split with the tokens into microbatches; each step
    taken by both packages from the reference's state of that step, held
    as ``tests/test_torch_lm.py`` holds the dense decoder's."""
    jcfg, tcfg = CONFIGS["seamless-m4t-medium-in-out-wr"]
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
        batch = _batch(jcfg, b=4, seed=10 + step)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k in ("loss", "grad_norm", "lr", "skipped"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                TOL * max(abs(float(jm[k])), 1e-6), k
        mus = jax.tree.leaves(jo["mu"])
        weights = list(zip(ttree.leaves(tp), jax.tree.leaves(jp), mus))
        for (path, got), want in zip(ttree.leaves_with_paths(to),
                                     jax.tree.leaves(jo)):
            if path.startswith("['master']"):
                weights.append((got, want, mus[len(weights) - len(mus)]))
            else:
                _close(got, want)
        for got, want, mu in weights:
            if step > 0:
                _close(got, want)
                continue
            _first_update_close(got, want, mu, float(jm["lr"]))


def _first_update_close(got, want, mu, lr, beta1=0.9, eps=1e-8):
    """The weights after the first AdamW step.  From zero moments the
    update is lr·g/(|g| + eps): an element whose gradient sits at f32
    rounding noise may move the other way (each weight is held to one
    flipped update, 2·lr), and one whose |g| is within a few eps of 0 moves
    by a fraction of lr that the gradient's last bits decide (seamless's
    LayerNorm biases hold such elements).  The moments, which carry the
    gradients, are held at TOL beside this; each leaf is held to 1e-4 in
    relative L2 norm over its elements with |g| ≥ 1e3·eps, where the
    update is lr·sign(g) within 0.1 %.  g is the reference's, recovered
    from its first moment (1 - β1)·g."""
    d = got.numpy() - np.asarray(want)
    assert float(np.abs(d).max()) <= 2 * lr
    settled = np.abs(np.asarray(mu)) / (1 - beta1) >= 1e3 * eps
    assert np.linalg.norm(d[settled]) <= 1e-4 * np.linalg.norm(want)


def test_relu_mask_hook_replays_masks():
    """The float64 check's seam: the dense ReLU FFN under a recorded σ′
    mask equals the plain FFN where the mask is its own, and follows a
    changed mask; the sparse FFN refuses a replaced mask."""
    cfg = tffn.FFNConfig(8, 16, "relu")
    p = tffn.ffn_init(0, cfg, device="cpu")
    x = torch.randn((5, 8), generator=torch.Generator().manual_seed(1))
    masks = []
    tffn.set_relu_mask_hook(lambda h: masks.append(h > 0))
    y = tffn.ffn_apply(p, x, cfg)
    tffn.set_relu_mask_hook(lambda h: masks[0])
    assert torch.equal(tffn.ffn_apply(p, x, cfg), y)
    flipped = masks[0].clone()
    flipped[0, 0] = ~flipped[0, 0]
    tffn.set_relu_mask_hook(lambda h: flipped)
    assert not torch.equal(tffn.ffn_apply(p, x, cfg), y)
    sparse = dataclasses.replace(cfg, sparse_policy=T_SMOKE[
        "seamless-m4t-medium"].with_(
            sparse_ffn_scenario="IN_OUT_WR").ffn_config().sparse_policy)
    with pytest.raises(ValueError, match="dense FFN"):
        tffn.ffn_apply(p, x, sparse)


def test_train_batch_follows_the_reference_layout():
    """``registry.train_input_specs``' shapes at (batch 8, seq 512) for the
    three full configs of this family, deterministic in (seed, step)."""
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import train_input_specs
    shape = ShapeConfig("t", 512, 8, "train")
    for name in ("seamless-m4t-medium", "internvl2-1b",
                 "deepseek-v2-lite-16b"):
        cfg = T_ARCHS[name]
        specs = train_input_specs(J_ARCHS[name], shape)
        got = tpipe.train_batch(cfg, 0, 3, batch=8, seq_len=512, device="cpu")
        assert sorted(got) == sorted(specs)
        for k, spec in specs.items():
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
        again = tpipe.train_batch(cfg, 0, 3, batch=8, seq_len=512,
                                  device="cpu")
        other = tpipe.train_batch(cfg, 0, 4, batch=8, seq_len=512,
                                  device="cpu")
        for k in got:
            assert torch.equal(got[k], again[k])
            assert not torch.equal(got[k], other[k])
    fe = tpipe.train_batch(T_ARCHS["internvl2-1b"], 0, 0, batch=8,
                           seq_len=512, device="cpu")["frontend_embeds"]
    assert fe.dtype == torch.float32
    assert abs(float(fe.mean())) < 0.01 and abs(float(fe.std()) - 1) < 0.01


def test_train_loop_refuses_frontend_configs():
    for name in ("seamless-m4t-medium", "internvl2-1b"):
        with pytest.raises(NotImplementedError, match="frontend"):
            train_loop(T_SMOKE[name], TTrainConfig(), batch_size=2,
                       seq_len=4, steps=1, device="cpu")


def test_lm_synthetic_iterates_like_the_reference():
    """The iterator draws ``lm_batch`` at its cursor and advances it by one
    a batch, as the reference's; a cursor restored from a ``DataState``
    resumes the stream."""
    kw = dict(seed=2, batch=4, seq_len=9, vocab=50)
    ref = jpipe.LMSynthetic(**kw)
    it = tpipe.LMSynthetic(**kw, device="cpu")
    for step in range(3):
        jb, tb = next(ref), next(it)
        assert jb["tokens"].shape == tuple(tb["tokens"].shape)
        assert torch.equal(tb["tokens"], tpipe.lm_batch(
            2, step, batch=4, seq_len=9, vocab=50, device="cpu")["tokens"])
        assert it.state.step == ref.state.step == step + 1
    resumed = tpipe.LMSynthetic(**kw, state=tpipe.DataState(step=2),
                                device="cpu")
    fresh = tpipe.LMSynthetic(**kw, device="cpu")
    next(fresh)
    next(fresh)
    assert torch.equal(next(resumed)["tokens"], next(fresh)["tokens"])
    assert iter(it) is it
    assert tpipe.DataState() == tpipe.DataState(step=0)


def test_image_synthetic_iterates_like_the_reference():
    kw = dict(seed=1, batch=2, image_size=8, num_classes=10)
    ref = jpipe.ImageSynthetic(**kw)
    it = tpipe.ImageSynthetic(**kw, device="cpu")
    for step in range(2):
        (jimg, jlab), (img, lab) = next(ref), next(it)
        assert jimg.shape == tuple(img.shape) and jlab.shape == tuple(
            lab.shape)
        want_img, want_lab = tpipe.image_batch(1, step, batch=2, image_size=8,
                                               num_classes=10, device="cpu")
        assert torch.equal(img, want_img) and torch.equal(lab, want_lab)
        assert it.state.step == ref.state.step == step + 1
