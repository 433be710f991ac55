"""The port's cached decode and serving against the JAX package's:
``attn_decode`` on a sliding-window ring buffer past its wrap and MLA's
absorbed decode over the latent cache; ``decode_step`` of all ten SMOKE
architectures token by token (logits and every cache leaf, in place);
decode against the parallel forward (window, Mamba, xLSTM, MLA + MoE);
``make_prefill_step``'s logits; ``ServeEngine``'s finished token lists
equal to the reference engine's for the same params and prompts; and the
``launch.serve`` CLI.  Same numpy inputs and the reference's weights
(``params_from_jax``) into both; tolerance 1e-5 (f32), 2e-2 (bf16 params),
decode against the parallel forward at the reference's 2e-3 (5e-3 with
MoE)."""
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
from repro.models import transformer as jtr
from repro.serving import engine as jengine
from repro_torch import tree as ttree
from repro_torch.configs import SMOKE_ARCHS as T_SMOKE
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.serving import engine as tengine

TOL = 1e-5
# bf16 params: tests/test_kernels_masked_matmul.py's bf16 tolerance, or
# BF16_FACTOR times the reference's own bf16 error (``_bf16_close``), as in
# tests/test_torch_lm.py
BF16_TOL, BF16_FACTOR = 2e-2, 2.0
ARCHS = sorted(J_SMOKE)
BF16_ARCHS = ("gemma3-12b", "jamba-1.5-large-398b", "xlstm-350m",
              "deepseek-v2-lite-16b")


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


def _close(got, want, tol=TOL):
    got = got.detach().cpu().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both_params(jcfg, seed=0, dtype=jnp.float32):
    pn = _np_tree(jtr.lm_init(jax.random.key(seed), jcfg, dtype=dtype))
    return pn, ttr.params_from_jax(pn, device="cpu")


def _no_drops(cfg):
    """Capacity raised so no (token, choice) pair drops: decode routes B
    tokens and the parallel forward B·T, whose drop sets differ at the
    default capacity (the reference's test does the same)."""
    if cfg.moe is None:
        return cfg
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def _per_op_rounding(jcfg):
    """The reference's ``decode_step``, jitted with XLA's excess precision
    off: each bf16 op's result rounded, as PyTorch's eager ops round it
    (with it on, XLA's fusions carry f32 between bf16 ops)."""
    step = jax.jit(lambda p, tok, c, i: jtr.decode_step(p, tok, c, i, jcfg))
    compiled = []

    def run(p, tok, c, i):
        if not compiled:
            compiled.append(step.lower(p, tok, c, i).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](p, tok, c, i)
    return run


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _bf16_close(port, ref16, ref32):
    """The port's bf16 result no farther from the reference's f32 result
    of the same values than BF16_FACTOR times the reference's own bf16
    result is, or BF16_TOL: an 8-layer bf16 stack such as jamba's reads up
    to 0.13 there; the port at most 1.62 times the reference (one of
    jamba's engine ticks)."""
    assert _rel(port, ref32) <= max(BF16_TOL,
                                    BF16_FACTOR * _rel(ref16, ref32))


@pytest.mark.parametrize("use_mla,window", [(False, 4), (True, None)])
def test_attn_decode_matches_reference(use_mla, window):
    """Ten steps: a window of 4 over a cache of 4 slots wraps twice."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              window=window, use_mla=use_mla, kv_lora_rank=16,
              qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    pn = _np_tree(jattn.attn_init(jax.random.key(0), jcfg))
    tp = ttr.params_from_jax(pn, device="cpu")
    b, t = 2, 10
    jc = jattn.init_cache(jcfg, b, t, jnp.float32)
    tc = tattn.init_cache(tcfg, b, t, torch.float32, "cpu")
    assert {k: v.shape for k, v in jc.items()} == \
        {k: tuple(v.shape) for k, v in tc.items()}
    step = jax.jit(lambda p, x, c, i: jattn.attn_decode(p, x, c, i, jcfg))
    x = np.random.default_rng(2).standard_normal(
        (b, t, 32)).astype(np.float32)
    for i in range(t):
        jy, jc = step(pn, jnp.asarray(x[:, i:i + 1]), jc, jnp.asarray(i))
        ty, tc2 = tattn.attn_decode(tp, torch.from_numpy(x[:, i:i + 1]), tc,
                                    i, tcfg)
        assert tc2 is tc
        _close(ty, jy)
        for k in sorted(jc):
            _close(tc[k], jc[k])


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in ARCHS] + [
    (n, "bfloat16") for n in BF16_ARCHS])
def test_decode_step_matches_reference(name, dtype):
    """Six tokens through ``decode_step``: logits and every cache leaf
    against the reference's, the caches updated in place (the window's
    wrap is held in ``test_attn_decode_matches_reference`` and
    ``test_decode_matches_parallel_forward``).  bf16 params with the f32
    caches both engines default to, against the reference at per-op
    rounding: within ``_bf16_tol`` at each step."""
    jcfg, tcfg = J_SMOKE[name], T_SMOKE[name]
    pn, tp = _both_params(jcfg, dtype=getattr(jnp, dtype))
    b, t, max_len = 2, 6, 16
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
    mem = rng.standard_normal((b, 8, jcfg.d_model)).astype(np.float32) \
        if jcfg.enc_dec else None
    tc = ttr.init_caches(tcfg, b, max_len, torch.float32, device="cpu")

    def reference(params, step):
        jc = jtr.init_caches(jcfg, b, max_len, jnp.float32)
        logits = []
        for i in range(t):
            jl, jc = step(params, jnp.asarray(toks[:, i]), jc,
                          jnp.asarray(i))
            logits.append(jl)
        return logits, jc
    if dtype == "float32":
        m = None if mem is None else jnp.asarray(mem)
        want, jc = reference(pn, jax.jit(lambda p, tok, c, i: jtr.decode_step(
            p, tok, c, i, jcfg, memory=m)))
        want32 = jc32 = None
    else:
        # the reference at per-op rounding, from bf16 and from f32 params
        want, jc = reference(pn, _per_op_rounding(jcfg))
        want32, jc32 = reference(jax.tree.map(
            lambda x: np.asarray(x, np.float32), pn), _per_op_rounding(jcfg))

    def close(got, ref, ref32):
        if ref32 is None:
            _close(got, ref)
        else:
            _bf16_close(got.numpy(), ref, ref32)
    assert [p for p, _ in ttree.leaves_with_paths(tc)] == \
        [jax.tree_util.keystr(k) for k, _ in
         jax.tree_util.tree_flatten_with_path(jc)[0]]
    tmem = None if mem is None else torch.from_numpy(mem)
    head = ttr.decode_head(tp, tcfg)
    for i in range(t):
        tl, tc2 = ttr.decode_step(tp, torch.from_numpy(toks[:, i]), tc, i,
                                  tcfg, memory=tmem, head=head)
        assert tc2 is tc and tl.dtype == torch.float32
        close(tl, want[i], want32 and want32[i])
    for i, (got, w) in enumerate(zip(ttree.leaves(tc), jax.tree.leaves(jc))):
        assert got.dtype == torch.float32 and w.dtype == jnp.float32
        close(got, w, jc32 and jax.tree.leaves(jc32)[i])


@pytest.mark.parametrize("name,t", [
    ("gemma3-12b", 12),               # past the window of 8: the ring wraps
    ("jamba-1.5-large-398b", 16),     # two SSM chunks of 8, MoE
    ("xlstm-350m", 16),               # two mLSTM chunks of 8
    ("deepseek-v2-lite-16b", 8),      # MLA's absorbed decode, MoE
])
def test_decode_matches_parallel_forward(name, t):
    """The last position's logits of ``t`` decode steps against
    ``lm_hidden`` → head over the same tokens (the reference's test)."""
    tcfg = _no_drops(T_SMOKE[name])
    _, tp = _both_params(_no_drops(J_SMOKE[name]))
    b = 2
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (b, t)).astype(np.int32))
    h, _ = ttr.lm_hidden(tp, toks, tcfg)
    want = h[:, -1] @ ttr.lm_head_weight(tp, tcfg)
    caches = ttr.init_caches(tcfg, b, t, torch.float32, device="cpu")
    head = ttr.decode_head(tp, tcfg)
    for i in range(t):
        logits, caches = ttr.decode_step(tp, toks[:, i], caches, i, tcfg,
                                         head=head)
    tol = 5e-3 if tcfg.moe is not None else 2e-3
    np.testing.assert_allclose(logits.numpy(), want.detach().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["gemma3-12b", "xlstm-350m",
                                  "seamless-m4t-medium", "internvl2-1b"])
def test_prefill_step_matches_reference(name):
    jcfg, tcfg = J_SMOKE[name], T_SMOKE[name]
    pn, tp = _both_params(jcfg)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 17))
             .astype(np.int32)}
    if jcfg.enc_dec or jcfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal(
            (2, 8, jcfg.frontend_dim)).astype(np.float32)
    want = jax.jit(jsteps.make_prefill_step(jcfg))(
        pn, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.make_prefill_step(tcfg)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, jcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)


def _serve(engine_mod, cfg, params, prompts, max_tokens, **kw):
    eng = _submitted(engine_mod, engine_mod.ServeEngine(cfg, params, **kw),
                     prompts, max_tokens)
    return eng.run(), eng.index


@pytest.mark.parametrize("name,dtype", [
    (n, "float32") for n in ("smollm-360m", "gemma3-12b",
                             "jamba-1.5-large-398b", "xlstm-350m")] + [
    (n, "bfloat16") for n in BF16_ARCHS])
def test_serve_engine_matches_reference_engine(name, dtype, monkeypatch):
    """Five requests of different lengths through two slots (refills mid
    run): the finished token lists equal the reference engine's, token
    for token, and so does the tick count.

    With bf16 params (both engines' caches at their f32 default) a greedy
    token is not well-posed: the reference's own bf16 engine picks other
    tokens than its f32 engine from the same values (gemma3, jamba).  So
    both engines follow the reference's bf16 token stream (the port's
    decode returns the reference's logits to its engine after recording
    its own), and each tick's fed tokens must be equal and the port's
    logits held by ``_bf16_close``."""
    jcfg, tcfg = J_SMOKE[name], T_SMOKE[name]
    pn, tp = _both_params(jcfg, dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (3, 5, 2, 4, 6)]
    max_tokens = [4, 2, 5, 3, 4]
    kw = dict(batch_slots=2, max_len=64)
    if dtype == "float32":
        want, jticks = _serve(jengine, jcfg, jax.tree.map(jnp.asarray, pn),
                              prompts, max_tokens, **kw)
        got, tticks = _serve(tengine, tcfg, tp, prompts, max_tokens, **kw)
        assert got == want and tticks == jticks
        assert sorted(got) == list(range(5))
        return
    ref16, ref32, port = [], [], []

    def reference(params, script=None):
        step = _per_op_rounding(jcfg)

        def forced(p, tok, c, i):
            logits, c = step(p, tok, c, i)
            tape = ref16 if script is None else ref32
            tape.append((np.asarray(tok), np.asarray(logits)))
            return (logits if script is None
                    else jnp.asarray(script[len(tape) - 1][1])), c
        eng = jengine.ServeEngine(jcfg, jax.tree.map(jnp.asarray, params),
                                  **kw)
        eng._step = forced
        return _submitted(jengine, eng, prompts, max_tokens).run()

    want = reference(pn)
    reference(jax.tree.map(lambda x: np.asarray(x, np.float32), pn), ref16)

    # a MoE router's top-k flips on bf16 rounding in either package (the
    # port's bf16 run flips 2-3 of jamba's choices on 3 of 24 ticks, and
    # its logits jump by up to 0.28): the port's bf16 decode replays the
    # routing of its f32 decode from the same values, which routes as the
    # reference's f32 decode does
    tp32 = ttr.params_from_jax(jax.tree.map(
        lambda x: np.asarray(x, np.float32), pn), device="cpu")
    caches32 = ttr.init_caches(tcfg, kw["batch_slots"], kw["max_len"],
                               device="cpu")
    head32 = ttr.decode_head(tp32, tcfg)

    def port_decode(params, tok, caches, index, cfg, **kw):
        routing = []
        prev = tmoe.set_routing_hook(
            lambda name, t: routing.append((name, t)) or t)
        ttr.decode_step(tp32, tok, caches32, index, cfg, head=head32)
        replay = iter(routing)
        tmoe.set_routing_hook(lambda name, t: next(replay)[1])
        try:
            logits, caches = ttr.decode_step(params, tok, caches, index,
                                             cfg, **kw)
        finally:
            tmoe.set_routing_hook(prev)
        port.append((tok.numpy(), logits.numpy()))
        return torch.from_numpy(ref16[len(port) - 1][1]), caches
    monkeypatch.setattr(tengine, "decode_step", port_decode)
    eng = tengine.ServeEngine(tcfg, tp, **kw)
    assert eng.caches["layers"]["b0"] and all(
        x.dtype == torch.float32 for x in ttree.leaves(eng.caches))
    assert _submitted(tengine, eng, prompts, max_tokens).run() == want
    assert len(port) == len(ref16) == len(ref32) and sorted(want) == \
        list(range(5))
    for (tf, tl), (jf, jl), (_, jl32) in zip(port, ref16, ref32):
        assert np.array_equal(tf, jf)
        _bf16_close(tl, jl, jl32)


def _submitted(engine_mod, eng, prompts, max_tokens):
    for rid, prompt in enumerate(prompts):
        eng.submit(engine_mod.GenRequest(rid, list(prompt),
                                         max_tokens=max_tokens[rid]))
    return eng


def test_serve_engine_stops_at_max_len():
    tcfg = T_SMOKE["smollm-360m"]
    tp = ttr.lm_init(0, tcfg, dtype=torch.float32, device="cpu")
    eng = tengine.ServeEngine(tcfg, tp, batch_slots=1, max_len=5)
    eng.submit(tengine.GenRequest(0, [1, 2], max_tokens=50))
    assert eng.run() == {} and eng.index == 5


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8/8 requests" in out and "on cpu" in out
    assert sum(line.startswith("req ") for line in out.splitlines()) == 8


def test_serve_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main([])
