"""The port's analytic cost model (``repro_torch.launch.flops``) against the
JAX package's: ``analytic_cost`` field for field and detail key for detail
key on every registry architecture and shape at three meshes, with and
without FSDP; ``_param_groups`` exactly; and the reference's calibration
tests rewritten for the port, with ``FlopCounterMode`` over the port's own
train and prefill steps on the CPU in place of XLA's cost analysis."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.kernels import stats as jstats
from repro.launch import flops as jflops
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs.base import ALL_SHAPES as T_SHAPES
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import stats as tstats
from repro_torch.launch import flops as tflops
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models.transformer import lm_init
from repro_torch.optim.optimizer import OptConfig, adamw_init

MESHES = ((16, 16), (32, 16), (256, 1))
RTOL = 1e-12

# Each package's ``analytic_cost`` draws the param tree on every call; the
# parity sweep calls it 24 times an architecture, so both see their own
# function's groups through a cache (the functions are compared uncached
# in test_param_groups_equal).
_J_GROUPS = functools.lru_cache(maxsize=None)(jflops._param_groups)
_T_GROUPS = functools.lru_cache(maxsize=None)(tflops._param_groups)


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def _close(got, want):
    return got == want or abs(got - want) <= RTOL * max(abs(got), abs(want))


@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_param_groups_equal(arch):
    assert tflops._param_groups(T_ARCHS[arch]) == \
        jflops._param_groups(J_ARCHS[arch])


@pytest.mark.parametrize("shape_i", range(len(J_SHAPES)),
                         ids=[s.name for s in J_SHAPES])
@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_analytic_cost_equal(arch, shape_i, monkeypatch):
    monkeypatch.setattr(jflops, "_param_groups", _J_GROUPS)
    monkeypatch.setattr(tflops, "_param_groups", _T_GROUPS)
    jcfg, tcfg = J_ARCHS[arch], T_ARCHS[arch]
    jshape, tshape = J_SHAPES[shape_i], T_SHAPES[shape_i]
    assert (tshape.name, tshape.seq_len, tshape.global_batch,
            tshape.kind) == (jshape.name, jshape.seq_len,
                             jshape.global_batch, jshape.kind)
    for dp_n, model_n in MESHES:
        for fsdp in (False, True):
            want = jflops.analytic_cost(jcfg, jshape, dp_n=dp_n,
                                        model_n=model_n, fsdp=fsdp)
            got = tflops.analytic_cost(tcfg, tshape, dp_n=dp_n,
                                       model_n=model_n, fsdp=fsdp)
            where = (arch, jshape.name, dp_n, model_n, fsdp)
            for field in ("flops_per_device", "hbm_bytes_per_device",
                          "coll_bytes_per_device"):
                assert _close(getattr(got, field), getattr(want, field)), \
                    (where, field)
            assert set(got.detail) == set(want.detail), where
            for k, v in want.detail.items():
                assert _close(got.detail[k], float(v)), (where, k)


def test_microbatches_and_remat_reach_the_cost(monkeypatch):
    monkeypatch.setattr(jflops, "_param_groups", _J_GROUPS)
    monkeypatch.setattr(tflops, "_param_groups", _T_GROUPS)
    for arch in ("grok-1-314b", "smollm-360m"):
        for remat in (False, True):
            jcfg = J_ARCHS[arch].with_(remat=remat)
            tcfg = T_ARCHS[arch].with_(remat=remat)
            want = jflops.analytic_cost(jcfg, J_SHAPES[0], dp_n=16,
                                        model_n=16, microbatches=8,
                                        fsdp=True)
            got = tflops.analytic_cost(tcfg, T_SHAPES[0], dp_n=16,
                                       model_n=16, microbatches=8,
                                       fsdp=True)
            assert got.detail == {k: float(v) for k, v in want.detail.items()}
            assert _close(got.hbm_bytes_per_device,
                          want.hbm_bytes_per_device)


# ---------------------------------------------------------------------------
# Calibration: the analytic model against the port's own executed matmuls
# ---------------------------------------------------------------------------

def _small_dense(**kw):
    base = dict(
        name="cal", family="dense", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, ffn_activation="silu_glu",
        tie_embeddings=True, remat=False, scan_unroll=64,
        q_chunk=32, kv_chunk=32, dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


def _tokens(b, t, vocab):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (b, t)).astype(np.int32))


def _counted_train(cfg, b, t):
    params = lm_init(0, cfg, device="cpu")
    step = make_train_step(cfg, OptConfig(), microbatches=1)
    batch = {"tokens": _tokens(b, t + 1, cfg.vocab_size)}
    with FlopCounterMode(display=False) as fc:
        step(params, adamw_init(params), batch)
    return fc.get_total_flops()


@pytest.mark.parametrize("schedule", ["rect", "tri"])
def test_train_flops_calibration_dense(schedule):
    cfg = _small_dense(attn_schedule=schedule)
    shape = ShapeConfig("cal", seq_len=128, global_batch=4, kind="train")
    counted = _counted_train(cfg, 4, 128)
    ana = tflops.analytic_cost(cfg, shape, dp_n=1, model_n=1).flops_per_device
    ratio = ana / counted
    assert 0.6 < ratio < 1.6, (ana, counted, ratio)


def test_prefill_flops_calibration_dense():
    cfg = _small_dense()
    shape = ShapeConfig("cal", seq_len=256, global_batch=2, kind="prefill")
    params = lm_init(0, cfg, device="cpu")
    batch = {"tokens": _tokens(2, 257, cfg.vocab_size)}
    with FlopCounterMode(display=False) as fc:
        make_prefill_step(cfg)(params, batch)
    ana = tflops.analytic_cost(cfg, shape, dp_n=1, model_n=1).flops_per_device
    assert 0.6 < ana / fc.get_total_flops() < 1.6, (ana, fc.get_total_flops())


def test_train_flops_calibration_moe():
    from repro_torch.models.moe import MoEConfig
    cfg = _small_dense(
        family="moe",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256,
                      activation="silu_glu"))
    shape = ShapeConfig("cal", seq_len=128, global_batch=4, kind="train")
    counted = _counted_train(cfg, 4, 128)
    ana = tflops.analytic_cost(cfg, shape, dp_n=1, model_n=1).flops_per_device
    assert 0.55 < ana / counted < 1.8, (ana, counted)


def test_remat_factor_visible():
    """remat=True must cost exactly one extra forward in the model."""
    shape = ShapeConfig("cal", seq_len=128, global_batch=4, kind="train")
    a_no = tflops.analytic_cost(_small_dense(remat=False), shape, dp_n=1,
                                model_n=1)
    a_yes = tflops.analytic_cost(_small_dense(remat=True), shape, dp_n=1,
                                 model_n=1)
    r = a_yes.detail["matmul_flops"] / a_no.detail["matmul_flops"]
    assert abs(r - 4.0 / 3.0) < 1e-6


def test_param_shapes_hold_no_data():
    shapes = tflops.param_shapes(T_ARCHS["grok-1-314b"])
    leaves = ttree.leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    assert math.isclose(sum(t.numel() for t in leaves) / 1e9, 316.489340928)
