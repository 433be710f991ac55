"""The port's collective accounting and roofline terms
(``repro_torch.launch.hlo_analysis``) against the JAX package's: roofline
arithmetic on the H100's peaks for each dtype, ``model_flops`` and
``active_param_count`` on every registry architecture and shape, and the
trace parser — on synthetic profiler events carrying the reference's
sample HLO shapes, and on a real two-rank gloo run, where its all-reduce
bytes equal ``collectives.wire_bytes()``."""
import functools
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import ARCHS as J_ARCHS
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.kernels import stats as jstats
from repro.launch import hlo_analysis as jha
from repro.models.transformer import lm_init as j_lm_init
from repro_torch import tree as ttree
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs.base import ALL_SHAPES as T_SHAPES
from repro_torch.kernels import stats as tstats
from repro_torch.launch import flops as tflops
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch.mesh import RankPool, init_mesh
from repro_torch.sharding import collectives as tcoll

# The reference's tests/test_hlo_analysis.py sample.
SAMPLE_HLO = """
  %ag.1 = bf16[256,1024]{1,0} all-gather(%p0), replica_groups={...}
  %ar.2 = f32[512]{0} all-reduce(%x), to_apply=%add
  %rs.3 = (f32[128,64]{1,0}, f32[128,64]{1,0}) reduce-scatter(%a, %b)
  %cp.4 = bf16[32,32]{1,0} collective-permute(%y)
  %a2a.5 = f32[16,16]{1,0} all-to-all(%z)
  %dot.6 = f32[1024,1024]{1,0} dot(%l, %r)
"""


class Event(NamedTuple):
    """What the parser reads of a profiler event (``trace_events``)."""
    name_: str
    shapes_: list
    dtypes_: list

    def name(self):
        return self.name_

    def shapes(self):
        return self.shapes_

    def dtypes(self):
        return self.dtypes_


# The same collectives as profiler events of a group of 2 (each backend
# event carries its inputs: an all-gather's piece, a reduce-scatter's
# whole), beside the dispatcher ops and a matmul that are not counted.
SAMPLE_EVENTS = [
    Event("c10d::_allgather_base_", [[256, 1024], [128, 1024]],
          ["c10::BFloat16", "c10::BFloat16"]),
    Event("nccl:_all_gather_base", [[128, 1024]], ["c10::BFloat16"]),
    Event("gloo:all_reduce", [[512]], ["float"]),
    Event("nccl:reduce_scatter", [[256, 64], [256, 64]], ["float", "float"]),
    Event("nccl:send", [[32, 32]], ["c10::BFloat16"]),
    Event("gloo:all_to_all", [[16, 16]], ["float"]),
    Event("aten::mm", [[1024, 1024], [1024, 1024]], ["float", "float"]),
    Event("gloo:barrier", [], []),
    Event("nccl:_all_gather_base", [], []),     # its device-side record
]


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


# ---------------------------------------------------------------------------
# Roofline arithmetic on the H100's peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tf32,peak", [
    ("bfloat16", None, 989e12), ("float16", None, 989e12),
    ("float32", False, 67e12), ("float32", True, 495e12)])
def test_roofline_terms_and_fractions(dtype, tf32, peak, monkeypatch):
    if tf32 is not None:
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    rl = tha.roofline_terms(hlo_flops=peak, hlo_bytes=3.35e12,
                            coll_bytes=225e9, model_flops=peak * 256 * 0.5,
                            dtype=dtype)
    assert rl.peak_flops == peak
    assert abs(rl.compute_s - 1.0) < 1e-9
    assert abs(rl.memory_s - 1.0) < 1e-9
    assert abs(rl.collective_s - 0.5) < 1e-9
    assert rl.dominant in ("compute", "memory")
    assert abs(rl.bound_s - 1.0) < 1e-9
    assert abs(rl.useful_flop_fraction(256) - 0.5) < 1e-9
    assert abs(rl.roofline_fraction(256) - 0.5) < 1e-9


def test_float32_peak_follows_allow_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert tha.peak_flops("float32") == 67e12
        torch.backends.cuda.matmul.allow_tf32 = True
        assert tha.peak_flops("float32") == 495e12
        assert tha.peak_flops("bfloat16") == 989e12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_model_flops_conventions():
    from repro_torch.configs.base import DECODE_32K, PREFILL_32K, TRAIN_4K
    n = 1e9
    cfg = T_ARCHS["smollm-360m"]
    assert tha.model_flops(cfg, TRAIN_4K, n) == 6 * n * 4096 * 256
    assert tha.model_flops(cfg, PREFILL_32K, n) == 2 * n * 32768 * 32
    assert tha.model_flops(cfg, DECODE_32K, n) == 2 * n * 128


# ---------------------------------------------------------------------------
# model_flops and active_param_count against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _active(arch):
    jshapes = jax.eval_shape(lambda: j_lm_init(jax.random.key(0),
                                               J_ARCHS[arch]))
    want = jha.active_param_count(jshapes, J_ARCHS[arch])
    got = tha.active_param_count(tflops.param_shapes(T_ARCHS[arch]),
                                 T_ARCHS[arch])
    return got, want


@pytest.mark.parametrize("shape_i", range(len(J_SHAPES)),
                         ids=[s.name for s in J_SHAPES])
@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_model_flops_and_active_params_equal(arch, shape_i):
    got_n, want_n = _active(arch)
    assert got_n == want_n
    assert tha.model_flops(T_ARCHS[arch], T_SHAPES[shape_i], got_n) == \
        jha.model_flops(J_ARCHS[arch], J_SHAPES[shape_i], want_n)


def test_active_param_count_scales_moe():
    shapes = tflops.param_shapes(T_ARCHS["grok-1-314b"])
    total = sum(np.prod(t.shape) for t in ttree.leaves(shapes))
    active = tha.active_param_count(shapes, T_ARCHS["grok-1-314b"])
    # grok: 8 experts top-2 → expert params scale 4×; experts dominate
    assert 0.15 * total < active < 0.45 * total


# ---------------------------------------------------------------------------
# The trace parser
# ---------------------------------------------------------------------------

def test_collective_bytes_of_sample_events_equal_the_reference():
    want = jha.collective_bytes(SAMPLE_HLO)
    got = tha.collective_bytes(SAMPLE_EVENTS, group_size=2)
    assert got == want
    assert got["count"] == 5


def _rank_profiled_collectives(n):
    """In a rank: a dense psum and a scalar psum through the port's
    collectives, and an all-gather, under the profiler with shapes."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    mesh = init_mesh((dist.get_world_size(),), ("data",), backend="gloo",
                     device="cpu")
    x = torch.arange(n, dtype=torch.float32) * (mesh.rank + 1)
    piece = torch.ones(3, 5, dtype=torch.bfloat16)
    gathered = [torch.empty_like(piece) for _ in range(mesh.size)]
    tcoll.reset_wire_bytes()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        summed = tcoll.dense_psum(x, "data", mesh=mesh)
        tcoll.psum_scalar(torch.tensor(2.0), "data", mesh=mesh)
        dist.all_gather(gathered, piece)
    return (tha.collective_bytes(tha.trace_events(prof),
                                 group_size=mesh.size),
            tcoll.wire_bytes(), summed.numpy())


def test_trace_bytes_equal_wire_bytes_on_two_gloo_ranks():
    with RankPool(2, backend="gloo", device="cpu") as pool:
        rows = pool.run(_rank_profiled_collectives, 1000)
    for got, wire, summed in rows:
        np.testing.assert_array_equal(summed, np.arange(1000) * 3.0)
        assert got["all-reduce"] == wire == 1000 * 4 + 4
        assert got["all-gather"] == 2 * 3 * 5 * 2
        assert got["count"] == 3
        assert got["total"] == got["all-reduce"] + got["all-gather"]
