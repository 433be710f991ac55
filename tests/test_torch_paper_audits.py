"""The port's bitmap_op_audit and depthwise_audit against the reference's
(``benchmarks/kernel_audit.py``), on the CPU: the same rows (bitmap
computations per activation and gradient, GEMM launches, scan-free training
steps, exactness against dense autodiff, zero dense-conv fallbacks).

Neither reads captured traces.  The reference's audits take gradients
eagerly, which runs every interpret-mode Pallas kernel primitive by
primitive (minutes a table); here its ``jax.grad`` is compiled by
``jax.jit``, which traces the same function once, so it records the same
``kernels.stats`` counts.
"""
import os
import sys

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from benchmarks import kernel_audit as jaudit
from repro.kernels import stats as jstats
from repro_torch.benchmarks import kernel_audit as taudit
from repro_torch.benchmarks.common import Capture
from repro_torch.kernels import stats as tstats


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


class _CompiledGrad:
    """``jax`` with ``grad`` compiled by ``jax.jit``."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def grad(fn, *args, **kw):
        return jax.jit(jax.grad(fn, *args, **kw))


@pytest.mark.parametrize("name", ["bitmap_op_audit", "depthwise_audit"])
def test_audit_rows_match_reference(name, monkeypatch):
    monkeypatch.setattr(jaudit, "jax", _CompiledGrad())
    jrows, jderived = getattr(jaudit, name)()
    trows, tderived = getattr(taudit, name)(Capture(device="cpu"))
    assert trows == jrows
    assert tderived == jderived
