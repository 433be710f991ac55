"""The port's kernel sanitizer (``repro_torch.analysis.kernel_sanitizer``)
against the JAX package's (``repro.analysis.kernel_sanitizer``), case for
case of ``tests/test_analysis.py``'s kernel cases: the clean sweep is
``[]`` in both packages, and each planted fault is caught under the same
code.

The reference plants its faults by handing its shadow executor a mutant
Pallas kernel body.  A CUDA kernel has no eager body to swap, so the port
plants the SAME fault through inputs instead, into its plain versions
driven by the emulation of the C launchers (on the card, into the kernels
themselves, ``chip_smoke.py`` phase 11):

  * a tile written twice (reference: a mutant that stores at every k
    step) — a queue with one entry duplicated;
  * an accumulator read before this tile wrote it (reference: a mutant
    that never zeroes it) — a split-K reduce of one split more than the
    GEMM wrote;
  * a queue store beyond the capacity (reference: a mutant without the
    clamp) — queue slots one short of the capacity;
  * a dead queue slot written (reference: a mutant that does not dump dead
    rows) — a tile count overstated past the bitmap;
  * a store outside the output (reference: a mutant storing past its
    block window) — an output allocated one tile short.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import kernel_sanitizer as jks
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro_torch.analysis import kernel_sanitizer as tks
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats


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
# The reference's mutant kernels (tests/test_analysis.py), and one more
# ---------------------------------------------------------------------------

def _ref_geometry():
    r = np.random.RandomState(0)
    g, m, k, n, b = 1, 8, 8, 8, 4
    a = r.randn(g, m, k).astype(np.float32)
    bb = r.randn(g, k, n).astype(np.float32)
    ones = np.ones((g, 2, 2), np.int32)
    return a, bb, ones, b


def _ref_double_write():
    def mut(out_m_ref, a_m_ref, b_m_ref, a_ref, b_ref, o_ref, acc_ref):
        from repro.kernels.masked_matmul import jnp, pl
        kk = pl.program_id(3)

        @pl.when(kk == 0)
        def _zero():
            acc_ref[...] = jnp.zeros_like(acc_ref)

        acc_ref[...] += jnp.dot(a_ref[0], b_ref[0],
                                preferred_element_type=jnp.float32)
        o_ref[0] = acc_ref[...].astype(o_ref.dtype)   # EVERY k, not last

    mut.__module__ = "repro.kernels.masked_matmul"
    a, bb, ones, b = _ref_geometry()
    return jks.run_predicated_grouped(a, bb, ones, ones, ones, bm=b, bk=b,
                                      bn=b, kernel_fn=mut)[0]


def _ref_stale_accumulator():
    def mut(out_m_ref, a_m_ref, b_m_ref, a_ref, b_ref, o_ref, acc_ref):
        from repro.kernels.masked_matmul import jnp, pl
        kk = pl.program_id(3)
        nk = pl.num_programs(3)
        acc_ref[...] += jnp.dot(a_ref[0], b_ref[0],
                                preferred_element_type=jnp.float32)

        @pl.when(kk == nk - 1)
        def _write():
            o_ref[0] = acc_ref[...].astype(o_ref.dtype)

    mut.__module__ = "repro.kernels.masked_matmul"
    a, bb, ones, b = _ref_geometry()
    return jks.run_predicated_grouped(a, bb, ones, ones, ones, bm=b, bk=b,
                                      bn=b, kernel_fn=mut)[0]


def _ref_store_oob():
    def mut(out_m_ref, a_m_ref, b_m_ref, a_ref, b_ref, o_ref, acc_ref):
        from repro.kernels.masked_matmul import jnp, pl
        kk = pl.program_id(3)
        nk = pl.num_programs(3)

        @pl.when(kk == 0)
        def _zero():
            acc_ref[...] = jnp.zeros_like(acc_ref)

        acc_ref[...] += jnp.dot(a_ref[0], b_ref[0],
                                preferred_element_type=jnp.float32)

        @pl.when(kk == nk - 1)
        def _write():
            o_ref[0] = acc_ref[...].astype(o_ref.dtype)
            o_ref[0, pl.dslice(4, 1), :] = jnp.zeros((1, 4), jnp.float32)

    mut.__module__ = "repro.kernels.masked_matmul"
    a, bb, ones, b = _ref_geometry()
    return jks.run_predicated_grouped(a, bb, ones, ones, ones, bm=b, bk=b,
                                      bn=b, kernel_fn=mut)[0]


def _queue_mutant(clamp: bool, dump_dead: bool):
    def mut(bm_ref, ii_ref, jj_ref, cnt_ref, carry_ref, *, cap, nj, lb):
        from repro.kernels.queue_builder import jax, jnp, pl
        b = pl.program_id(0)
        nb = pl.num_programs(0)

        @pl.when(b == 0)
        def _init():
            carry_ref[0] = 0
            ii_ref[...] = jnp.zeros_like(ii_ref)
            jj_ref[...] = jnp.zeros_like(jj_ref)

        flags = (bm_ref[...] != 0).astype(jnp.int32)[0]
        excl = jnp.cumsum(flags) - flags
        base = carry_ref[0]

        def _store(e, _):
            t = b * lb + e
            if dump_dead:
                slot = jnp.where(flags[e] != 0, base + excl[e], cap)
            else:
                slot = base + excl[e]
            if clamp:
                slot = jnp.minimum(slot, cap)
            ii_ref[pl.dslice(slot, 1), :] = jnp.full((1, 1), t // nj,
                                                     jnp.int32)
            jj_ref[pl.dslice(slot, 1), :] = jnp.full((1, 1), t % nj,
                                                     jnp.int32)
            return 0

        jax.lax.fori_loop(0, lb, _store, 0)
        carry_ref[0] = base + jnp.sum(flags)

        @pl.when(b == nb - 1)
        def _emit():
            cnt_ref[0, 0] = carry_ref[0]

    mut.__module__ = "repro.kernels.queue_builder"
    return mut


def _ref_queue_oob():
    return jks.run_queue_builder(
        np.ones((4, 4), np.int32), capacity=5, launch_block=4,
        kernel_fn=_queue_mutant(clamp=False, dump_dead=True))[0]


def _ref_dump_slot_leak():
    bmp = (np.arange(16).reshape(4, 4) % 2).astype(np.int32)
    return jks.run_queue_builder(
        bmp, capacity=16, launch_block=4,
        kernel_fn=_queue_mutant(clamp=True, dump_dead=False))[0]


# The port's plant (kernel_sanitizer.PLANTS), the reference's mutant, and
# the code both must report.
PLANTS = {
    "double_written_tile": ("duplicate_slot", _ref_double_write,
                            "DOUBLE_WRITE"),
    "stale_accumulator": ("extra_split", _ref_stale_accumulator,
                          "ACC_READ_BEFORE_WRITE"),
    "out_of_capacity_queue_write": ("queue_short", _ref_queue_oob,
                                    "QUEUE_WRITE_OOB"),
    "dump_slot_leak": ("tiles_overstated", _ref_dump_slot_leak,
                       "DUMP_SLOT_LEAK"),
    "store_out_of_window": ("short_output", _ref_store_oob, "STORE_OOB"),
}


@pytest.mark.parametrize("name", sorted(PLANTS))
def test_planted_kernel_faults(name):
    port_plant, ref_run, code = PLANTS[name]
    assert code in codes(ref_run())
    assert code in codes(tks.plant(port_plant, "cpu").violations)


def test_kernel_sweep_clean():
    assert jks.sanitize_all() == []
    assert tks.sanitize_all("cpu") == []


def test_sweep_launches_every_kernel():
    sw = tks.sweep("cpu")
    for name in ("relu_encode", "queue_builder", "compact_gemm",
                 "predicated_gemm", "splitk_reduce", "queue_member",
                 "emit_nan_fixup", "bitmap_scan", "masked_matmul_2d",
                 "compact_masked_matmul_2d"):
        assert sw.launches[name] > 0, name
    assert sw.bad_errors() == {}


def test_queue_overflow_quarantined():
    """The builder under overflow: the live slots keep the reference
    prefix and the count the true total; the GEMM's compact launch exits
    and its predicated fallback writes every live tile once."""
    ref_vs, (ii, jj, n_live) = jks.run_queue_builder(
        np.ones((4, 4), np.int32), capacity=5, launch_block=4)
    sw = tks.plant("capacity_below_live", "cpu")
    t_ii, t_jj, t_n = sw.queue
    assert ref_vs == [] and sw.violations == [] and sw.bad_errors() == {}
    assert n_live == t_n == 16
    assert list(ii) == list(t_ii) == [0, 0, 0, 0, 1]
    assert list(jj) == list(t_jj) == [0, 1, 2, 3, 0]


def test_real_kernels_produce_reference_values():
    """The sweep's predicated run is an executable spec in both packages:
    its output equals masked dense numpy."""
    r = np.random.RandomState(1)
    g, m, k, n, b = 2, 8, 8, 8, 4
    a = r.randn(g, m, k).astype(np.float32)
    bb = r.randn(g, k, n).astype(np.float32)
    om = (r.rand(g, 2, 2) > 0.4).astype(np.int32)
    ones = np.ones((g, 2, 2), np.int32)
    ref_vs, ref_out = jks.run_predicated_grouped(a, bb, om, ones, ones,
                                                 bm=b, bk=b, bn=b)
    sw = tks.Sweep()
    case = tks.GemmCase("values", g, m, k, n, (b, b, b), "predicated",
                        "predicated_gemm")
    out = tks.run_gemm(sw, tks.launchers("cpu"), case,
                       arrays=(a, bb, om, ones, ones, None))
    want = np.einsum("gmk,gkn->gmn", a, bb)
    mask = np.kron(om, np.ones((b, b))).astype(bool).reshape(g, m, n)
    assert ref_vs == [] and sw.violations == []
    assert np.allclose(ref_out, np.where(mask, want, 0.0), atol=1e-4)
    got = out.numpy().reshape(g, m, n)
    assert np.allclose(got[mask], want[mask], atol=1e-4)
    # Dead tiles stay poisoned: the kernel never stores there.
    assert (out.view(torch.int32).numpy().reshape(g, m, n)[~mask]
            == tks.POISON_WORD).all()


def test_guard_bands_and_poison():
    buf = tks.Guarded(10, "cpu", fill="poison")
    assert buf.guard_hits() == 0
    assert (buf.words == tks.POISON_WORD).all()
    buf.raw[tks.GUARD + 10] = 0                  # one word past the body
    buf.raw[tks.GUARD - 1] = 0                   # one word before it
    assert buf.guard_hits() == 2
    assert buf.ptr() % 16 == 0


def test_compute_sanitizer_status_without_a_toolkit():
    """Without nvcc the status says so; it never claims the tool ran."""
    status = tks.compute_sanitizer_status()
    assert status == "usable" or status.startswith(("missing", "unusable"))
