"""The port's bitmap-aware collectives (``repro_torch.sharding.collectives``)
against the JAX package's, case for case of
``tests/test_sparse_collectives.py``.

Each case runs twice:
  * on a world of one rank (a mesh with no process group, every reduce the
    identity) against the reference's one-device ``shard_map`` on the same
    numpy inputs: equal outputs and EQUAL count dicts;
  * on a pool of 4 gloo ranks on the CPU, spawned once for the module,
    against the numpy sum of the ranks' inputs and the reference's count
    rules across shards: each rank's trace-time keys
    (``collective:bitmap_psum``, ``collective:dense``) equal the one trace's,
    and the runtime keys (``collective:compressed``,
    ``collective:dense_fallback``) summed over the ranks equal the
    reference's per-shard total.
The functions a rank runs are module-level, so that the spawned ranks
import them; their inputs and results are numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

from repro.core import policy as jpol
from repro.core.sparse_linear import _act_matmul_fwd, act_matmul as j_act
from repro.core.sparse_tensor import lookup_grad_bitmap as j_lookup
from repro.kernels import stats as jstats
from repro.runtime import faults as jfaults
from repro.sharding import collectives as jcoll
from repro_torch.core import policy as tpol
from repro_torch.core import sparse_linear as tsl
from repro_torch.core.sparse_tensor import lookup_grad_bitmap as t_lookup
from repro_torch.kernels import stats as tstats
from repro_torch.launch.mesh import RankPool, init_mesh
from repro_torch.runtime import faults as tfaults
from repro_torch.sharding import collectives as tcoll

N_RANKS = 4
J_PALLAS = jpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 16, 8))
T_PALLAS = tpol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 16, 8))


@pytest.fixture(autouse=True)
def _reset_both():
    jstats.reset()
    tstats.reset()
    yield
    jfaults.disarm()
    tfaults.disarm()
    jstats.reset()
    tstats.reset()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N_RANKS, backend="gloo", device="cpu")
    yield p
    p.close()


def _correlated_stack(n_dev, m, n, gran, live, seed=0):
    """The reference test's data: the SAME block pattern on every shard."""
    g0, g1 = gran
    mb, nb = -(-m // g0), -(-n // g1)
    rng = np.random.default_rng(seed)
    count = max(1, min(mb * nb, round(live * mb * nb)))
    bm = np.zeros(mb * nb, np.int32)
    bm[rng.permutation(mb * nb)[:count]] = 1
    bm = bm.reshape(mb, nb)
    expand = np.repeat(np.repeat(bm, g0, 0), g1, 1)[:m, :n]
    data = rng.standard_normal((n_dev, m, n)).astype(np.float32) \
        * expand[None].astype(np.float32)
    bits = np.broadcast_to(bm, (n_dev, mb, nb)).copy()
    return data, bits


def _uncorrelated_stack(n_dev, seed=9):
    rng = np.random.default_rng(seed)
    data = np.zeros((n_dev, 32, 32), np.float32)
    bits = np.zeros((n_dev, 8, 8), np.int32)
    for s in range(n_dev):
        bm = (rng.random((8, 8)) < 0.3).astype(np.int32)
        bm[0, 0] = 1
        bits[s] = bm
        data[s] = rng.standard_normal((32, 32)).astype(np.float32) \
            * np.repeat(np.repeat(bm, 4, 0), 4, 1)
    return data, bits


def _j_reduce(data, bits, gran, cutoff):
    """The reference's ``sparse_psum`` on its one-device mesh."""
    mesh = jax.make_mesh((1,), ("data",))

    def body(x, b):
        return jcoll.sparse_psum(x[0], b[0], gran, axis_name=("data",),
                                 cutoff=cutoff, return_bits=True)

    out, union = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP("data"), JP("data")),
        out_specs=(JP(), JP()), check_rep=False))(
            jnp.asarray(data), jnp.asarray(bits))
    return np.asarray(out), np.asarray(union)


def _world_mesh():
    """Inside a rank: the mesh over the pool's world; on the test's own
    process: the world of one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return init_mesh((dist.get_world_size(),), ("data",),
                         backend="gloo", device="cpu")
    return init_mesh((1,), ("data",), backend=None, device="cpu")


def _rank_sparse_psum(data, bits, gran, cutoff):
    mesh = _world_mesh()
    tstats.reset()
    r = mesh.rank
    out, union = tcoll.sparse_psum(
        torch.from_numpy(data[r]), torch.from_numpy(bits[r]), gran,
        mesh=mesh, axis_name=("data",), cutoff=cutoff, return_bits=True)
    return out.numpy(), union.numpy(), tstats.counts()


def _summed(rows, key):
    return sum(c.get(key, 0) for _, _, c in rows)


# ---------------------------------------------------------------------------
# sparse_psum == dense all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("live", [0.25, 1.0])
def test_sparse_psum_matches_dense_allreduce(live, pool):
    gran = (4, 4)
    data, bits = _correlated_stack(1, 32, 32, gran, live, seed=3)
    jout, junion = _j_reduce(data, bits, gran, 0.5)
    want_counts = jstats.counts()
    tout, tunion, tcounts = _rank_sparse_psum(data, bits, gran, 0.5)
    np.testing.assert_allclose(tout, data.sum(0), atol=1e-5)
    np.testing.assert_allclose(tout, jout, atol=1e-6)
    np.testing.assert_array_equal(tunion, junion)
    assert tcounts == want_counts

    data, bits = _correlated_stack(N_RANKS, 32, 32, gran, live, seed=3)
    rows = pool.run(_rank_sparse_psum, data, bits, gran, 0.5)
    for out, union, c in rows:
        np.testing.assert_allclose(out, data.sum(0), atol=1e-5)
        assert c.get("collective:bitmap_psum") == 1, c
    if live <= 0.5:
        assert _summed(rows, "collective:compressed") == N_RANKS
        assert _summed(rows, "collective:dense_fallback") == 0
        for _, union, _ in rows:
            np.testing.assert_array_equal((union > 0).astype(np.int32),
                                          bits[0])
    else:
        assert _summed(rows, "collective:dense_fallback") == N_RANKS
        assert _summed(rows, "collective:compressed") == 0


def test_sparse_psum_cutoff_admitting_all_blocks_is_dense(pool):
    gran = (4, 4)
    data, bits = _correlated_stack(1, 8, 8, gran, 0.5, seed=4)
    jout, _ = _j_reduce(data, bits, gran, 1.0)
    want_counts = jstats.counts()
    tout, _, tcounts = _rank_sparse_psum(data, bits, gran, 1.0)
    np.testing.assert_allclose(tout, jout, atol=1e-6)
    assert tcounts == want_counts
    assert tcounts.get("collective:dense", 0) == 1

    data, bits = _correlated_stack(N_RANKS, 8, 8, gran, 0.5, seed=4)
    for out, _, c in pool.run(_rank_sparse_psum, data, bits, gran, 1.0):
        np.testing.assert_allclose(out, data.sum(0), atol=1e-5)
        assert c.get("collective:dense") == 1, c
        assert c.get("collective:compressed", 0) == 0, c


def _rank_dense_psum(x):
    mesh = _world_mesh()
    tstats.reset()
    out = tcoll.dense_psum(torch.from_numpy(x[mesh.rank]), "data",
                           mesh=mesh)
    return out.numpy(), tstats.counts()


def test_dense_psum_records_collective_key(pool):
    x = np.ones((1, 4, 4), np.float32)
    fn = jax.jit(shard_map(lambda v: jcoll.dense_psum(v[0], "data"),
                           mesh=jax.make_mesh((1,), ("data",)),
                           in_specs=(JP("data"),), out_specs=JP(),
                           check_rep=False))
    jax.block_until_ready(fn(jnp.asarray(x)))
    out, c = _rank_dense_psum(x)
    assert c == jstats.counts() == {"collective:dense": 1}
    np.testing.assert_array_equal(out, x[0])

    x = np.random.default_rng(1).standard_normal((N_RANKS, 4, 4)) \
        .astype(np.float32)
    for out, c in pool.run(_rank_dense_psum, x):
        np.testing.assert_allclose(out, x.sum(0), atol=1e-6)
        assert c == {"collective:dense": 1}


# ---------------------------------------------------------------------------
# psum_grads routing by the registry (the WG hand-off the collective uses)
# ---------------------------------------------------------------------------

def _grad_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16)).astype(np.float32)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    return x, w, np.zeros((16,), np.float32)


def _rank_psum_grads(x, w, b):
    mesh = _world_mesh()
    tstats.reset()
    xt = torch.from_numpy(x)
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (w, b)]
    loss = ((tsl.act_matmul(xt, leaves[0], T_PALLAS, "relu") + leaves[1])
            ** 2).sum()
    gw, gb = torch.autograd.grad(loss, leaves)
    misses = tstats.counts().get("registry:miss", 0)
    out = tcoll.psum_grads({"w": gw, "b": gb}, mesh=mesh,
                           axis_name=("data",), cutoff=0.5)
    c = tstats.counts()
    return ({k: v.detach().numpy() for k, v in out.items()}, c,
            c.get("registry:miss", 0) - misses)


def test_psum_grads_routes_by_registry(pool):
    """The dW leaf (its WG bitmap registered by the backward pass, found
    by identity on the tensor autograd returned) takes the compressed
    reduce, the bias the dense one; the registry consult is a peek."""
    x, w, b = _grad_inputs()

    def body(p):
        def loss(q):
            return ((j_act(jnp.asarray(x), q["w"], J_PALLAS, "relu")
                     + q["b"]) ** 2).sum()
        return jcoll.psum_grads(jax.grad(loss)(p), axis_name=("data",),
                                cutoff=0.5)

    jout = jax.jit(shard_map(body, mesh=jax.make_mesh((1,), ("data",)),
                             in_specs=(JP(),), out_specs=JP(),
                             check_rep=False))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    jc = jstats.counts()
    tout, tc, added_misses = _rank_psum_grads(x, w, b)
    assert tc.get("collective:bitmap_psum") == 1 == \
        jc.get("collective:bitmap_psum"), (tc, jc)
    assert tc.get("collective:dense") == 1 == jc.get("collective:dense")
    assert {k: v for k, v in tc.items() if k.startswith("collective:")} \
        == {k: v for k, v in jc.items() if k.startswith("collective:")}
    assert added_misses == 0
    for k in ("w", "b"):
        np.testing.assert_allclose(tout[k], np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-4)

    rows = pool.run(_rank_psum_grads, x, w, b)
    for out, c, added in rows:
        assert c.get("collective:bitmap_psum") == 1
        assert c.get("collective:dense") == 1
        assert added == 0
        for k in ("w", "b"):
            np.testing.assert_allclose(out[k], N_RANKS * tout[k],
                                       rtol=1e-5, atol=1e-4)
    assert sum(c.get("collective:compressed", 0)
               + c.get("collective:dense_fallback", 0)
               for _, c, _ in rows) == N_RANKS


def test_wg_bitmap_registered_for_linear_grads():
    """dW of act_matmul carries a registered WG bitmap on the very tensor
    autograd returns, equal to the reference's, and conservative: a dead
    bit means that block of dW is exactly zero."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((32, 16)) * (rng.random((32, 16)) > 0.6)
         ).astype(np.float32)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    def jgrad(w_):
        # the registry matches by identity, so it is read inside the trace
        dw = jax.grad(lambda v: (j_act(jnp.asarray(x), v, J_PALLAS, "relu")
                                 ** 2).sum())(w_)
        return dw, j_lookup(dw, peek=True)[0]

    jdw, jbits = jax.jit(jgrad)(jnp.asarray(w))
    jgran = (J_PALLAS.block[0], J_PALLAS.block[2])    # dW's (bm, bn)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = (tsl.act_matmul(torch.from_numpy(x), wt, T_PALLAS, "relu")
            ** 2).sum()
    (dw,) = torch.autograd.grad(loss, [wt])
    hit = t_lookup(dw, peek=True)
    assert hit is not None
    bitmap, gran = hit
    assert tuple(gran) == tuple(jgran)
    np.testing.assert_array_equal(bitmap.numpy(), np.asarray(jbits))
    g0, g1 = gran
    bnp, dnp = bitmap.numpy(), dw.numpy()
    for i in range(bnp.shape[0]):
        for j in range(bnp.shape[1]):
            if bnp[i, j] == 0:
                assert not dnp[i * g0:(i + 1) * g0,
                               j * g1:(j + 1) * g1].any(), (i, j)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-4)


def test_shard_bitmap_is_row_slice_of_global_bitmap():
    """Encoding a row shard of the batch gives exactly the matching row
    slice of the global forward bitmap (shard boundaries on cell
    boundaries), in the port as in the reference."""
    from repro_torch.core.sparse_tensor import linear_act_granularity
    n_shards, m, k = 8, 64, 16
    rng = np.random.default_rng(6)
    x_pre = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, 8)).astype(np.float32)
    _, (st_j, _) = _act_matmul_fwd(jnp.asarray(x_pre), jnp.asarray(w),
                                   J_PALLAS, "relu")
    gran = linear_act_granularity(T_PALLAS.block)
    assert tuple(gran) == tuple(st_j.gran)
    _, glob = tsl._encode_act(torch.from_numpy(x_pre), T_PALLAS, gran)
    np.testing.assert_array_equal(glob.numpy(), np.asarray(st_j.bitmap))
    rows = m // n_shards
    assert rows % gran[0] == 0
    for s in range(n_shards):
        _, bits = tsl._encode_act(
            torch.from_numpy(x_pre[s * rows:(s + 1) * rows]), T_PALLAS, gran)
        np.testing.assert_array_equal(
            bits.numpy(),
            glob.numpy()[s * rows // gran[0]:(s + 1) * rows // gran[0]])


def test_sparse_psum_uncorrelated_masks_fall_back(pool):
    """Uncorrelated per-rank masks union to near dense: every rank takes
    the dense fallback (4 × 30 % uncorrelated ≈ 76 % live > the 50 %
    cutoff), and the result is still exact.  On a world of one the single
    mask stays under the cutoff: compressed, as in the reference."""
    gran = (4, 4)
    data, bits = _uncorrelated_stack(N_RANKS)
    rows = pool.run(_rank_sparse_psum, data, bits, gran, 0.5)
    for out, union, c in rows:
        np.testing.assert_allclose(out, data.sum(0), atol=1e-5)
        assert (union > 0).mean() > 0.5
    assert _summed(rows, "collective:dense_fallback") == N_RANKS
    assert _summed(rows, "collective:compressed") == 0

    jout, _ = _j_reduce(data[:1], bits[:1], gran, 0.5)
    want = jstats.counts()
    tout, _, tc = _rank_sparse_psum(data[:1], bits[:1], gran, 0.5)
    np.testing.assert_allclose(tout, jout, atol=1e-6)
    assert tc == want and tc.get("collective:compressed") == 1


# ---------------------------------------------------------------------------
# Fault containment (the chaos-matrix case, run inline)
# ---------------------------------------------------------------------------

def _rank_collective_drop():
    row = tfaults._case_collective_drop()
    return row.detected, row.survived, row.detail


def _rank_clean_probe(data, bits, gran):
    """The probe on a clean reduce passes (the fault, not the probe's use
    of the union, is what it detects)."""
    from repro_torch.runtime.guards import StepGuard
    out, union, _ = _rank_sparse_psum(data, bits, gran, 0.5)
    ok, _ = StepGuard().probe_emit(out, (union > 0).astype(np.int32), gran)
    return ok


def test_collective_drop_fault_detected_and_survived(pool):
    jrow = jfaults._case_collective_drop()
    trow = tfaults._case_collective_drop()
    assert jrow.ok and trow.ok, (jrow.detail, trow.detail)
    assert (trow.fault, trow.site, trow.kind, trow.guard_key) == \
        (jrow.fault, jrow.site, jrow.kind, jrow.guard_key)
    for detected, survived, detail in pool.run(_rank_collective_drop):
        assert detected and survived, detail
        assert f"ranks={N_RANKS}" in detail
    data, bits = _correlated_stack(N_RANKS, 16, 16, (4, 4), 0.25, seed=3)
    assert all(pool.run(_rank_clean_probe, data, bits, (4, 4)))
