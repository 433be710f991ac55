"""The port's partition rules (``repro_torch.sharding.partition``), meshes
(``repro_torch.launch.mesh``) and sharding context against the JAX
package's: every spec of every architecture's params, optimizer state,
batches and decode caches equal entry for entry at both production meshes,
with and without FSDP.  The shapes come from ``jax.eval_shape`` of the
reference's initializers and reach the port as meta tensors.  The jit
partitioner's entry points place (``NamedSharding``); placing on ranks is
held in tests/test_torch_tp.py."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs.base import ALL_SHAPES
from repro.configs.registry import decode_input_specs, train_input_specs
from repro.launch.mesh import make_abstract_mesh as j_abstract
from repro.models.transformer import lm_init
from repro.optim.optimizer import adamw_init
from repro.sharding import partition as jpart
from repro_torch import tree as ttree
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import context as tctx
from repro_torch.sharding import partition as tpart

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return j_abstract(shape, axes), tmesh.make_abstract_mesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    return jax.eval_shape(lambda: lm_init(jax.random.key(0), ARCHS[arch]))


def _meta(tree):
    return jax.tree.map(
        lambda s: torch.empty(tuple(s.shape), device="meta"), tree)


def _j_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in flat]


def _t_specs(tree):
    return [(kp, tuple(s)) for kp, s in tpart.spec_leaves(tree)]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_opt_specs_match_reference(arch, mesh_name, fsdp):
    jmesh, tm = _meshes(mesh_name)
    shapes = _param_shapes(arch)
    meta = _meta(shapes)
    want = _j_specs(jpart.params_pspecs(shapes, jmesh, fsdp=fsdp))
    got = _t_specs(tpart.params_pspecs(meta, tm, fsdp=fsdp))
    assert got == want
    opt = jax.eval_shape(adamw_init, shapes)
    want = _j_specs(jpart.opt_state_pspecs(opt, shapes, jmesh, fsdp=fsdp))
    got = _t_specs(tpart.opt_state_pspecs(None, meta, tm, fsdp=fsdp))
    assert got == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_batch_specs_match_reference(arch):
    """Every decode shape's caches, the long-context one's sequence
    parallelism included, and every train/prefill batch."""
    cfg = ARCHS[arch]
    for mesh_name in MESHES:
        jmesh, tm = _meshes(mesh_name)
        for shape in ALL_SHAPES:
            if shape.kind == "decode":
                caches = decode_input_specs(cfg, shape)["caches"]
                want = _j_specs(jpart.cache_pspecs(caches, jmesh))
                got = _t_specs(tpart.cache_pspecs(_meta(caches), tm))
            else:
                batch = train_input_specs(cfg, shape)
                want = _j_specs(jpart.batch_pspecs(batch, jmesh))
                got = _t_specs(tpart.batch_pspecs(_meta(batch), tm))
            assert got == want, (mesh_name, shape.name)


def test_long_context_cache_uses_sequence_parallelism():
    """batch=1 long-context decode shards the KV sequence dim on data."""
    _, tm = _meshes("1pod")
    shape = [s for s in ALL_SHAPES if s.name == "long_500k"][0]
    caches = decode_input_specs(ARCHS["jamba-1.5-large-398b"],
                                shape)["caches"]
    meta = _meta(caches)
    specs = dict(tpart.spec_leaves(tpart.cache_pspecs(meta, tm)))
    found = [kp for kp, leaf in ttree.leaves_with_paths(meta)
             if "'k'" in kp and leaf.ndim == 5 and specs[kp][2] is not None]
    assert found


def test_activation_rules_and_axes_match_reference():
    for name in MESHES:
        jmesh, tm = _meshes(name)
        assert {k: tuple(v) for k, v in tpart.activation_rules(tm).items()} \
            == {k: tuple(v) for k, v in jpart.activation_rules(jmesh).items()}
        assert tpart.dp_axis_names(tm) == jpart.dp_axis_names(jmesh)
        for axes in (("data",), ("model",), ("pod", "data"), "model"):
            if all(a in tm.axis_names for a in
                   ((axes,) if isinstance(axes, str) else axes)):
                assert tpart.axis_size(tm, axes) == \
                    jpart.axis_size(jmesh, axes)
    for multi in (False, True):
        prod = tmesh.make_production_mesh(multi_pod=multi)
        shape, axes = MESHES["2pod" if multi else "1pod"]
        assert prod.axis_names == axes
        assert tuple(prod.shape.values()) == shape
    assert tpart.normalize_path("['layers']['b0']['attn']['wq']") == \
        jpart.normalize_path("['layers']['b0']['attn']['wq']")
    assert tpart.normalize_path("['prefix'][0]['w']") == \
        jpart.normalize_path("['prefix'][0]['w']")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_bitmap_pspec_alignment_rules(n):
    """A bitmap dim mirrors its data dim's mesh axes only when every shard
    holds a whole number of granularity cells."""
    jmesh = j_abstract((n,), ("data",))
    tm = tmesh.make_abstract_mesh((n,), ("data",))
    gran = (8, 8)
    cases = [((8 * 8 * n, 32), ("data", None)),
             ((8 * 8 * n, 32), (None, None)),
             ((8 * (n + 1), 32), ("data", None)),
             ((64, 8 * n), (None, "data")),
             ((64, 8 * n + 4), (None, "data"))]
    for shape, spec in cases:
        want = jpart.bitmap_pspec(shape, JP(*spec), gran, jmesh)
        got = tpart.bitmap_pspec(shape, tpart.P(*spec), gran, tm)
        assert tuple(got) == tuple(want), (shape, spec)
    assert tpart.bitmap_pspec((8 * 8 * n, 32), tpart.P("data", None), gran,
                              tm) == tpart.P("data", None)
    if n > 1:
        assert tpart.bitmap_pspec((8 * (n + 1), 32), tpart.P("data", None),
                                  gran, tm) == tpart.P(None, None)


def test_sparse_tensor_pspecs():
    from repro_torch.core.sparse_tensor import SparseTensor
    tm = tmesh.make_abstract_mesh((4,), ("data",))
    st = SparseTensor(torch.zeros(16, 4, dtype=torch.int32), (8, 8))
    assert tpart.sparse_tensor_pspecs(st, tpart.P("data", None), (128, 32),
                                      tm) == (tpart.P("data", None),
                                              tpart.P("data", None))
    assert tpart.sparse_tensor_pspecs(SparseTensor(None, None),
                                      tpart.P("data", None), (128, 32),
                                      tm) == (tpart.P("data", None), None)


def test_partitioner_entry_points_raise_a18b():
    """The jit partitioner's entry points (ROADMAP A18b, once raising)
    now place: ``params_shardings``/``to_shardings`` give
    ``NamedSharding``s with the spec's DTensor placements, and
    ``constraint`` under rules refuses a plain tensor it would shard when
    no mesh sizes the rule."""
    from torch.distributed.tensor import Replicate, Shard
    tm = tmesh.make_abstract_mesh((2, 2), ("data", "model"))
    meta = {"w": torch.empty(4, 4, device="meta")}
    sh = tpart.params_shardings(meta, tm)["w"]
    assert isinstance(sh, tpart.NamedSharding)
    assert sh.placements == (Replicate(), Replicate())   # "w" replicates
    got = tpart.to_shardings({"w": tpart.P("data", "model"),
                              "b": [tpart.P()]}, tm)
    assert got["w"].placements == (Shard(0), Shard(1))
    assert got["w"].local_shape((4, 6)) == (2, 3)
    assert got["b"][0].placements == (Replicate(), Replicate())
    x = torch.ones(2)
    assert tctx.constraint(x, "act_btd") is x
    rules = tpart.activation_rules(tm)
    with tctx.sharding_rules(rules):
        assert tctx.current_rules() is rules
        assert tctx.constraint(x, "not_a_rule") is x
        with pytest.raises(TypeError, match="act_btd"):
            tctx.constraint(x, "act_btd")
    assert tctx.current_rules() is None


def test_mesh_coordinates_and_groups_without_a_process_group():
    """Row-major coordinates, the linear index over data axes as
    ``P(("pod", "data"))`` splits a batch, and the world of one."""
    m = tmesh.Mesh((2, 3), ("pod", "data"), rank=4)
    assert m.coords == {"pod": 1, "data": 1}
    assert m.axis_index(("pod", "data")) == 4
    assert m.axis_index("data") == 1
    one = tmesh.init_mesh((1,), ("data",), backend=None, device="cpu")
    assert one.group("data") is None and one.size == 1
    with pytest.raises(ValueError):
        tmesh.init_mesh((2,), ("data",), backend=None, device="cpu")
    with pytest.raises(ValueError):
        tmesh.make_abstract_mesh((2,), ("data",)).group("data")
    np.testing.assert_array_equal(
        [tmesh.Mesh((2, 2), ("pod", "data"), rank=r).axis_index(
            ("pod", "data")) for r in range(4)], np.arange(4))
