"""The port's checkpointing: every case of ``tests/test_checkpoint.py`` run
on ``repro_torch.checkpoint``, and the on-disk format across the packages
(a reference save restores in the port and a port save in the reference,
leaves equal, ``state.json`` included)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro.kernels import autotune as jautotune
from repro.kernels import stats as jstats
from repro_torch import checkpoint as ckpt
from repro_torch import tree as ttree
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import autotune as tautotune
from repro_torch.kernels import stats as tstats
from repro_torch.launch.train import StragglerDetector, train_loop
from repro_torch.runtime import faults


@pytest.fixture(autouse=True)
def _reset_both():
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()
    yield
    faults.disarm()
    for s in (jstats, tstats):
        s.reset()
    jautotune.reset()
    tautotune.reset()


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def _equal(t1, t2):
    l1, l2 = ttree.leaves(t1), ttree.leaves(t2)
    assert len(l1) == len(l2)
    for a, b in zip(l1, l2):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    step, back = ckpt.restore(str(tmp_path), t)
    assert step == 7
    _equal(t, back)


def test_keep_last_k_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [4, 5]


def test_crashed_tmp_dirs_are_invisible_and_cleaned(tmp_path):
    t = _tree()
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 1, t)
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros((3, 3))})
    with pytest.raises(ckpt.CheckpointError) as ei:
        ckpt.restore(str(tmp_path), {"w": torch.zeros((4, 4))}, step=1)
    assert ei.value.step == 1
    assert ei.value.leaf == "leaf_00000"


def test_crash_mid_save_restores_previous_and_prunes(tmp_path):
    t2, t4 = _tree(2), _tree(4)
    ckpt.save(str(tmp_path), 2, t2)
    ckpt.save(str(tmp_path), 4, t4)
    os.makedirs(tmp_path / "step_00000006.tmp")     # crashed writer
    with open(tmp_path / "step_00000004" / "leaves.npz", "r+b") as f:
        f.truncate(10)                              # torn newest payload
    step, back = ckpt.restore(str(tmp_path), t2)
    assert step == 2
    _equal(t2, back)
    assert tstats.guard_counts().get("guard:ckpt_fallback", 0) >= 1
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert any(d.endswith(".corrupt") for d in os.listdir(tmp_path))
    ckpt.save(str(tmp_path), 6, t4)                 # next save prunes
    left = os.listdir(tmp_path)
    assert not any(d.endswith((".tmp", ".old", ".corrupt")) for d in left)


def test_unreadable_npz_is_typed_not_raw(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree())
    with open(tmp_path / "step_00000003" / "leaves.npz", "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(ckpt.CheckpointCorruptError) as ei:
        ckpt.restore(str(tmp_path), _tree(), step=3)
    assert ei.value.step == 3
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(str(tmp_path), _tree())


def test_same_step_rewrite_never_destroys_previous(tmp_path):
    t = _tree(1)
    ckpt.save(str(tmp_path), 5, t)
    faults.arm(faults.Fault("checkpoint:pre_commit", "crash"))
    try:
        with pytest.raises(faults.InjectedCrash):
            ckpt.save(str(tmp_path), 5, _tree(9))
    finally:
        faults.disarm()
    step, back = ckpt.restore(str(tmp_path), t)
    assert step == 5
    _equal(t, back)


def test_state_json_roundtrip(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree(), extra={"autotune": {"x": 1}})
    assert ckpt.load_state(str(tmp_path)) == {"autotune": {"x": 1}}
    assert ckpt.load_state(str(tmp_path), 2) == {"autotune": {"x": 1}}
    ckpt.save(str(tmp_path), 4, _tree())          # no extra
    assert ckpt.load_state(str(tmp_path)) is None
    assert ckpt.load_state(str(tmp_path), 2) == {"autotune": {"x": 1}}


def test_train_resume_bit_identical(tmp_path):
    # remat=False: the loop's resume, which the recomputation leaves as it
    # is (tests/test_torch_remat.py), without its time
    cfg = SMOKE_ARCHS["smollm-360m"].with_(remat=False)
    tcfg = TrainConfig(total_steps=6, checkpoint_every=3, learning_rate=1e-3,
                       seed=3)
    kw = dict(batch_size=4, seq_len=16, log_every=0, device="cpu")
    full = train_loop(cfg, tcfg, steps=6, ckpt_dir=None, **kw)
    d = str(tmp_path / "ck")
    train_loop(cfg, tcfg, steps=3, ckpt_dir=d, **kw)
    resumed = train_loop(cfg, tcfg, steps=6, ckpt_dir=d, resume=True, **kw)
    assert resumed["resumed_from"] == 3
    np.testing.assert_allclose(full["losses"][3:], resumed["losses"],
                               rtol=1e-5, atol=1e-6)


def test_straggler_detector_flags_outliers():
    det = StragglerDetector(window=16, threshold=2.0)
    for i in range(20):
        det.observe(i, 0.1)
    assert det.observe(20, 0.5)          # 5× median
    assert not det.observe(21, 0.12)
    assert len(det.flags) == 1


# ---------------------------------------------------------------------------
# The format across the packages
# ---------------------------------------------------------------------------

def _jax_tree():
    k = jax.random.key(5)
    return {"params": {"w": jax.random.normal(k, (3, 4)),
                       "layers": {"b0": {"s": jnp.ones((2, 4))}}},
            "opt": {"step": jnp.int32(7),
                    "mu": [jnp.arange(5, dtype=jnp.float32),
                           jnp.zeros((2,), jnp.float32)]}}


def _as_torch(tree):
    return ttree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def test_reference_save_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    extra = {"step": 7, "autotune": jautotune.export_state()}
    jckpt.save(str(tmp_path), 7, jt, extra=extra)
    tmpl = ttree.tree_map(torch.zeros_like, _as_torch(jt))
    step, back = ckpt.restore(str(tmp_path), tmpl)
    assert step == 7
    _equal(back, _as_torch(jt))
    assert ckpt.load_state(str(tmp_path)) == extra


def test_port_save_restores_in_the_reference(tmp_path):
    jt = _jax_tree()
    tt = _as_torch(jt)
    extra = {"step": 3, "autotune": tautotune.export_state()}
    ckpt.save(str(tmp_path), 3, tt, extra=extra)
    tmpl = jax.tree.map(jnp.zeros_like, jt)
    step, back = jckpt.restore(str(tmp_path), tmpl)
    assert step == 3
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jckpt.load_state(str(tmp_path)) == extra
    # treedef.json carries the reference's paths and structure string
    import json
    with open(tmp_path / "step_00000003" / "treedef.json") as f:
        doc = json.load(f)
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert doc["paths"] == want
    assert doc["treedef"] == str(jax.tree_util.tree_structure(jt))


def _lm_state(pkg, name):
    """The smoke config's params and AdamW state from either package: the
    reference's drawn from its key, the port's from its seed."""
    if pkg == "jax":
        from repro.configs import SMOKE_ARCHS as J_SMOKE
        from repro.models.transformer import lm_init
        from repro.optim.optimizer import adamw_init
        p = lm_init(jax.random.key(3), J_SMOKE[name], dtype=jnp.float32)
        return {"params": p, "opt": adamw_init(p)}
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim.optimizer import adamw_init
    p = lm_init(3, SMOKE_ARCHS[name], dtype=torch.float32, device="cpu")
    return {"params": p, "opt": adamw_init(p)}


@pytest.mark.parametrize("name", ["seamless-m4t-medium",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_list_valued_lm_trees_restore_across_packages(tmp_path, name,
                                                      writer):
    """seamless's ``encoder/layers`` and deepseek's ``prefix`` are lists of
    layer trees: a save of either package's LM state restores in the
    other, leaf for leaf, with the same paths and structure string."""
    import json
    jt, tt = _lm_state("jax", name), _lm_state("torch", name)
    assert isinstance((jt["params"].get("encoder") or {}).get("layers",
                      jt["params"].get("prefix")), list)
    assert [p for p, _ in ttree.leaves_with_paths(tt)] == \
        [jax.tree_util.keystr(k) for k, _ in
         jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert ttree.treedef_str(tt) == str(jax.tree_util.tree_structure(jt))
    if writer == "jax":
        jckpt.save(str(tmp_path), 4, jt)
        step, back = ckpt.restore(str(tmp_path), tt)
        want = [np.asarray(x) for x in jax.tree.leaves(jt)]
        got = [x.numpy() for x in ttree.leaves(back)]
    else:
        ckpt.save(str(tmp_path), 4, tt)
        step, back = jckpt.restore(str(tmp_path), jt)
        want = [x.numpy() for x in ttree.leaves(tt)]
        got = [np.asarray(x) for x in jax.tree.leaves(back)]
    assert step == 4 and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "step_00000004" / "treedef.json") as f:
        assert json.load(f)["treedef"] == \
            str(jax.tree_util.tree_structure(jt))


def _bf16_state(pkg):
    """gemma3's SMOKE params in bf16 (the config's dtype, with its f32
    leaves) from the reference's init, in either package's form."""
    from repro.configs import SMOKE_ARCHS as J_SMOKE
    from repro.models.transformer import lm_init
    from repro_torch.models.transformer import params_from_jax
    p = lm_init(jax.random.key(5), J_SMOKE["gemma3-12b"])
    assert jax.tree.leaves(p)[0].dtype == jnp.bfloat16
    if pkg == "jax":
        return p
    return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _npz_members(path):
    import zipfile
    with zipfile.ZipFile(os.path.join(path, "leaves.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bf16_checkpoint_interop(tmp_path, writer):
    """A bf16 tree saved by either package restores bit-equal in the port;
    the port's ``leaves.npz`` holds the reference's bytes (2-byte void
    records under the ``<V2`` header); and the reference's own restore
    cannot read bf16 back (ROADMAP Queue C), so the difference is pinned."""
    jt, tt = _bf16_state("jax"), _bf16_state("torch")
    jckpt.save(str(tmp_path / "jax"), 2, jt)
    ckpt.save(str(tmp_path / "torch"), 2, tt)
    assert _npz_members(tmp_path / "jax" / "step_00000002") == \
        _npz_members(tmp_path / "torch" / "step_00000002")
    tmpl = ttree.tree_map(torch.zeros_like, tt)
    step, back = ckpt.restore(str(tmp_path / writer), tmpl)
    assert step == 2
    for got, want in zip(ttree.leaves(back), ttree.leaves(tt)):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype ==
                           torch.bfloat16 else want)
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.restore(str(tmp_path / writer), jt)
