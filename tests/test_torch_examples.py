"""The port's four example scripts (``examples/torch_*.py``) on the CPU.

Each runs in-process through its ``main`` with ``--device cpu`` at a
smoke size; without ``--device`` it asks for the card and raises here.
The quickstart's gradients are held against the reference script's
``net_sparse`` gradients on the same numpy draws.  No example imports JAX
or the reference package.
"""
import ast
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import IN_OUT_WR as J_IN_OUT_WR
from repro.core import relu_matmul as j_relu_matmul
from repro.core.sparsity import block_sparsity as j_block_sparsity
from repro.core.sparsity import relu_mask as j_relu_mask
from repro.kernels import stats as jstats
from repro_torch import tree
from repro_torch.kernels import stats as tstats

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
NAMES = ("quickstart", "cnn_training", "train_lm", "serve_lm")
STDLIB = {"argparse", "os", "sys", "time"}


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


def load(name):
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_only_the_port(name):
    with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
        src = ast.parse(f.read())
    roots = set()
    for node in ast.walk(src):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= STDLIB | {"repro_torch", "torch", "numpy"}, roots


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(name, tmp_path):
    argv = ["--ckpt-dir", str(tmp_path)] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)
    assert not os.listdir(tmp_path)


def test_quickstart_matches_the_reference_script(capsys):
    qs = load("quickstart")
    out = qs.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "(lossless)" in printed and "16x16-block=" in printed
    assert out["max_err"] <= 1e-5
    # The reference script's net_sparse on the same numpy draws.
    x_np, ws_np, bias_np = qs.inputs()
    policy = J_IN_OUT_WR.with_(kernel_impl="pallas", block=(16, 16, 16))
    x, bias = jnp.asarray(x_np), jnp.asarray(bias_np)

    def net_sparse(ws):
        h = x @ ws[0] + bias
        h2 = j_relu_matmul(h, ws[1], policy)
        h3 = j_relu_matmul(h2, ws[2], policy)
        return (h3 ** 2).mean()

    want = jax.grad(net_sparse)([jnp.asarray(w) for w in ws_np])
    for got, ref in zip(out["grads_sparse"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    mask = j_relu_mask(x @ jnp.asarray(ws_np[0]) + bias)
    assert out["block"] == float(j_block_sparsity(mask, 16, 16))
    assert out["element"] == float(jnp.mean(mask == 0))


def test_cnn_training_losses_and_the_cost_table(capsys):
    out = load("cnn_training").main(["--net", "vgg16", "--steps", "2",
                                     "--device", "cpu"])
    printed = capsys.readouterr().out
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    cycles = [out["totals"][sc]["total_cycles"]
              for sc in ("DC", "IN", "IN_OUT", "IN_OUT_WR")]
    assert cycles == sorted(cycles, reverse=True)
    assert all(f"  {sc:10s}" in printed
               for sc in ("DC", "IN", "IN_OUT", "IN_OUT_WR"))


def test_train_lm_resumes_bit_equal(monkeypatch, tmp_path, capsys):
    mod = load("train_lm")
    monkeypatch.setattr(mod, "LM100M", mod.LM100M.with_(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=128, q_chunk=16, kv_chunk=16))
    argv = ["--steps", "6", "--batch", "2", "--seq", "16",
            "--sparse-ffn", "--device", "cpu", "--ckpt-dir"]
    whole = mod.main(argv + [str(tmp_path / "whole")])
    killed = mod.main(argv + [str(tmp_path / "cut")], stop_after=3)
    resumed = mod.main(argv + [str(tmp_path / "cut")])
    assert whole["resumed_from"] is None and killed["resumed_from"] is None
    assert resumed["resumed_from"] == 3
    assert killed["losses"] + resumed["losses"] == whole["losses"]
    for a, b in zip(tree.leaves(resumed["params"]),
                    tree.leaves(whole["params"])):
        assert torch.equal(a, b)
    printed = capsys.readouterr().out
    assert "ffn=relu2" in printed and "resumed_from=3" in printed


def test_serve_lm_serves_every_request(capsys):
    out = load("serve_lm").main(["--device", "cpu"])
    assert sorted(out["done"]) == list(range(10))
    assert all(len(v) == 16 for v in out["done"].values())
    assert "served 10 requests / 160 tokens" in capsys.readouterr().out
