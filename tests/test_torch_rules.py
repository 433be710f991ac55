"""Guards of the port's rules: it never imports JAX or the JAX package, and
its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PKG):
        out.extend(os.path.join(root, n) for n in sorted(names)
                   if n.endswith(".py"))
    return out


def test_port_never_imports_jax_or_reference():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path}:{node.lineno} imports {mod}")
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.cnn_training\n"
        "import repro_torch.kernels.ops, repro_torch.models.cnn\n"
        "import repro_torch.core.costmodel, repro_torch.core.workredist\n"
        "import repro_torch.core.sparsity, repro_torch.models.common\n"
        "import repro_torch.models.ffn, repro_torch.benchmarks.common\n"
        "import repro_torch.benchmarks.figures\n"
        "import repro_torch.benchmarks.kernel_audit\n"
        "import repro_torch.benchmarks.run\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_without_device_raise_when_no_gpu(monkeypatch):
    from repro_torch.benchmarks import run
    from repro_torch.benchmarks.common import capture_traces
    from repro_torch.cnn_training import train_steps
    from repro_torch.data.pipeline import image_batch
    from repro_torch.models.cnn import build_cnn, params_from_jax
    from repro_torch.models.ffn import FFNConfig, ffn_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_steps(steps=1, image_size=8, width=0.0625, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cnn("vgg16", image_size=8, width=0.0625).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_batch(0, 0, batch=2, image_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_traces("vgg16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["launch_shape_audit"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ffn_init(0, FFNConfig(8, 16, "relu"))


def test_kernel_wrapper_takes_plain_version_only_for_cpu_tensors():
    from repro_torch.kernels import launch_counts, ops

    z = torch.randn(16, 16)
    ops.relu_encode(z, block=(1, 8))
    assert launch_counts()["relu_encode"] == 0
    with pytest.raises(ValueError):
        ops.relu_encode(z.to("meta"), block=(1, 8))
