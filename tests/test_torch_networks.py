"""The port's GoogLeNet and DenseNet-121 training steps against the JAX
reference, on the CPU, as tests/test_torch_models.py holds MobileNet and
ResNet-18 (same parameters, batch, tolerances and count-dict equality)."""
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import stats as jstats
from repro.models import cnn as jcnn
from repro_torch.kernels import stats as tstats
from repro_torch.models import cnn as tcnn

from test_torch_models import step_both


@pytest.fixture(autouse=True)
def _reset_both_stats():
    jstats.reset()
    tstats.reset()
    yield
    jstats.reset()
    tstats.reset()


@pytest.mark.parametrize("net", ["googlenet", "densenet121"])
def test_other_networks_step_matches_reference(net):
    """At the VGG16 smoke geometry (image 8, width 0.0625, batch 2, block
    (8, 16, 8)), IN_OUT_WR."""
    geom = dict(image_size=8, width=0.0625, num_classes=10)
    counts = step_both(jcnn.build_cnn(net, **geom),
                       tcnn.build_cnn(net, **geom), "IN_OUT_WR", (8, 16, 8))
    assert counts["queue:prefix_sum"] == sum(
        v for k, v in counts.items() if k.startswith("gemm:compact:"))
    assert not any(k.startswith("scan") for k in counts)
