"""The paper's contribution as PyTorch autograd units: activation-based
gradient OUTPUT sparsity (plus input sparsity) for backpropagation."""
from . import policy  # noqa: F401
from .policy import DC, IN, IN_OUT, IN_OUT_WR, OUT, SCENARIOS, SparsityPolicy  # noqa: F401
from .sparse_conv import (  # noqa: F401
    conv,
    depthwise_conv,
    depthwise_relu_conv,
    relu_conv,
)
from .sparse_linear import act_matmul, matmul, relu_matmul  # noqa: F401
from .sparse_tensor import SparseTensor, coarsen_bitmap  # noqa: F401
