"""Hand-written Hopper kernels for the gradient-output-sparsity technique.

Layout (per kernel): ``<name>.py`` — the wrapper that launches the CUDA
kernel in ``csrc/<name>.cu`` for CUDA tensors, its plain PyTorch version
(taken for CPU tensors) and its launch counter; ``ops.py`` — the spec-driven
``sparse_gemm`` dispatcher; ``shapes.py`` — pad/tile helpers; ``ref.py`` —
pure-torch oracles; ``_build.py`` — the nvcc build and ctypes loader.
"""
from . import (  # noqa: F401
    bitmap_scan,
    masked_matmul,
    ops,
    queue_builder,
    ref,
    relu_encode,
    shapes,
    stats,
)
from .ops import (  # noqa: F401
    GemmMasks,
    GemmSpec,
    build_queue,
    relu_bwd_masked,
    sparse_gemm,
    weight_grad_masked,
)


def launch_counts() -> dict:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {
        "relu_encode": relu_encode.launches,
        "queue_builder": queue_builder.launches,
        "compact_gemm": masked_matmul.compact_launches,
        "predicated_gemm": masked_matmul.predicated_launches,
        "bitmap_scan": bitmap_scan.launches,
        "masked_matmul_2d": masked_matmul.masked_2d_launches,
        "compact_masked_matmul_2d": masked_matmul.compact_2d_launches,
        "splitk_reduce": masked_matmul.splitk_reduce_launches,
        "queue_member": masked_matmul.queue_member_launches,
        "emit_nan_fixup": masked_matmul.emit_fixup_launches,
    }


def reset_launch_counts() -> None:
    relu_encode.launches = 0
    queue_builder.launches = 0
    masked_matmul.compact_launches = 0
    masked_matmul.predicated_launches = 0
    bitmap_scan.launches = 0
    masked_matmul.masked_2d_launches = 0
    masked_matmul.compact_2d_launches = 0
    masked_matmul.splitk_reduce_launches = 0
    masked_matmul.queue_member_launches = 0
    masked_matmul.emit_fixup_launches = 0
