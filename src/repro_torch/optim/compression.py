"""int8 error-feedback gradient compression for the data-parallel
all-reduce — the port of ``repro.optim.compression``.

int8 quantization with a per-tensor scale, and error feedback (the
residual carried to the next step) that keeps the compressed trajectory
tracking the exact one (Karimireddy et al., 2019).  ``compressed_psum``
quantizes (with error feedback), all-reduces the DEQUANTIZED payload and
returns the mean with the new error state.  The wire carries float32, as
the reference's ``psum(q.astype(jnp.float32) * scale)`` does: each rank's
scale differs, so the sum of the dequantized tensors is what is reduced,
and the bytes moved are those of an f32 all-reduce.  The reduce goes
through ``sharding.collectives`` inside a ``collective`` region, so its
bytes count in ``collectives.wire_bytes()``.  As in the reference, no
training path uses it.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats
from repro_torch.sharding import collectives, partition


def quantize(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q_int8, scale, new_err).  g, err: same-shape f32."""
    target = g.to(torch.float32) + err
    scale = target.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads: Any) -> Any:
    return _tree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def compressed_psum(grads: Any, err: Any, mesh, axes) -> Tuple[Any, Any]:
    """Mean all-reduce of ``grads`` over ``axes`` of ``mesh`` of the int8-
    quantized, dequantized gradients (f32 on the wire).  Returns
    (mean_grads_f32, new_err)."""
    n = partition.axis_size(mesh, axes)

    def one(g, e):
        q, scale, e1 = quantize(g, e)
        with stats.lifecycle_scope("collective", "int8"):
            summed = collectives._reduce(dequantize(q, scale), mesh, axes)
        return summed / n, e1

    pairs = [one(g, e) for g, e in zip(_tree.leaves(grads),
                                       _tree.leaves(err))]
    return (_tree.unflatten_like(grads, [p[0] for p in pairs]),
            _tree.unflatten_like(grads, [p[1] for p in pairs]))
