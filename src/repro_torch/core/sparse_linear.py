"""The paper's fused GEMM–ReLU unit for dense layers (the port of
``repro.core.sparse_linear``).

``relu_matmul(x_pre, w)`` computes ``relu(x_pre) @ w`` as a
``torch.autograd.Function`` whose backward realizes the paper's three
skipping opportunities:

  forward   : INPUT sparsity of relu(x_pre);
  backward  : dx_pre = (dy @ Wᵀ) ⊙ σ'(x_pre) — OUTPUT sparsity from the
              forward bitmap, INPUT sparsity of dy;
  wt-grad   : dW = relu(x_pre)ᵀ @ dy — INPUT sparsity on both operands.

The forward computes the activation's fine bitmap exactly once (the fused
``relu_encode``); the backward derives every mask from it, and takes dy's
bitmap from the producing dX GEMM's emit epilogue through the registry.
``matmul`` is the plain (no fused ReLU) unit the CNN head uses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import stats
from repro_torch.kernels.ops import GemmMasks, GemmSpec
from .policy import SparsityPolicy
from .sparse_tensor import (
    SparseTensor,
    linear_act_granularity,
    linear_grad_granularity,
    lookup_grad_bitmap,
    register_grad_bitmap,
    scan_bitmap,
)


def _final_spec(spec: GemmSpec, policy: SparsityPolicy, out_dtype,
                fused_mult: bool, emit_gran: Optional[Tuple[int, int]]):
    """The spec ``_mm`` dispatches, from the resolved one: ``(spec,
    separate, dropped_emit)``.  ``separate`` is the ablation
    (``policy.fuse_epilogue=False`` on a kernel schedule): the GEMM runs
    bare in float32 and the multiplier is applied after it, its bits
    dropped.  ``dropped_emit``: the granularity does not divide the tile,
    so no bitmap is emitted."""
    if fused_mult and spec.schedule != "dense" \
            and not policy.fuse_epilogue:
        return spec.with_(epilogue=(), emit_gran=None,
                          out_dtype=torch.float32), True, False
    dropped_emit = emit_gran is not None and bool(
        spec.block[0] % emit_gran[0] or spec.block[2] % emit_gran[1])
    if dropped_emit:
        emit_gran = None
    stages = []
    if fused_mult:
        stages.append("sigma_prime")
    if emit_gran is not None:
        stages.append("bitmap_emit")
    return spec.with_(epilogue=tuple(stages), emit_gran=emit_gran,
                      out_dtype=out_dtype), False, dropped_emit


def _mm(a, b, out_mask, a_mask, b_mask, policy: SparsityPolicy, out_dtype,
        epilogue: Optional[torch.Tensor] = None,
        spec: Optional[GemmSpec] = None,
        emit_gran: Optional[Tuple[int, int]] = None):
    """Route one masked matmul through ``kernels.ops.sparse_gemm``, resolving
    the policy to a ``GemmSpec`` unless the caller already resolved one (the
    conv engine passes specs carrying degenerate per-group tiles).

    ``epilogue`` is an (M, N) multiplier fused into the writeback, or, with
    ``policy.fuse_epilogue=False`` on a kernel schedule, applied as a
    separate pass after the GEMM (the ablation; its bits are then dropped).
    ``emit_gran`` requests the ``bitmap_emit`` stage: the result is then
    ``(out, bits_or_None)``; None bits mean the emission was dropped (the
    ablation, or a tile the granularity does not divide).  3-D operands
    (G, M, K) @ (G, K, N) dispatch as a grouped spec."""
    if spec is None:
        spec = policy.gemm_spec(groups=a.shape[0] if a.dim() == 3 else 1)
    masks = GemmMasks(out_mask, a_mask, b_mask)
    spec, separate, dropped_emit = _final_spec(
        spec, policy, out_dtype, epilogue is not None, emit_gran)
    if separate:
        out = kops.sparse_gemm(a, b, masks, spec)
        out = (out * epilogue.to(torch.float32)).to(out_dtype)
        return (out, None) if emit_gran is not None else out
    res = kops.sparse_gemm(a, b, masks, spec, epilogue_mult=epilogue)
    if dropped_emit:
        return res, None
    return res


def _mm_elided(dims: Tuple[int, int, int], masks, policy: SparsityPolicy,
               out_dtype, fused_mult: bool = False,
               spec: Optional[GemmSpec] = None,
               emit_gran: Optional[Tuple[int, int]] = None) -> None:
    """The ``_mm`` whose result autograd will not read: the spec resolved
    and counted as ``_mm`` would dispatch it, nothing built or launched
    (``kernels.ops.elide_gemm``).  ``masks`` is a callable giving the
    (out, a, b) masks, called only when the autotuner reads them."""
    if spec is None:
        spec = policy.gemm_spec()
    spec, _, _ = _final_spec(spec, policy, out_dtype, fused_mult, emit_gran)
    kops.elide_gemm(spec, dims, masks)


def _needs_act_bitmap(policy: SparsityPolicy) -> bool:
    """Does any consumer of an activation bitmap exist under this policy?"""
    if policy.use_output_sparsity:
        return True
    return policy.kernel_impl == "pallas" and (
        policy.use_input_sparsity_fp or policy.use_input_sparsity_bp)


def _needs_grad_bitmap(policy: SparsityPolicy) -> bool:
    return policy.kernel_impl == "pallas" and policy.use_input_sparsity_bp


def _grad_sparse_tensor_linear(dy, policy: SparsityPolicy) -> SparseTensor:
    """The incoming gradient's ``SparseTensor``: its bitmap comes from the
    producing dX GEMM's epilogue through the registry, never a rescan; a
    miss degrades to no mask."""
    if not _needs_grad_bitmap(policy):
        return SparseTensor(None, None)
    hit = lookup_grad_bitmap(dy)
    if hit is None:
        return SparseTensor(None, None)
    bitmap, (gr, gc) = hit
    bm, bk, bn = policy.block
    if bm % gr or bk % gr or bk % gc or bn % gc:
        return SparseTensor(None, None)
    return SparseTensor(bitmap, (gr, gc))


def _wg_bitmap(xt_mask, dyb_mask, kt: int, mt: int, nt: int):
    """The weight gradient's block bitmap from the WG GEMM's operand masks:
    dW tile (i, j) can be nonzero only if some reduction block m has both
    x̃ᵀ(i, m) and dy(m, j) live.  Pure mask algebra."""
    if xt_mask is None and dyb_mask is None:
        return None
    with stats.lifecycle_scope("derive", "wg"):
        dev = (xt_mask if xt_mask is not None else dyb_mask).device
        a = xt_mask.to(torch.int32) if xt_mask is not None \
            else torch.ones((kt, mt), dtype=torch.int32, device=dev)
        b = dyb_mask.to(torch.int32) if dyb_mask is not None \
            else torch.ones((mt, nt), dtype=torch.int32, device=dev)
        return ((a[:, :, None] * b[None, :, :]).sum(dim=1) > 0) \
            .to(torch.int32)


def _act(x_pre, act: str):
    r = torch.relu(x_pre)
    return r * r if act == "relu2" else r


def _act_grad_multiplier(x_pre, act: str):
    if act == "relu2":
        return 2.0 * torch.relu(x_pre.to(torch.float32))
    return (x_pre > 0).to(torch.float32)


def _encode_act(x_pre, policy: SparsityPolicy, gran: Tuple[int, int]):
    """(relu(x_pre), fine bitmap) — the fused kernel on the pallas impl,
    one counted scan on xla_ref.  Either way ONE bitmap computation."""
    if policy.kernel_impl == "pallas":
        return kops.relu_encode(x_pre.contiguous(), block=gran)
    r = torch.relu(x_pre)
    return r, scan_bitmap(r, gran, kind="act")


# ---------------------------------------------------------------------------
# act_matmul / relu_matmul — the composable unit
# ---------------------------------------------------------------------------

class _ActMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_pre, w, policy: SparsityPolicy, act: str):
        bm, bk, bn = policy.block
        if _needs_act_bitmap(policy):
            gran = linear_act_granularity(policy.block)
            r, bitmap = _encode_act(x_pre, policy, gran)
            x = r * r if act == "relu2" else r
        else:
            x = _act(x_pre, act)
            bitmap, gran = None, None
        st = SparseTensor(bitmap, gran)
        a_mask = None
        if policy.use_input_sparsity_fp and policy.kernel_impl == "pallas":
            a_mask = st.mask_for((bm, bk))
        y = _mm(x, w, None, a_mask, None, policy, x_pre.dtype)
        ctx.save_for_backward(x_pre, w)
        ctx.st, ctx.policy, ctx.act = st, policy, act
        ctx.layer = stats.current_layer()
        return y

    @staticmethod
    def backward(ctx, dy):
        with stats.layer_scope(ctx.layer):
            return _ActMatmul._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x_pre, w = ctx.saved_tensors
        st, policy, act = ctx.st, ctx.policy, ctx.act
        want_dx, want_dw = ctx.needs_input_grad[:2]
        bm, bk, bn = policy.block
        dy32 = dy.to(torch.float32)
        st_dy = _grad_sparse_tensor_linear(dy, policy)
        t, (k, n) = x_pre.shape[0], w.shape

        # dx_pre = (dy @ Wᵀ) ⊙ σ'(x_pre); the out_mask is the forward
        # bitmap re-tiled, and this GEMM emits the next layer's dy bitmap.
        def dx_masks():
            return (st.mask_for((bm, bn)) if policy.use_output_sparsity
                    else None, st_dy.mask_for((bm, bk)), None)

        emit = linear_grad_granularity(policy.block) \
            if _needs_grad_bitmap(policy) else None
        dx_pre = None
        if want_dx:
            res = _mm(dy32, w.to(torch.float32).t(), *dx_masks(), policy,
                      x_pre.dtype, epilogue=_act_grad_multiplier(x_pre, act),
                      emit_gran=emit)
            if emit is not None:
                dx_pre, dx_bits = res
                register_grad_bitmap(dx_pre, dx_bits, emit)
            else:
                dx_pre = res
        else:
            _mm_elided((t, n, k), dx_masks, policy, x_pre.dtype,
                       fused_mult=True, emit_gran=emit)

        # dW = xᵀ @ dy; Xᵀ's mask is the same forward bitmap, transposed.
        def dw_masks():
            return (None, st.t_mask_for((bm, bk))
                    if _needs_grad_bitmap(policy) else None,
                    st_dy.mask_for((bk, bn)))

        if not want_dw:
            _mm_elided((k, t, n), dw_masks, policy, torch.float32)
            return dx_pre, None, None, None
        _, xt_mask, dyb_mask = dw_masks()
        xt = _act(x_pre, act).to(torch.float32).t()
        dw = _mm(xt, dy32, None, xt_mask, dyb_mask, policy, torch.float32)
        dw = dw.to(w.dtype)
        register_grad_bitmap(
            dw, _wg_bitmap(xt_mask, dyb_mask, -(-k // bm), -(-t // bk),
                           -(-n // bn)),
            (bm, bn))
        return dx_pre, dw, None, None


def act_matmul(x_pre: torch.Tensor, w: torch.Tensor, policy: SparsityPolicy,
               act: str = "relu") -> torch.Tensor:
    """y = act(x_pre) @ w, sparse-aware in both passes. x_pre: (T, K),
    w: (K, N); act ∈ {"relu", "relu2"}."""
    if act not in ("relu", "relu2"):
        raise ValueError(f"unknown activation {act!r}")
    return _ActMatmul.apply(x_pre, w, policy, act)


def relu_matmul(x_pre: torch.Tensor, w: torch.Tensor,
                policy: SparsityPolicy) -> torch.Tensor:
    """y = relu(x_pre) @ w — the paper's unit (alias of act_matmul)."""
    return act_matmul(x_pre, w, policy, "relu")


# ---------------------------------------------------------------------------
# plain matmul (raw / dense input): only input-sparsity opportunities apply
# ---------------------------------------------------------------------------

class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, policy: SparsityPolicy):
        bm, bk, bn = policy.block
        st = SparseTensor(None, None)
        # Raw (signed) inputs have no ReLU to fuse an encode into, so their
        # bitmap costs a standalone scan — opt-in via scan_signed_inputs.
        if policy.scan_signed_inputs and policy.kernel_impl == "pallas" and (
                policy.use_input_sparsity_fp or policy.use_input_sparsity_bp):
            gran = linear_act_granularity(policy.block)
            st = SparseTensor(scan_bitmap(x, gran, kind="act",
                                          impl=policy.kernel_impl), gran)
        a_mask = None
        if policy.use_input_sparsity_fp and policy.kernel_impl == "pallas":
            a_mask = st.mask_for((bm, bk))
        y = _mm(x, w, None, a_mask, None, policy, x.dtype)
        ctx.save_for_backward(x, w)
        ctx.st, ctx.policy = st, policy
        ctx.layer = stats.current_layer()
        return y

    @staticmethod
    def backward(ctx, dy):
        with stats.layer_scope(ctx.layer):
            return _Matmul._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x, w = ctx.saved_tensors
        st, policy = ctx.st, ctx.policy
        want_dx, want_dw = ctx.needs_input_grad[:2]
        bm, bk, bn = policy.block
        dy32 = dy.to(torch.float32)
        st_dy = _grad_sparse_tensor_linear(dy, policy)
        t, (k, n) = x.shape[0], w.shape

        def dx_masks():
            return None, st_dy.mask_for((bm, bk)), None

        emit = linear_grad_granularity(policy.block) \
            if _needs_grad_bitmap(policy) else None
        dx = None
        if want_dx:
            res_dx = _mm(dy32, w.to(torch.float32).t(), *dx_masks(), policy,
                         x.dtype, emit_gran=emit)
            if emit is not None:
                dx, dx_bits = res_dx
                register_grad_bitmap(dx, dx_bits, emit)
            else:
                dx = res_dx
        else:
            _mm_elided((t, n, k), dx_masks, policy, x.dtype, emit_gran=emit)

        def dw_masks():
            return (None, st.t_mask_for((bm, bk))
                    if _needs_grad_bitmap(policy) else None,
                    st_dy.mask_for((bk, bn)))

        if not want_dw:
            _mm_elided((k, t, n), dw_masks, policy, w.dtype)
            return dx, None, None
        _, xt_mask, dyb_mask = dw_masks()
        xt = x.to(torch.float32).t()
        dw = _mm(xt, dy32, None, xt_mask, dyb_mask, policy, w.dtype)
        register_grad_bitmap(
            dw, _wg_bitmap(xt_mask, dyb_mask, -(-k // bm), -(-t // bk),
                           -(-n // bn)),
            (bm, bn))
        return dx, dw, None


def matmul(x: torch.Tensor, w: torch.Tensor,
           policy: SparsityPolicy) -> torch.Tensor:
    """y = x @ w with FP input sparsity where a bitmap exists (the CNN
    head)."""
    return _Matmul.apply(x, w, policy)
