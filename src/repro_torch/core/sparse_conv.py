"""The paper's fused CONV–ReLU unit, lowered to masked GEMMs via im2col (the
port of ``repro.core.sparse_conv``).

One engine, a ``torch.autograd.Function`` taking ``(fused_relu, groups)``;
``relu_conv`` (fused ReLU), ``conv`` (signed input: pool or input-layer
boundary) and their depthwise forms (``groups == C``, MobileNet's dw layers)
are thin faces over it.  A grouped conv runs each stage as ONE batched
(G, ·, ·) masked GEMM with degenerate per-group tiles
(``policy.gemm_spec(dims=..., grans=...)``).  All three stages realize the
same skipping opportunities as ``core.sparse_linear``: FP input sparsity of
relu(x_pre) patches; BP output sparsity from σ'(x_pre) plus input sparsity
of the incoming gradient patches; WG input sparsity on both operands.

The forward runs the fused ``relu_encode`` over the activation's
(N·H·W, C) view once, at per-pixel row granularity; every other mask is
derived from that bitmap: the BP out_mask by re-tiling, the patch masks by
running ``_im2col`` on the bitmap itself, the dy masks from the producing
GEMM's emitted bitmap.  The channel granularity divides C//G, so the
per-group masks are pure reshapes of the same bitmaps (``_group_*``).  A
signed input gets its bitmap from one ``bitmap_scan`` when the policy opts
in (``scan_signed_inputs``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import stats
from .policy import SparsityPolicy
from .sparse_linear import (_mm, _mm_elided, _needs_act_bitmap,
                            _needs_grad_bitmap)
from .sparse_tensor import (
    SparseTensor,
    coarsen_bitmap,
    conv_channel_granularity,
    lookup_grad_bitmap,
    register_grad_bitmap,
    scan_bitmap,
)


def _pad_amounts(h: int, r: int, stride: int, padding: str) -> Tuple[int, int]:
    if padding == "VALID":
        return 0, 0
    out = -(-h // stride)  # ceil
    total = max((out - 1) * stride + r - h, 0)
    return total // 2, total - total // 2


def conv_out_size(h: int, r: int, stride: int, padding: str) -> int:
    lo, hi = _pad_amounts(h, r, stride, padding)
    return (h + lo + hi - r) // stride + 1


def _im2col(x: torch.Tensor, r: int, s: int, stride: int,
            pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """x: (N,H,W,C) -> (N, U, V, R*S*C) patches, (r, s, c)-ordered (the
    order the HWIO weight reshape needs; ``F.unfold`` would give
    (c, r, s)).  Works on data and on int32 bitmaps alike."""
    n, h, w, c = x.shape
    plo_h, phi_h, plo_w, phi_w = pad
    xp = F.pad(x, (0, 0, plo_w, phi_w, plo_h, phi_h)).contiguous()
    hp, wp = h + plo_h + phi_h, w + plo_w + phi_w
    u = (hp - r) // stride + 1
    v = (wp - s) // stride + 1
    sn, sh, sw, sc = xp.stride()
    windows = xp.as_strided((n, u, v, r, s, c),
                            (sn, stride * sh, stride * sw, sh, sw, sc))
    return windows.reshape(n, u, v, r * s * c)


def _dilate_hw(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Insert stride-1 zeros between spatial elements (for grad-input)."""
    if stride == 1:
        return x
    n, h, w, c = x.shape
    out = x.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
    out[:, ::stride, ::stride, :] = x
    return out


# ---------------------------------------------------------------------------
# Group splitting — pure reshapes; the (tap, channel)-minor K ordering means
# group g's columns are contiguous per tap, so one permute regroups a patch
# matrix (data OR bitmap) into the (G, ·, ·) batched-GEMM layout.
# ---------------------------------------------------------------------------

def _group_patches(pm2: torch.Tensor, taps: int, groups: int) -> torch.Tensor:
    """(T, taps*C') patch matrix -> (G, T, taps*C'/G), per-group K slices.
    Works on data (C' = C) and fine bitmaps (C' = C/gc) alike."""
    t, k = pm2.shape
    cg = k // taps // groups
    return pm2.reshape(t, taps, groups, cg).permute(2, 0, 1, 3) \
        .reshape(groups, t, taps * cg)


def _group_cols(x2: torch.Tensor, groups: int) -> torch.Tensor:
    """(T, C') channel-minor matrix -> (G, T, C'/G), a strided view."""
    t, c = x2.shape
    return x2.reshape(t, groups, c // groups).transpose(0, 1)


def _ungroup_cols(x3: torch.Tensor) -> torch.Tensor:
    """(G, T, C/G) -> (T, C), inverse of ``_group_cols``."""
    g, t, cg = x3.shape
    return x3.transpose(0, 1).reshape(t, g * cg)


def _group_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(R, S, C//G, M) grouped-HWIO weights -> (G, R·S·C//G, M//G): output
    block g (channels [g·M/G, (g+1)·M/G)) reads input group g."""
    r, s, cg, m = w.shape
    return w.reshape(r * s * cg, groups, m // groups).transpose(0, 1)


def _group_weights_bwd(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-group dX weights: (R, S, C//G, M) -> (G, R·S·M//G, C//G),
    spatially flipped and (r, s, m, c)-ordered to match gradient patches."""
    r, s, cg, m = w.shape
    mg = m // groups
    wf = torch.flip(w, dims=(0, 1)).reshape(r, s, cg, groups, mg)
    return wf.permute(3, 0, 1, 4, 2).reshape(groups, r * s * mg, cg)


# ---------------------------------------------------------------------------
# Bitmap derivation (no tensor-sized scans past this line)
# ---------------------------------------------------------------------------

def _patch_bitmap(st: SparseTensor, spatial: Tuple[int, int, int, int],
                  r: int, s: int, stride: int,
                  pad: Tuple[int, int, int, int]) -> SparseTensor:
    """im2col in bitmap space: (N·H·W, C/gc) fine bitmap -> fine bitmap of
    the patch matrix (N·U·V, R·S·C/gc), equal to a fresh scan of
    ``_im2col(data)``."""
    n, h, w, c = spatial
    gc = st.gran[1]
    with stats.lifecycle_scope("derive", "im2col"):
        fb4 = st.bitmap.reshape(n, h, w, c // gc)
        pb = _im2col(fb4, r, s, stride, pad)
        u, v = pb.shape[1], pb.shape[2]
        return SparseTensor(pb.reshape(n * u * v, -1), (1, gc))


def _encode_conv_act(x_pre: torch.Tensor, policy: SparsityPolicy,
                     gc: int) -> Tuple[torch.Tensor, SparseTensor]:
    """(relu(x_pre), SparseTensor over the (N·H·W, C) view) — ONE fused
    encode (pallas) or one counted scan (xla_ref) per activation."""
    n, h, w, c = x_pre.shape
    x2d = x_pre.reshape(n * h * w, c)
    if policy.kernel_impl == "pallas":
        y2d, fb = kops.relu_encode(x2d.contiguous(), block=(1, gc))
        x = y2d.reshape(n, h, w, c)
    else:
        x = torch.relu(x_pre)
        fb = scan_bitmap(x.reshape(n * h * w, c), (1, gc), kind="act")
    return x, SparseTensor(fb, (1, gc))


def _grad_sparse_tensor(dy, policy: SparsityPolicy, m: int,
                        groups: int = 1) -> SparseTensor:
    """Fine bitmap of the incoming gradient, from the producing dX GEMM's
    emitted bitmap (registered against the exact gradient object) — never
    a rescan; a miss or an unusable granularity degrades to no mask."""
    if not _needs_grad_bitmap(policy):
        return SparseTensor(None, None)
    hit = lookup_grad_bitmap(dy)
    if hit is None:
        return SparseTensor(None, None)
    fb, (gr, gcg) = hit
    bm, bk, bn = policy.block
    if (gr != 1 or m % gcg or (m // gcg) % groups
            or bk % gcg or bn % gcg):
        return SparseTensor(None, None)
    return SparseTensor(fb, (1, gcg))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _ConvEngine(torch.autograd.Function):
    """y = conv2d(relu(x) if fused_relu else x, w, groups).  x: (N,H,W,C)
    NHWC; w: (R,S,C//G,M) grouped HWIO."""

    @staticmethod
    def forward(ctx, x_in, w, stride: int, padding: str,
                policy: SparsityPolicy, fused_relu: bool, groups: int):
        n, h, wd, c = x_in.shape
        r, s, cg_w, m = w.shape
        if c % groups or m % groups or cg_w != c // groups:
            raise ValueError(f"weights {tuple(w.shape)} do not match input "
                             f"{tuple(x_in.shape)} in {groups} groups")
        plh = _pad_amounts(h, r, stride, padding)
        plw = _pad_amounts(wd, s, stride, padding)
        pad4 = (plh[0], plh[1], plw[0], plw[1])

        if fused_relu and _needs_act_bitmap(policy):
            gc = conv_channel_granularity(c, policy.block, groups)
            x, st = _encode_conv_act(x_in, policy, gc)
        else:
            x = torch.relu(x_in) if fused_relu else x_in
            st = SparseTensor(None, None)
            # A signed input (pool / input-layer boundary) has no fused
            # encode: its bitmap costs one standalone scan, opt-in.
            if not fused_relu and policy.scan_signed_inputs \
                    and policy.kernel_impl == "pallas" \
                    and (policy.use_input_sparsity_fp
                         or policy.use_input_sparsity_bp):
                gc = conv_channel_granularity(c, policy.block, groups)
                st = SparseTensor(
                    scan_bitmap(x.reshape(n * h * wd, c), (1, gc),
                                kind="act", impl=policy.kernel_impl),
                    (1, gc))

        patches = _im2col(x, r, s, stride, pad4)
        u, v = patches.shape[1], patches.shape[2]
        t = n * u * v
        pm = patches.reshape(t, r * s * c)
        want_a_mask = (policy.use_input_sparsity_fp
                       and policy.kernel_impl == "pallas"
                       and st.bitmap is not None)
        if groups == 1:
            a_mask = None
            if want_a_mask:
                bm, bk, bn = policy.block
                a_mask = _patch_bitmap(st, (n, h, wd, c), r, s, stride,
                                       pad4).mask_for((bm, bk))
            y = _mm(pm, w.reshape(r * s * c, m), None, a_mask, None, policy,
                    x_in.dtype)
        else:
            cg, mg = c // groups, m // groups
            gc = st.gran[1] if st.gran else 1
            spec = policy.gemm_spec(groups=groups, dims=(t, r * s * cg, mg),
                                    grans=(1, gc, 1))
            blk = spec.block
            a_mask = None
            if want_a_mask and r * s * cg >= policy.grouped_sparsity_min_k:
                pb = _patch_bitmap(st, (n, h, wd, c), r, s, stride, pad4)
                pbg = _group_patches(pb.bitmap, r * s, groups)
                a_mask = coarsen_bitmap(pbg, (1, gc), (blk[0], blk[1]))
            yg = _mm(_group_patches(pm, r * s, groups),
                     _group_weights(w, groups), None, a_mask, None, policy,
                     x_in.dtype, spec=spec)
            y = _ungroup_cols(yg)
        ctx.save_for_backward(x_in, w)
        ctx.st = st
        ctx.cfg = (stride, padding, policy, fused_relu, groups)
        ctx.layer = stats.current_layer()
        return y.reshape(n, u, v, m)

    @staticmethod
    def backward(ctx, dy):
        with stats.layer_scope(ctx.layer):
            return _ConvEngine._backward(ctx, dy)

    @staticmethod
    def _backward(ctx, dy):
        x_in, w = ctx.saved_tensors
        st = ctx.st
        stride, padding, policy, fused_relu, groups = ctx.cfg
        want_dx, want_dw = ctx.needs_input_grad[:2]
        n, h, wd, c = x_in.shape
        r, s, _, m = w.shape
        u, v = dy.shape[1], dy.shape[2]
        bm, bk, bn = policy.block
        out_dtype = x_in.dtype
        dy32 = dy.to(torch.float32)
        st_dy = _grad_sparse_tensor(dy, policy, m, groups)
        t = n * u * v
        cg, mg = c // groups, m // groups
        gc = st.gran[1] if st.gran else 1
        gcg = st_dy.gran[1] if st_dy.gran else 1
        plh = _pad_amounts(h, r, stride, padding)
        plw = _pad_amounts(wd, s, stride, padding)
        pad4 = (plh[0], plh[1], plw[0], plw[1])

        # ---- dX: full correlation of the dilated dy with the flipped w;
        # for the fused unit the σ' Hadamard rides the kernel epilogue.
        # Nothing of it is built when autograd will not read dx (the
        # image's gradient): the dispatch is only counted ----
        hd, wdd = (u - 1) * stride + 1, (v - 1) * stride + 1
        pg_h_lo = r - 1 - plh[0]
        pg_h_hi = h - (hd + pg_h_lo - r + 1)
        pg_w_lo = s - 1 - plw[0]
        pg_w_hi = wd - (wdd + pg_w_lo - s + 1)
        gpad4 = (pg_h_lo, pg_h_hi, pg_w_lo, pg_w_hi)
        use_out = fused_relu and policy.use_output_sparsity \
            and st.bitmap is not None
        # This dX GEMM produces the layer below's dy: its epilogue emits
        # that dy's fine bitmap and registers it against the returned dx.
        emit_gc = conv_channel_granularity(c, policy.block, groups) \
            if _needs_grad_bitmap(policy) else None
        emit = None if emit_gc is None else (1, emit_gc)
        dx_dims = (n * h * wd, r * s * mg, cg)
        dx_spec = None if groups == 1 else policy.gemm_spec(
            groups=groups, dims=dx_dims, grans=(1, gcg, gc))

        def dx_masks():
            """(out, a) masks of the dX GEMM: σ′'s footprint and the
            gradient patches' bitmap."""
            gpb2 = None
            if st_dy.bitmap is not None:
                with stats.lifecycle_scope("derive", "grad_patches"):
                    gfb4 = st_dy.bitmap.reshape(n, u, v, m // gcg)
                    gpb = _im2col(_dilate_hw(gfb4, stride), r, s, 1, gpad4)
                    gpb2 = gpb.reshape(n * h * wd, -1)
            if groups == 1:
                out_mask = st.mask_for((bm, bn)) if use_out else None
                g_mask = None if gpb2 is None \
                    else coarsen_bitmap(gpb2, (1, gcg), (bm, bk))
                return out_mask, g_mask, None
            blk = dx_spec.block
            out_mask = None
            if use_out:
                out_mask = coarsen_bitmap(_group_cols(st.bitmap, groups),
                                          (1, gc), (blk[0], blk[2]))
            g_mask = None
            if gpb2 is not None \
                    and r * s * mg >= policy.grouped_sparsity_min_k:
                g_mask = coarsen_bitmap(_group_patches(gpb2, r * s, groups),
                                        (1, gcg), (blk[0], blk[1]))
            return out_mask, g_mask, None

        dx = None
        if not want_dx:
            _mm_elided(dx_dims, dx_masks, policy, out_dtype,
                       fused_mult=fused_relu, spec=dx_spec, emit_gran=emit)
        else:
            gm2 = _im2col(_dilate_hw(dy32, stride), r, s, 1, gpad4) \
                .reshape(n * h * wd, r * s * m)
            out_mask, g_mask, _ = dx_masks()
            mask2d = (x_in > 0).reshape(n * h * wd, c).to(torch.float32) \
                if fused_relu else None
            if groups == 1:
                wt = torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2) \
                    .reshape(r * s * m, c).to(torch.float32)
                res_dx = _mm(gm2, wt, out_mask, g_mask, None, policy,
                             out_dtype, epilogue=mask2d, emit_gran=emit)
                dx2, dx_bits = res_dx if emit is not None else (res_dx, None)
            else:
                epi = None if mask2d is None else _group_cols(mask2d, groups)
                res_dx = _mm(_group_patches(gm2, r * s, groups),
                             _group_weights_bwd(w, groups).to(torch.float32),
                             out_mask, g_mask, None, policy, out_dtype,
                             epilogue=epi, spec=dx_spec, emit_gran=emit)
                dxg, dxg_bits = res_dx if emit is not None \
                    else (res_dx, None)
                dx2 = _ungroup_cols(dxg)
                # Per-group bit columns regroup to the full channel axis
                # the same way the data does (cells nest inside groups).
                dx_bits = None if dxg_bits is None \
                    else _ungroup_cols(dxg_bits)
            dx = dx2.reshape(n, h, wd, c)
            if emit is not None:
                register_grad_bitmap(dx, dx_bits, emit)

        # ---- dW = patches(x)ᵀ @ dy — WG stage, input sparsity both sides;
        # the kernel reads patchesᵀ through its strides ----
        want_pt_mask = _needs_grad_bitmap(policy) and st.bitmap is not None
        dw_dims = (r * s * cg, t, mg)
        dw_spec = None if groups == 1 else policy.gemm_spec(
            groups=groups, dims=dw_dims, grans=(gc, 1, gcg))

        def dw_masks():
            """(a, b) masks of the WG GEMM: the patches' bitmap, transposed,
            and dy's."""
            if groups == 1:
                pt_mask = None
                if want_pt_mask:
                    pt_mask = _patch_bitmap(st, (n, h, wd, c), r, s, stride,
                                            pad4).t_mask_for((bm, bk))
                return None, pt_mask, st_dy.mask_for((bk, bn))
            blk = dw_spec.block
            pt_mask = None
            if want_pt_mask:
                pb = _patch_bitmap(st, (n, h, wd, c), r, s, stride, pad4)
                pbg = _group_patches(pb.bitmap, r * s, groups)
                pt_mask = coarsen_bitmap(pbg.transpose(1, 2), (gc, 1),
                                         (blk[0], blk[1]))
            dym_mask = None
            if st_dy.bitmap is not None:
                dym_mask = coarsen_bitmap(_group_cols(st_dy.bitmap, groups),
                                          (1, gcg), (blk[1], blk[2]))
            return None, pt_mask, dym_mask

        if not want_dw:
            _mm_elided(dw_dims, dw_masks, policy, torch.float32,
                       spec=dw_spec)
            return dx, None, None, None, None, None, None
        x = torch.where(x_in > 0, x_in, torch.zeros(
            (), dtype=x_in.dtype, device=x_in.device)) if fused_relu \
            else x_in
        pm = _im2col(x, r, s, stride, pad4).reshape(t, r * s * c) \
            .to(torch.float32)
        dym = dy32.reshape(t, m)
        _, pt_mask, dym_mask = dw_masks()
        if groups == 1:
            dw = _mm(pm.t(), dym, None, pt_mask, dym_mask, policy,
                     torch.float32)
            dw = dw.reshape(r, s, c, m)
        else:
            dwg = _mm(_group_patches(pm, r * s, groups).transpose(1, 2),
                      _group_cols(dym, groups), None, pt_mask, dym_mask,
                      policy, torch.float32, spec=dw_spec)
            # (G, R·S·C//G, M//G) -> (R, S, C//G, M), group-major outputs
            dw = dwg.transpose(0, 1).reshape(r, s, cg, m)
        return dx, dw.to(w.dtype), None, None, None, None, None


def relu_conv(x_pre: torch.Tensor, w: torch.Tensor, stride: int,
              padding: str, policy: SparsityPolicy, groups: int = 1):
    """y = conv2d(relu(x_pre), w). x_pre: (N,H,W,C); w: (R,S,C//G,M)."""
    return _ConvEngine.apply(x_pre, w, stride, padding, policy, True, groups)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: str,
         policy: SparsityPolicy, groups: int = 1):
    """Plain conv2d (no fused ReLU): FP/BP input sparsity only; used at
    pool→conv and input-layer boundaries."""
    return _ConvEngine.apply(x, w, stride, padding, policy, False, groups)


def depthwise_relu_conv(x_pre: torch.Tensor, w: torch.Tensor, stride: int,
                        padding: str, policy: SparsityPolicy):
    """Depthwise conv over relu(x_pre): groups == C, w: (R,S,1,C·mult).
    The engine runs C tiny masked GEMMs as one batched launch per stage."""
    return _ConvEngine.apply(x_pre, w, stride, padding, policy, True,
                             x_pre.shape[-1])


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                   padding: str, policy: SparsityPolicy):
    """Depthwise conv over signed x (no fused ReLU): groups == C."""
    return _ConvEngine.apply(x, w, stride, padding, policy, False,
                             x.shape[-1])
