"""The paper's CNN benchmarks on ``core.sparse_conv``'s units (the port of
``repro.models.cnn``): the layer IR, the five network definitions, and
``CNNModel`` init/apply/loss over a plain dict of tensors keyed like the JAX
param tree (``{"conv1": {"w": (R,S,C,M)}, ..., "head": {"w": (C, classes)}}``),
and its cost-model bridge (``conv_specs``, ``gemm_workload``).

Activations are NHWC and weights HWIO, as in the reference.  Depthwise
nodes (MobileNet) run through the engine's grouped branch.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.costmodel import ConvSpec
from repro_torch.core.policy import DC, SparsityPolicy
from repro_torch.core.sparse_conv import (
    _pad_amounts,
    depthwise_conv,
    depthwise_relu_conv,
    relu_conv,
)
from repro_torch.core.sparse_conv import conv as sconv
from repro_torch.core.sparse_linear import matmul as smatmul
from repro_torch.device import resolve_device
from repro_torch.kernels import stats

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Layer IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConvNode:
    name: str
    out_ch: int
    kernel: int
    stride: int = 1
    padding: str = "SAME"
    has_bn: bool = False
    relu_after: bool = True       # (BN+)ReLU after this conv
    depthwise: bool = False


@dataclasses.dataclass
class PoolNode:
    name: str
    kind: str                     # "max" | "avg"
    size: int = 2
    stride: int = 2


@dataclasses.dataclass
class Branch:
    name: str
    paths: List[List[Any]]        # parallel sub-sequences
    merge: str                    # "concat" | "add"


def resolved_out_ch(node: ConvNode, in_ch: int) -> int:
    """Depthwise output width follows the input."""
    return in_ch if node.depthwise else node.out_ch


def conv_init(gen: torch.Generator, node: ConvNode, in_ch: int,
              dtype=torch.float32) -> Params:
    """He-normal HWIO weights (and BN scale/bias) drawn from ``gen`` on its
    device."""
    k = node.kernel
    c = 1 if node.depthwise else in_ch
    out_ch = resolved_out_ch(node, in_ch)
    fan_in = k * k * c
    w = torch.randn((k, k, c, out_ch), generator=gen, device=gen.device) \
        * (2.0 / fan_in) ** 0.5
    p: Params = {"w": w.to(dtype)}
    if node.has_bn:
        p["bn_scale"] = torch.ones(out_ch, device=gen.device)
        p["bn_bias"] = torch.zeros(out_ch, device=gen.device)
    return p


def batchnorm(x: torch.Tensor, scale, bias, eps=1e-5) -> torch.Tensor:
    mu = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def apply_conv(p: Params, x_pre: torch.Tensor, node: ConvNode,
               policy: SparsityPolicy, input_is_relu: bool) -> torch.Tensor:
    """x_pre is the producer's PRE-activation if input_is_relu (the fused
    relu_conv consumes it), else the raw input."""
    if node.depthwise:
        if x_pre.is_cuda:
            # On the card every depthwise node runs through the engine: it
            # takes a channel multiplier (w (R,S,1,C·mult)) and raises
            # ValueError on any other group structure.
            face = depthwise_relu_conv if input_is_relu else depthwise_conv
            y = face(x_pre, p["w"], node.stride, node.padding, policy)
        elif p["w"].shape[2] != 1 or x_pre.shape[-1] != p["w"].shape[3]:
            # On CPU tensors, as in the reference: a group structure other
            # than one weight per channel leaves through this counted
            # escape, so a run can assert the sparse path lost no layer.
            stats.record("conv:dense_fallback")
            with stats.lifecycle_scope("fallback", "conv_dense"):
                y = _dense_depthwise(p["w"], x_pre, node, input_is_relu)
        elif input_is_relu:
            y = depthwise_relu_conv(x_pre, p["w"], node.stride,
                                    node.padding, policy)
        else:
            y = depthwise_conv(x_pre, p["w"], node.stride, node.padding,
                               policy)
    elif input_is_relu:
        y = relu_conv(x_pre, p["w"], node.stride, node.padding, policy)
    else:
        y = sconv(x_pre, p["w"], node.stride, node.padding, policy)
    if node.has_bn:
        y = batchnorm(y, p["bn_scale"], p["bn_bias"])
    return y


def _dense_depthwise(w: torch.Tensor, x_pre: torch.Tensor, node: ConvNode,
                     input_is_relu: bool) -> torch.Tensor:
    """Plain grouped conv (groups = C) of NHWC x with HWIO w, with the
    reference's explicit SAME/VALID padding."""
    x = torch.relu(x_pre) if input_is_relu else x_pre
    _, h, wd, c = x.shape
    r, s = w.shape[0], w.shape[1]
    hlo, hhi = _pad_amounts(h, r, node.stride, node.padding)
    wlo, whi = _pad_amounts(wd, s, node.stride, node.padding)
    xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi)).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=node.stride, groups=c)
    return y.permute(0, 2, 3, 1)


def apply_pool(x: torch.Tensor, node: PoolNode) -> torch.Tensor:
    """JAX ``reduce_window`` with "SAME" padding, exactly: explicit -inf
    (max) or 0 (avg) padding on the high/low sides SAME picks, and the avg
    divisor size*size whatever the padding."""
    _, h, w, _ = x.shape
    hlo, hhi = _pad_amounts(h, node.size, node.stride, "SAME")
    wlo, whi = _pad_amounts(w, node.size, node.stride, "SAME")
    fill = float("-inf") if node.kind == "max" else 0.0
    xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=fill)
    nchw = xp.permute(0, 3, 1, 2)
    if node.kind == "max":
        y = F.max_pool2d(nchw, node.size, node.stride)
    else:
        y = F.avg_pool2d(nchw, node.size, node.stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Network definitions
# ---------------------------------------------------------------------------

def vgg16_layers(width: float = 1.0) -> List[Any]:
    def c(n, ch, **kw):
        return ConvNode(n, int(ch * width), 3, **kw)
    return [
        c("conv1", 64), c("conv2", 64), PoolNode("pool1", "max"),
        c("conv3", 128), c("conv4", 128), PoolNode("pool2", "max"),
        c("conv5", 256), c("conv6", 256), c("conv7", 256),
        PoolNode("pool3", "max"),
        c("conv8", 512), c("conv9", 512), c("conv10", 512),
        PoolNode("pool4", "max"),
        c("conv11", 512), c("conv12", 512), c("conv13", 512),
        PoolNode("pool5", "max"),
    ]


def mobilenet_layers(width: float = 1.0) -> List[Any]:
    """Linear dw/pw stack (paper evaluates the pw convs)."""
    out: List[Any] = [ConvNode("conv0", int(32 * width), 3, stride=2,
                               has_bn=True)]
    chans = [64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024]
    strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
    for i, (ch, st) in enumerate(zip(chans, strides)):
        out.append(ConvNode(f"dw{i+1}", 0, 3, stride=st, has_bn=True,
                            depthwise=True))
        out.append(ConvNode(f"pw{i+1}", int(ch * width), 1, has_bn=True))
    return out


def googlenet_inception3b(width: float = 1.0) -> List[Any]:
    """Inception-3b: 4 parallel paths, concat merge, no BN."""
    def w(ch):
        return int(ch * width)
    return [
        ConvNode("pre", w(192), 3, has_bn=False),
        PoolNode("pool1", "max"),
        Branch("incep3b", [
            [ConvNode("conv11", w(64), 1)],
            [ConvNode("conv33r", w(96), 1), ConvNode("conv33", w(128), 3)],
            [ConvNode("conv55r", w(16), 1), ConvNode("conv55", w(32), 5)],
            [PoolNode("bpool", "max", 3, 1), ConvNode("convpp", w(32), 1)],
        ], merge="concat"),
    ]


def resnet18_block2(width: float = 1.0) -> List[Any]:
    """Residual block-2 region: BN nets."""
    def w(ch):
        return int(ch * width)
    return [
        ConvNode("stem", w(64), 3, stride=2, has_bn=True),
        Branch("res1", [
            [ConvNode("b1conv1", w(128), 3, stride=2, has_bn=True),
             ConvNode("b1conv2", w(128), 3, has_bn=True, relu_after=False)],
            [ConvNode("b1skip", w(128), 1, stride=2, has_bn=True,
                      relu_after=False)],
        ], merge="add"),
        Branch("res2", [
            [ConvNode("b2conv1", w(128), 3, has_bn=True),
             ConvNode("b2conv2", w(128), 3, has_bn=True, relu_after=False)],
            [],
        ], merge="add"),
    ]


def densenet_block1(width: float = 1.0, growth: int = 32,
                    reps: int = 6) -> List[Any]:
    """Dense-block-1: concat merges retain sparsity."""
    g = max(8, int(growth * width))
    out: List[Any] = [ConvNode("stem", int(64 * width), 3, stride=2,
                               has_bn=True)]
    for i in range(reps):
        out.append(Branch(f"dense{i+1}", [
            [ConvNode(f"d{i+1}c1", 4 * g, 1, has_bn=True),
             ConvNode(f"d{i+1}c3", g, 3, has_bn=True)],
            [],
        ], merge="concat"))
    return out


NETWORKS: Dict[str, Callable[..., List[Any]]] = {
    "vgg16": vgg16_layers,
    "googlenet": googlenet_inception3b,
    "resnet18": resnet18_block2,
    "densenet121": densenet_block1,
    "mobilenet": mobilenet_layers,
}


# ---------------------------------------------------------------------------
# Build / run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CNNModel:
    name: str
    layers: List[Any]
    num_classes: int
    image_size: int
    in_ch: int = 3

    def init(self, seed: int = 0, *, device="cuda",
             dtype=torch.float32) -> Params:
        """Random parameters drawn on the CPU from a ``torch.Generator``
        seeded with ``seed`` (so every device gets the same values), then
        moved to ``device`` (default CUDA; raises without one unless
        ``device="cpu"``).  Leaves require grad."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params: Params = {}

        def walk(nodes, in_ch):
            for node in nodes:
                if isinstance(node, ConvNode):
                    params[node.name] = conv_init(gen, node, in_ch, dtype)
                    in_ch = resolved_out_ch(node, in_ch)
                elif isinstance(node, Branch):
                    outs = [walk(path, in_ch) for path in node.paths]
                    in_ch = sum(outs) if node.merge == "concat" else outs[0]
            return in_ch

        final_ch = walk(self.layers, self.in_ch)
        w = torch.randn((final_ch, self.num_classes), generator=gen) \
            * final_ch ** -0.5
        params["head"] = {"w": w.to(dtype)}
        return {layer: {k: v.to(dev).requires_grad_(True)
                        for k, v in d.items()}
                for layer, d in params.items()}

    def apply(self, params: Params, images: torch.Tensor,
              policy: SparsityPolicy = DC,
              capture: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
        """images: (N, H, W, C) → logits.  ``capture`` (if a dict) is filled
        with post-ReLU activations per conv layer name."""

        def run(nodes, x, input_is_relu):
            for node in nodes:
                if isinstance(node, ConvNode):
                    with stats.layer_scope(node.name):
                        x = apply_conv(params[node.name], x, node, policy,
                                       input_is_relu)
                    input_is_relu = node.relu_after
                    if capture is not None:
                        capture[node.name] = torch.relu(x) \
                            if node.relu_after else x
                elif isinstance(node, PoolNode):
                    if input_is_relu:
                        x = torch.relu(x)
                        input_is_relu = False
                    x = apply_pool(x, node)
                elif isinstance(node, Branch):
                    if input_is_relu:
                        x = torch.relu(x)
                        input_is_relu = False
                    outs = []
                    for path in node.paths:
                        y, y_relu = run(path, x, False)
                        if y_relu:
                            y = torch.relu(y)
                        outs.append(y)
                    x = torch.cat(outs, -1) if node.merge == "concat" \
                        else functools.reduce(torch.add, outs)
                    if node.merge == "add":
                        if capture is not None:
                            capture[node.name] = torch.relu(x)
                        input_is_relu = True
            return x, input_is_relu

        x, is_relu = run(self.layers, images, False)
        if is_relu:
            x = torch.relu(x)
        x = x.mean(dim=(1, 2))                   # global average pool
        with stats.layer_scope("head"):
            return smatmul(x, params["head"]["w"], policy)

    def loss(self, params: Params, images, labels,
             policy: SparsityPolicy = DC) -> torch.Tensor:
        logits = self.apply(params, images, policy)
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, labels.long()[:, None]).mean()

    # -- cost-model bridge --
    def conv_specs(self, batch: int) -> List[ConvSpec]:
        """Static ConvSpec list at this model's geometry (input_is_relu /
        has_bn flags follow the graph, as the paper's applicability rules)."""
        specs: List[ConvSpec] = []

        def walk(nodes, in_ch, hw, input_is_relu):
            for node in nodes:
                if isinstance(node, ConvNode):
                    out_ch = resolved_out_ch(node, in_ch)
                    specs.append(ConvSpec(
                        name=node.name, c=in_ch, h=hw, w=hw, m=out_ch,
                        r=node.kernel, s=node.kernel, stride=node.stride,
                        groups=in_ch if node.depthwise else 1,
                        has_bn=node.has_bn, input_is_relu=input_is_relu,
                        output_feeds_relu=node.relu_after, batch=batch))
                    in_ch = out_ch
                    hw = -(-hw // node.stride)
                    input_is_relu = node.relu_after
                elif isinstance(node, PoolNode):
                    hw = -(-hw // node.stride)
                    input_is_relu = False
                elif isinstance(node, Branch):
                    outs = []
                    hws = []
                    for path in node.paths:
                        o, h2 = walk(path, in_ch, hw, False)
                        outs.append(o)
                        hws.append(h2)
                    in_ch = sum(outs) if node.merge == "concat" else outs[0]
                    hw = hws[0]
                    input_is_relu = node.merge == "add"
            return in_ch, hw

        walk(self.layers, self.in_ch, self.image_size, False)
        return specs

    def gemm_workload(self, batch: int) -> List[dict]:
        """Per-layer, per-stage GEMM requests this model's training step
        lowers onto ``kernels.ops.sparse_gemm``: one row per (layer, stage
        ∈ {fp, bp_dx, wg}) with the per-group (M, K, N) dims, the group
        count and the layer's full channel counts ``cin``/``cout`` (from
        which ``conv_channel_granularity`` recomputes the engine's bitmap
        granularities)."""
        rows: List[dict] = []
        for s in self.conv_specs(batch):
            g = s.groups
            t_out = batch * s.u * s.v            # output pixels (FP/WG rows)
            t_in = batch * s.h * s.w             # input pixels (dX rows)
            for stage, m, k, n in (
                    ("fp", t_out, s.crs, s.m // g),
                    ("bp_dx", t_in, s.mrs, s.c // g),
                    ("wg", s.crs, t_out, s.m // g)):
                rows.append({"layer": s.name, "stage": stage, "groups": g,
                             "m": m, "k": k, "n": n,
                             "cin": s.c, "cout": s.m})
        return rows


def build_cnn(name: str, *, image_size: int = 32, width: float = 1.0,
              num_classes: int = 100) -> CNNModel:
    layers = copy.deepcopy(NETWORKS[name](width))
    return CNNModel(name=name, layers=layers, num_classes=num_classes,
                    image_size=image_size)


def param_leaves(params: Params) -> Dict[str, torch.Tensor]:
    """Flat ``{"<layer>/<leaf>": tensor}`` view of a param dict."""
    return {f"{layer}/{k}": v for layer, d in params.items()
            for k, v in d.items()}


def params_from_jax(tree, device) -> Params:
    """Carry a JAX param dict (numpy leaves, e.g. ``np.asarray`` of each)
    into the port's parameters on ``device``, as float32 leaves that
    require grad, so that both packages compute the same thing."""
    dev = resolve_device(device)
    return {layer: {k: torch.tensor(np.asarray(v), device=dev)
                    .requires_grad_(True) for k, v in d.items()}
            for layer, d in tree.items()}
