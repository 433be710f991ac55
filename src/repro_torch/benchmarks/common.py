"""Shared benchmark machinery: trace capture → cost-model inputs (the port of
the reference's ``benchmarks/common.py``).

Methodology (paper §5): train a CNN for a few steps on the synthetic
zero-mean image stream, capture per-layer post-ReLU activations and derive
the cost-model densities:

  x_density        = measured nonzero fraction of the layer's input act
  out_mask_density = the same tensor's mask density (σ′ footprint —
                     identical by the paper's §3.2 theorem)
  g_in_density     = measured output-act density if the output feeds a
                     ReLU with NO BatchNorm in between, else 1.0 (BN
                     re-densifies gradients — Fig. 3c rule)

A ``Capture`` says how the traces are taken: its defaults are the
reference's CPU geometry (3 dense ``DC`` steps at 32², width 0.25, 100
classes, batch 8, lr 0.05); ``GEOMETRIES["full"]`` is the paper's own
(224², width 1.0, 1000 classes) under ``IN_OUT_WR`` through the kernels,
at lr 0.01.  Whatever the capture, the cost model is evaluated at the
paper's full ImageNet geometry (224², width 1.0, batch ``BATCH``), with
spatial work maps resampled from the captured masks.  Its outputs are
modeled cycle counts of the paper's accelerator, not times on the device
the traces were captured on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.cnn_training import train_steps
from repro_torch.core import costmodel as cm
from repro_torch.core.policy import SCENARIOS
from repro_torch.core.sparsity import element_sparsity
from repro_torch.data.pipeline import image_batch
from repro_torch.device import resolve_device
from repro_torch.models.cnn import build_cnn

BATCH = 16


@dataclasses.dataclass(frozen=True)
class Capture:
    """How traces are captured: ``train_steps`` SGD steps at ``lr`` under
    ``policy`` (a ``SCENARIOS`` name) with ``kernel_impl``, on ``device``,
    at the model geometry given, from ``model.init(0)`` and the batches of
    ``image_batch(0, step)``; then one forward (same policy) of the next
    batch captures the activations."""
    train_steps: int = 3
    image_size: int = 32
    width: float = 0.25
    num_classes: int = 100
    batch: int = 8
    lr: float = 0.05
    policy: str = "DC"
    kernel_impl: str = "xla_ref"
    device: str = "cuda"


GEOMETRIES = {
    "reference": Capture(),
    "full": Capture(image_size=224, width=1.0, num_classes=1000, lr=0.01,
                    policy="IN_OUT_WR", kernel_impl="pallas"),
}


class CaptureRun(NamedTuple):
    acts: Dict[str, np.ndarray]      # post-ReLU activation per conv layer
    dens: Dict[str, float]           # its nonzero fraction
    steps: List[dict]                # the training steps' records


_RUNS: Dict[Tuple[str, Capture], CaptureRun] = {}


def capture_run(name: str, cap: Capture = Capture(), *,
                params: Optional[dict] = None) -> CaptureRun:
    """Train and capture as ``cap`` says; runs on ``cap.device`` (CUDA by
    default: raises without one).  Cached per (name, cap) unless starting
    ``params`` are given (they are copied, never updated in place)."""
    key = (name, cap)
    if params is None and key in _RUNS:
        return _RUNS[key]
    dev = resolve_device(cap.device)
    if params is not None:
        params = {layer: {k: v.detach().to(dev).clone().requires_grad_(True)
                          for k, v in leaves.items()}
                  for layer, leaves in params.items()}
    run = train_steps(net=name, steps=cap.train_steps,
                      image_size=cap.image_size, width=cap.width,
                      num_classes=cap.num_classes, batch=cap.batch,
                      policy=cap.policy, kernel_impl=cap.kernel_impl,
                      lr=cap.lr, device=dev, params=params)
    model = run["model"]
    img, _ = image_batch(0, cap.train_steps, batch=cap.batch,
                         image_size=cap.image_size,
                         num_classes=cap.num_classes, device=dev)
    pol = SCENARIOS[cap.policy].with_(kernel_impl=cap.kernel_impl)
    cap_t: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        model.apply(run["params"], img, pol, capture=cap_t)
    out = CaptureRun(
        acts={k: v.cpu().numpy() for k, v in cap_t.items()},
        dens={k: 1.0 - float(element_sparsity(v)) for k, v in cap_t.items()},
        steps=run["steps"])
    if params is None:
        _RUNS[key] = out
    return out


def capture_traces(name: str, cap: Capture = Capture(), *,
                   params: Optional[dict] = None
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """(captured acts, per-layer density) after ``cap.train_steps`` steps."""
    run = capture_run(name, cap, params=params)
    return run.acts, run.dens


def clear_captures() -> None:
    """Drop every cached capture (they hold host copies of activations)."""
    _RUNS.clear()


def _resample_map(m: np.ndarray, target: int) -> np.ndarray:
    """Work-map resample.  Downsampling uses nearest-neighbour; when the
    full geometry is LARGER than the captured one the captured resolution
    is kept — upsampling would tile constant blocks into the 16×16 PE grid
    and fabricate spatial imbalance the real 224² maps don't have."""
    h, w = m.shape
    if target >= h:
        return m
    yi = (np.arange(target) * h // target).clip(0, h - 1)
    xi = (np.arange(target) * w // target).clip(0, w - 1)
    return m[np.ix_(yi, xi)]


def build_cost_inputs(name: str, cap: Capture = Capture(), *,
                      batch: int = BATCH
                      ) -> Tuple[List[cm.ConvSpec], List[cm.LayerTrace]]:
    """Full-geometry ConvSpecs + traces with measured densities."""
    acts, dens = capture_traces(name, cap)
    full = build_cnn(name, image_size=224, width=1.0, num_classes=1000)
    specs = full.conv_specs(batch=batch)

    # walk specs in order; the producer of spec i's input is spec i-1 (for
    # sequential nets) — x_density keyed by the previous captured layer.
    traces: List[cm.LayerTrace] = []
    prev_name = None
    for s in specs:
        x_d = dens.get(prev_name, 1.0) if s.input_is_relu else 1.0
        own_d = dens.get(s.name, 0.5)
        g_in = own_d if (s.output_feeds_relu and not s.has_bn) else 1.0
        # spatial BP work map from the input activation mask
        bp_map = None
        if prev_name in acts and s.input_is_relu:
            a = acts[prev_name]
            nz = (a[0] != 0).sum(axis=-1).astype(np.float64)  # (H, W)
            bp_map = _resample_map(nz, s.h)
        fp_map = None
        if prev_name in acts:
            a = acts[prev_name]
            nz = (a[0] != 0).sum(axis=-1).astype(np.float64)
            fp_map = _resample_map(nz, s.u)
        traces.append(cm.LayerTrace(
            x_density=x_d, g_in_density=g_in, out_mask_density=x_d,
            fp_active_map=fp_map, bp_active_map=bp_map))
        prev_name = s.name
    return specs, traces


def layer_speedups(name: str, cap: Capture = Capture(),
                   scenarios=("DC", "IN", "IN_OUT", "IN_OUT_WR"),
                   phase: str = "bp") -> Dict[str, List[float]]:
    """Per-layer modeled speedup of each scenario over DC for ``phase``."""
    specs, traces = build_cost_inputs(name, cap)
    out: Dict[str, List[float]] = {s: [] for s in scenarios}
    out["layer"] = [s.name for s in specs]
    for spec, trace in zip(specs, traces):
        base = getattr(cm.layer_cost(spec, trace, "DC"), phase).cycles
        for sc in scenarios:
            c = getattr(cm.layer_cost(spec, trace, sc), phase).cycles
            out[sc].append(base / c if c > 0 else 1.0)
    return out


def network_totals(name: str, cap: Capture = Capture()
                   ) -> Dict[str, Dict[str, float]]:
    """Modeled network totals (cycles, energy, iteration ms at 667 MHz)
    under each scenario."""
    specs, traces = build_cost_inputs(name, cap)
    return {sc: cm.network_cost(specs, traces, sc)
            for sc in ("DC", "IN", "IN_OUT", "IN_OUT_WR")}
