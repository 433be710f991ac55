"""Collective bytes and roofline terms — the counterpart of
``repro.launch.hlo_analysis`` (the name kept so that a reader finds it).

The port runs eagerly and has no HLO.  Each number here names what it is
read from instead:

  * ``collective_bytes`` reads a ``torch.profiler`` trace taken with
    ``record_shapes=True``: one event per collective of the process-group
    backend (``gloo:all_reduce``, ``nccl:all_reduce``, ...), its tensor
    arguments' shapes and dtypes.  Bytes are output-shape bytes, as in the
    reference: an all-reduce's payload once (what
    ``sharding.collectives.wire_bytes`` counts), an all-gather's input
    times the group, a reduce-scatter's input over the group.
  * ``roofline_terms`` takes per-device FLOPs and bytes from the analytic
    model (``launch.flops.analytic_cost``) or from a count of the step's
    matmuls on meta tensors (``torch.utils.flop_counter.FlopCounterMode``,
    ``launch.dryrun``), and bytes of partition specs from
    ``launch.dryrun``; its peaks are the H100's published ones.
  * ``model_flops`` and ``active_param_count`` read the config and a param
    tree of meta tensors (``lm_init(..., device="meta")``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Optional

from repro_torch import tree as _tree

# --- hardware constants: one NVIDIA H100 SXM (published data sheet, dense
# rates, at its 700 W power limit) ---
PEAK_FLOPS = {
    "bfloat16": 989e12,      # tensor cores
    "float16": 989e12,
    "tf32": 495e12,          # f32 GEMMs on the tensor cores (allow_tf32)
    "float32": 67e12,        # outside the tensor cores
}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way
HBM_BYTES = 80e9             # device memory

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# A backend's event name (``gloo:all_reduce``, ``nccl:_all_gather_base``,
# ``nccl:all_reduce_coalesced``, ...) → the reference's category.
_EVENT_RE = re.compile(r"^(?:gloo|nccl):_*([a-z_]+?)"
                       r"(?:_base|_coalesced|_into_tensor|_tensor)*$")
_CATEGORY = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
             "all_gather": "all-gather", "allgather": "all-gather",
             "reduce_scatter": "reduce-scatter",
             "all_to_all": "all-to-all", "alltoall": "all-to-all",
             "send": "collective-permute"}

# c10 scalar type names as the profiler records them → bytes.
_DTYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "int": 4, "long int": 8, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1, "c10::complex<float>": 8,
}


def peak_flops(dtype: str = "bfloat16") -> float:
    """The H100's peak FLOP/s for GEMMs computing in ``dtype``.  A float32
    path runs on the tensor cores only with TF32 on, as this process sets
    ``torch.backends.cuda.matmul.allow_tf32``."""
    if dtype == "float32":
        import torch
        tf32 = torch.backends.cuda.matmul.allow_tf32
        return PEAK_FLOPS["tf32" if tf32 else "float32"]
    return PEAK_FLOPS[dtype]


def _category(name: str) -> Optional[str]:
    m = _EVENT_RE.match(name)
    return _CATEGORY.get(m.group(1)) if m else None


def trace_events(prof) -> list:
    """The op events of a finished ``torch.profiler.profile``, each with
    ``name()``, ``shapes()`` and ``dtypes()`` of its inputs (the
    profiler's own records: ``prof.events()`` carries dtypes only from
    PyTorch 2.13 on)."""
    return list(prof.profiler.kineto_results.events())


def collective_bytes(events: Iterable, group_size: int = 1
                     ) -> Dict[str, int]:
    """Per-process bytes by collective category (output-shape accounting)
    from profiler events (``trace_events(prof)``, or anything with
    ``name()``, ``shapes()`` and ``dtypes()``).  ``group_size`` is the
    ranks of the group the all-gathers and reduce-scatters ran over.
    Events of another kind (the ``c10d::`` dispatcher ops that wrap each
    backend event, barriers, receives, the kernels, a backend event's
    device-side record, which carries no tensor) are not counted."""
    out = {c: 0 for c in _COLLECTIVES}
    out["count"] = 0
    for ev in events:
        cat = _category(ev.name())
        if cat is None:
            continue
        tensors = [(shape, dtype) for shape, dtype
                   in zip(ev.shapes(), ev.dtypes())
                   if dtype in _DTYPE_BYTES and isinstance(shape, list)]
        if not tensors:         # the device-side record of a launch
            continue
        n = sum(math.prod(shape) * _DTYPE_BYTES[dtype]
                for shape, dtype in tensors)
        if cat == "all-gather":
            n *= group_size
        elif cat == "reduce-scatter":
            n //= group_size
        out[cat] += n
        out["count"] += 1
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: Optional[float] = None
    peak_flops: float = PEAK_FLOPS["bfloat16"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def useful_flop_fraction(self, n_chips: int) -> Optional[float]:
        """MODEL_FLOPS / executed FLOPs — how much of the work is useful."""
        if not self.model_flops_total:
            return None
        return self.model_flops_total / (self.hlo_flops_per_device * n_chips)

    def roofline_fraction(self, n_chips: int) -> Optional[float]:
        """useful FLOPs / (chips × peak × bound-time), the peak of the
        path's dtype (the one ``compute_s`` divides by)."""
        if not self.model_flops_total or self.bound_s <= 0:
            return None
        return self.model_flops_total / (n_chips * self.peak_flops
                                         * self.bound_s)


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   coll_bytes: float, model_flops: Optional[float] = None,
                   dtype: str = "bfloat16") -> Roofline:
    """All inputs are PER-DEVICE; model_flops is global.  ``dtype`` is the
    one the path's GEMMs compute in (``peak_flops``)."""
    peak = peak_flops(dtype)
    return Roofline(
        compute_s=hlo_flops / peak,
        memory_s=hlo_bytes / HBM_BW,
        collective_s=coll_bytes / NVLINK_BW,
        hlo_flops_per_device=hlo_flops,
        hlo_bytes_per_device=hlo_bytes,
        collective_bytes_per_device=coll_bytes,
        model_flops_total=model_flops,
        peak_flops=peak,
    )


def model_flops(cfg, shape, n_active_params: float) -> float:
    """MODEL_FLOPS: 6·N·D (train) — N = active params.

    prefill: 2·N·D; decode: 2·N·(batch tokens per step)."""
    if shape.kind == "train":
        return 6.0 * n_active_params * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active_params * shape.seq_len * shape.global_batch
    return 2.0 * n_active_params * shape.global_batch


def active_param_count(params_shapes, cfg) -> float:
    """Total params, with MoE expert tensors scaled by top_k/n_experts
    (``params_shapes``: any tree of tensors; meta tensors will do)."""
    total = 0.0
    moe = getattr(cfg, "moe", None)
    for path, leaf in _tree.leaves_with_paths(params_shapes):
        n = float(math.prod(leaf.shape))
        if moe is not None and re.search(r"moe.*w_(gate|up|down)", path):
            n *= moe.top_k / moe.n_experts
        total += n
    return total
