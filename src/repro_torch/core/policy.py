"""Execution policies — the paper's evaluation scenarios as config (the port
of ``repro.core.policy``).

DC          dense compute (sparsity-agnostic baseline)
IN          input sparsity only
IN_OUT      input + output sparsity (the paper's contribution)
IN_OUT_WR   + work redistribution (the compacted work-queue schedule)

``kernel_impl`` selects how the skipping executes: ``"pallas"`` — the
hand-written kernels (the name is kept from the reference so policies read
the same in both packages); ``"xla_ref"`` — the numerically identical dense
schedule in plain torch.

``SparsityPolicy.gemm_spec(...)`` is the ONE policy→kernel resolution point:
statically, then through the autotune cache (``autotune=True``) or clamped
to the key's quarantine level (``autotune=False``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import stats as _stats
from repro_torch.kernels.ops import GemmSpec
from repro_torch.kernels.shapes import ceil_to


@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    use_input_sparsity_fp: bool = False   # FP: skip zero activation operands
    use_input_sparsity_bp: bool = False   # BP: skip zero gradient operands
    use_output_sparsity: bool = False     # BP: skip outputs the ReLU mask kills
    work_redistribution: bool = False     # compacted work-queue schedule
    queue_builder: Literal["prefix_sum", "argsort"] = "prefix_sum"
    block: Tuple[int, int, int] = (128, 128, 128)
    grouped_block: Optional[Tuple[int, int, int]] = None
    grouped_sparsity_min_k: int = 1       # per-group K below which grouped
                                          # GEMMs drop their operand masks
    kernel_impl: Literal["pallas", "xla_ref"] = "xla_ref"
    fuse_epilogue: bool = True            # False: σ′ as a separate pass
                                          # after the GEMM (ablation)
    scan_signed_inputs: bool = False      # FP: opt-in bitmap_scan of signed
                                          # raw inputs (no ReLU to fuse into)
    autotune: bool = False                # measured-stats schedule/tile
                                          # selection through the
                                          # kernels/autotune cache; the
                                          # static choice is its default

    def __post_init__(self):
        if self.kernel_impl not in ("pallas", "xla_ref"):
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}")

    @property
    def any_sparsity(self) -> bool:
        return (
            self.use_input_sparsity_fp
            or self.use_input_sparsity_bp
            or self.use_output_sparsity
        )

    def with_(self, **kw) -> "SparsityPolicy":
        return dataclasses.replace(self, **kw)

    def gemm_spec(
        self,
        *,
        groups: int = 1,
        dims: Optional[Tuple[int, int, int]] = None,
        grans: Tuple[int, int, int] = (1, 1, 1),
    ) -> GemmSpec:
        """Policy → ``kernels.ops.GemmSpec`` resolution, in ONE place.

        With ``dims`` the tile is the degenerate ``grouped_gemm_block``
        shape, else the policy's ``block``.  ``kernel_impl != "pallas"`` ⇒
        "dense", ``work_redistribution`` ⇒ "compact", else "predicated".
        With ``autotune=True`` that static resolution is the DEFAULT and
        the ``kernels/autotune`` cache may retarget the schedule (and, with
        ``dims``, the tile edges) from measured live-tile stats; without
        it the spec is clamped to its key's quarantine level, so a demoted
        spec stays demoted on both paths.  A recomputed forward
        (``cfg.remat``) takes the spec its first forward resolved, and
        resolves nothing again."""
        block = grouped_gemm_block(self, dims, grans) \
            if dims is not None else self.block
        if self.kernel_impl != "pallas":
            schedule = "dense"
        elif self.work_redistribution:
            schedule = "compact"
        else:
            schedule = "predicated"
        spec = GemmSpec(
            block=block,
            groups=groups,
            schedule=schedule,
            queue_builder=self.queue_builder,
            origin="policy",
        )
        if self.autotune:
            # resolve() applies the quarantine clamp inside the cache.
            return _stats.replayed_call(lambda: _autotune.resolve(
                spec, dims=dims, grans=grans))
        return _stats.replayed_call(lambda: _autotune.apply_quarantine(
            spec, dims=dims))


def grouped_gemm_block(
    policy: SparsityPolicy,
    dims: Tuple[int, int, int],
    grans: Tuple[int, int, int] = (1, 1, 1),
) -> Tuple[int, int, int]:
    """Degenerate tile selection for one per-group GEMM: each nominal edge
    shrinks to the granularity-rounded dimension and stays a multiple of
    the granularity."""
    nominal = policy.grouped_block or policy.block
    out = []
    for b, d, g in zip(nominal, dims, grans):
        e = min(b, ceil_to(d, g))
        e = max(g, ceil_to(e, g))
        out.append(e)
    return tuple(out)


DC = SparsityPolicy()
IN = SparsityPolicy(use_input_sparsity_fp=True, use_input_sparsity_bp=True)
OUT = SparsityPolicy(use_output_sparsity=True)
IN_OUT = SparsityPolicy(
    use_input_sparsity_fp=True,
    use_input_sparsity_bp=True,
    use_output_sparsity=True,
)
IN_OUT_WR = IN_OUT.with_(work_redistribution=True)

SCENARIOS = {"DC": DC, "IN": IN, "OUT": OUT, "IN_OUT": IN_OUT,
             "IN_OUT_WR": IN_OUT_WR}
