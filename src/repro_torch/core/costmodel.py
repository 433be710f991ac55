"""Analytical cost/energy model of the paper's accelerator (§5, Table 1) —
the port of ``repro.core.costmodel``, a numpy copy kept in this package so
that the port never imports the reference.

The paper evaluates with a cycle-accurate simulator driven by real
activation/gradient traces.  This module is the simulator (analytical,
event-level for the WDU); ``repro_torch.benchmarks`` feeds it traces
captured from the port's own training steps of the same five CNNs.  Every
number it returns is a MODELED count for the paper's accelerator (Table 1,
667 MHz), never a time measured on the device the traces came from.

Hardware constants are the paper's Table 1 node: 256 PEs × 16 lanes at
667 MHz (4096 MACs/cycle = 8192 FLOPs/cycle ⇒ 5.46 TFLOP/s), 32 KB×4 SRAM
banks/PE (32 MB total), 16-ch DDR3-1600, H-tree broadcast @ 512 GB/s.

Modeled effects, mapped to paper sections:
  * element-granular skipping of FP-IN / BP-IN / BP-OUT / WG-IN  (§3)
  * lane occupancy for receptive fields CRS vs the 1024-entry PE capacity,
    with none / direct (power-of-2 replication) / hierarchical
    reconfiguration of the adder tree                            (§4.5)
  * synapse blocking for CRS > 1024 (K-blocking ceil waste)      (§4.4)
  * spatial load imbalance across the 16×16 PE-tile grid and the WDU
    redistribution policy (via core.workredist)                  (§4.6)
  * DRAM streaming overlap (compute/memory max, §6 "DRAM considerations")
  * energy: MAC + SRAM access + static node power × makespan
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from . import workredist


# ---------------------------------------------------------------------------
# Hardware description (paper Table 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HwConfig:
    tx: int = 16
    ty: int = 16
    lanes_per_pe: int = 16
    entries_per_lane_group: int = 32
    groups: int = 2
    freq_hz: float = 667e6
    bytes_per_value: int = 2                      # fp16/bf16
    dram_bw_bytes: float = 16 * 12.6e9            # 16× DDR3-1600
    e_mac_j: float = 10.56e-3 / (16 * 667e6)      # MAC block power / (units·f)
    e_sram_rd_j: float = 0.035e-9
    e_sram_wr_j: float = 0.040e-9
    node_power_w: float = 19.2

    @property
    def n_pes(self) -> int:
        return self.tx * self.ty

    @property
    def macs_per_cycle(self) -> int:
        return self.n_pes * self.lanes_per_pe

    @property
    def pe_capacity(self) -> int:                 # receptive-field entries/PE
        return self.lanes_per_pe * self.entries_per_lane_group * self.groups

    @property
    def peak_flops(self) -> float:
        return 2.0 * self.macs_per_cycle * self.freq_hz


DEFAULT_HW = HwConfig()


# ---------------------------------------------------------------------------
# Layer & trace description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One CONV (or FC, with H=W=U=V=1, R=S=1) layer's static shape.

    ``groups`` models grouped/depthwise convs (groups == c for depthwise):
    every output channel contracts over a C/G·R·S receptive field and every
    input channel receives from M/G·R·S weights, so all three phases' MAC
    counts — and the lane-occupancy receptive field ``crs`` — shrink by G.
    MobileNet's dw layers are thereby *modeled* rather than approximated as
    full convs (which overcounted their work C-fold)."""
    name: str
    c: int
    h: int
    w: int
    m: int
    r: int
    s: int
    stride: int = 1
    groups: int = 1
    has_bn: bool = False          # BN between this CONV and its ReLU
    input_is_relu: bool = True    # producer of our input is a ReLU (enables
                                  # FP-IN and BP-OUT sparsity)
    output_feeds_relu: bool = True  # our output goes through (BN+)ReLU
    batch: int = 16

    @property
    def u(self) -> int:
        return max(1, math.ceil(self.h / self.stride))

    @property
    def v(self) -> int:
        return max(1, math.ceil(self.w / self.stride))

    @property
    def crs(self) -> int:
        """Per-output receptive field: C/G·R·S (the PE lane-packing unit)."""
        return self.c * self.r * self.s // self.groups

    @property
    def mrs(self) -> int:
        """Per-input BP receptive field: M/G·R·S."""
        return self.m * self.r * self.s // self.groups

    def macs_fp(self) -> float:
        return float(self.batch * self.m * self.u * self.v * self.crs)

    def macs_bp(self) -> float:   # dX: [M,U,V] -> [C,H,W] through RS×M/G
        return float(self.batch * self.c * self.h * self.w * self.mrs)

    def macs_wg(self) -> float:   # dW: M·(C/G)·R·S outputs × U·V·batch accum
        return float(self.batch * self.m * self.crs * self.u * self.v)


@dataclasses.dataclass
class LayerTrace:
    """Measured densities (1 - sparsity) from real tensors, plus the spatial
    active-output maps used for tile-imbalance modeling.

    density ∈ [0, 1]; None ⇒ dense (1.0)."""
    x_density: float = 1.0            # input activation density (post-ReLU)
    g_in_density: float = 1.0         # incoming gradient density in BP
    out_mask_density: float = 1.0     # density of σ'(input) — BP-OUT skip list
    fp_active_map: Optional[np.ndarray] = None   # (U, V) active outputs FP
    bp_active_map: Optional[np.ndarray] = None   # (H, W) active outputs BP


# ---------------------------------------------------------------------------
# Lane-occupancy models (§4.4, §4.5 / Fig. 16)
# ---------------------------------------------------------------------------

def lane_utilization(crs: int, hw: HwConfig, mode: str = "hierarchical") -> float:
    """Fraction of MAC lanes doing useful work for receptive-field size CRS.

    mode ∈ {"none", "direct", "hierarchical"}:
      none         — one output at a time, occupying ceil(CRS/32) lanes
      direct       — replicate to the nearest power-of-2 lane count
      hierarchical — recursive alignment: near-full packing (paper §4.5)
    """
    cap = hw.pe_capacity  # 1024
    if crs >= cap:
        # §4.4 synapse blocking: ceil waste on the last K-block only.
        return crs / (math.ceil(crs / cap) * cap)
    # lane capacity spans both double-buffer groups (paper: 3x3x64=576
    # occupies 9/16 lanes ⇒ 64 entries per lane)
    entries = hw.entries_per_lane_group * hw.groups
    occ = math.ceil(crs / entries)              # lanes needed per output
    lanes = hw.lanes_per_pe
    if mode == "none":
        return occ / lanes * (crs / (occ * entries))
    if mode == "direct":
        aligned = 1 << math.ceil(math.log2(occ)) if occ > 1 else 1
        outputs = lanes // aligned
        return (occ * outputs) / lanes * (crs / (occ * entries))
    # hierarchical: schedule the binary decomposition of occ across
    # iterations; residual misalignment is one partial lane-group.
    packing = 0.98
    return packing * (crs / (occ * entries)) if occ * entries > 0 else packing


# ---------------------------------------------------------------------------
# Per-layer, per-phase cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseCost:
    macs_dense: float
    macs_effective: float
    compute_cycles: float
    dram_bytes: float
    mem_cycles: float
    cycles: float                 # max(compute, mem) — streaming overlap
    energy_j: float
    wdu: Optional[workredist.WDUResult] = None

    @property
    def time_s(self) -> float:
        return self.cycles / DEFAULT_HW.freq_hz


def _phase_cost(
    macs_dense: float,
    density_product: float,
    crs: int,
    dram_bytes: float,
    hw: HwConfig,
    *,
    tile_work: Optional[np.ndarray] = None,
    work_redistribution: bool = False,
    reconfig_mode: str = "hierarchical",
) -> PhaseCost:
    macs_eff = macs_dense * density_product
    util = lane_utilization(crs, hw, reconfig_mode)
    util = max(util, 1e-3)
    ideal_cycles = macs_eff / (hw.macs_per_cycle * util)
    wdu = None
    if tile_work is not None and tile_work.sum() > 0:
        # tile_work is in MACs; scale to the same effective density and
        # per-PE throughput (lanes × util MACs/cycle).
        scale = macs_eff / max(tile_work.sum(), 1e-9)
        per_tile_cycles = tile_work * scale / (hw.lanes_per_pe * util)
        wdu = workredist.simulate(per_tile_cycles, redistribute=work_redistribution)
        compute_cycles = wdu.makespan
    else:
        compute_cycles = ideal_cycles
    mem_cycles = dram_bytes / hw.dram_bw_bytes * hw.freq_hz
    cycles = max(compute_cycles, mem_cycles)
    # energy: 2 SRAM reads (neuron+synapse) + amortized writes per MAC
    e = (
        macs_eff * (hw.e_mac_j + 2 * hw.e_sram_rd_j + 0.1 * hw.e_sram_wr_j)
        + hw.node_power_w * 0.3 * (cycles / hw.freq_hz)  # static fraction
    )
    return PhaseCost(
        macs_dense=macs_dense,
        macs_effective=macs_eff,
        compute_cycles=compute_cycles,
        dram_bytes=dram_bytes,
        mem_cycles=mem_cycles,
        cycles=cycles,
        energy_j=e,
        wdu=wdu,
    )


@dataclasses.dataclass
class LayerCost:
    fp: PhaseCost
    bp: PhaseCost
    wg: PhaseCost

    @property
    def total_cycles(self) -> float:
        return self.fp.cycles + self.bp.cycles + self.wg.cycles

    @property
    def total_energy(self) -> float:
        return self.fp.energy_j + self.bp.energy_j + self.wg.energy_j


def layer_cost(
    spec: ConvSpec,
    trace: LayerTrace,
    scenario: str,
    hw: HwConfig = DEFAULT_HW,
    reconfig_mode: str = "hierarchical",
) -> LayerCost:
    """Cost one CONV layer under a paper scenario: DC | IN | IN_OUT | IN_OUT_WR.

    Sparsity applicability rules (paper §2.1, §6):
      FP-IN  : input density counts iff the input is post-ReLU.
      BP-IN  : incoming gradient density counts iff OUR ReLU's gradient is
               not re-densified before reaching the GEMM — i.e. no BN
               between this CONV and its ReLU.  (trace.g_in_density already
               measures the tensor that actually arrives.)
      BP-OUT : σ'(input) density iff the producer of our input is a ReLU
               (not pool/input/concat-of-dense).
      WG-IN  : x density × gradient density.
    """
    assert scenario in ("DC", "IN", "IN_OUT", "IN_OUT_WR"), scenario
    use_in = scenario in ("IN", "IN_OUT", "IN_OUT_WR")
    use_out = scenario in ("IN_OUT", "IN_OUT_WR")
    use_wr = scenario == "IN_OUT_WR"

    x_d = trace.x_density if (use_in and spec.input_is_relu) else 1.0
    g_d = trace.g_in_density if use_in else 1.0
    o_d = trace.out_mask_density if (use_out and spec.input_is_relu) else 1.0

    bpv = hw.bytes_per_value
    w_bytes = spec.m * spec.crs * bpv
    fp_bytes = w_bytes + spec.batch * (spec.c * spec.h * spec.w +
                                       spec.m * spec.u * spec.v) * bpv
    bp_bytes = w_bytes + spec.batch * (spec.m * spec.u * spec.v +
                                       spec.c * spec.h * spec.w) * bpv
    wg_bytes = fp_bytes

    # Tile-imbalance only exists when skipping is on: under DC every tile
    # does identical dense work.  The maps encode per-output-location
    # relative work (nnz-driven), measured from real traces.
    tile_fp = tile_bp = None
    if trace.fp_active_map is not None and use_in and spec.input_is_relu:
        tile_fp = workredist.tile_work_from_mask(
            trace.fp_active_map, hw.tx, hw.ty, spec.crs * x_d)
    if trace.bp_active_map is not None and use_out and spec.input_is_relu:
        tile_bp = workredist.tile_work_from_mask(
            trace.bp_active_map, hw.tx, hw.ty, spec.mrs * g_d)

    fp = _phase_cost(spec.macs_fp(), x_d, spec.crs, fp_bytes, hw,
                     tile_work=tile_fp, work_redistribution=use_wr,
                     reconfig_mode=reconfig_mode)
    bp = _phase_cost(spec.macs_bp(), g_d * o_d, spec.mrs,
                     bp_bytes, hw, tile_work=tile_bp,
                     work_redistribution=use_wr, reconfig_mode=reconfig_mode)
    wg = _phase_cost(spec.macs_wg(), x_d * g_d, spec.u * spec.v * spec.batch,
                     wg_bytes, hw, work_redistribution=use_wr,
                     reconfig_mode=reconfig_mode)
    return LayerCost(fp=fp, bp=bp, wg=wg)


def network_cost(
    layers: List[ConvSpec],
    traces: List[LayerTrace],
    scenario: str,
    hw: HwConfig = DEFAULT_HW,
) -> Dict[str, float]:
    costs = [layer_cost(s, t, scenario, hw) for s, t in zip(layers, traces)]
    return {
        "fp_cycles": sum(c.fp.cycles for c in costs),
        "bp_cycles": sum(c.bp.cycles for c in costs),
        "wg_cycles": sum(c.wg.cycles for c in costs),
        "total_cycles": sum(c.total_cycles for c in costs),
        "total_energy_j": sum(c.total_energy for c in costs),
        "iteration_ms": sum(c.total_cycles for c in costs) / hw.freq_hz * 1e3,
    }
