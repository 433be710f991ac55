"""One function per paper figure/table — the port of the reference's
``benchmarks/figures.py``.

Each ``fig*/table*`` function takes the ``Capture`` its traces come from
and returns (rows, derived): rows is a list of CSV-able dicts, derived a
one-line summary printed by ``run.py``.  Every cycle count, speedup and
``iteration_ms`` here is MODELED for the paper's accelerator (Table 1,
667 MHz) from the captured traces, never a time on the capturing device.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import workredist as wr

from .common import (Capture, build_cost_inputs, capture_traces,
                     layer_speedups, network_totals)

NETS = ("vgg16", "googlenet", "resnet18", "densenet121", "mobilenet")


# ---------------------------------------------------------------------------
# Fig. 3d — min/avg/max sparsity per network across a batch
# ---------------------------------------------------------------------------

def fig03_sparsity(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    rows = []
    for net in NETS:
        acts, _ = capture_traces(net, cap)
        per_sample = []
        for a in acts.values():
            sp = (a == 0).mean(axis=tuple(range(1, a.ndim)))   # per sample
            per_sample.append(sp)
        sp = np.stack(per_sample)                              # (layers, B)
        rows.append({
            "network": net,
            "min_sparsity": round(float(sp.mean(axis=0).min()), 4),
            "avg_sparsity": round(float(sp.mean()), 4),
            "max_sparsity": round(float(sp.mean(axis=0).max()), 4),
        })
    avg = np.mean([r["avg_sparsity"] for r in rows])
    return rows, f"avg_sparsity={avg:.3f} (paper reports 0.30-0.70)"


# ---------------------------------------------------------------------------
# Fig. 11a — VGG16 layer-wise BP speedups
# ---------------------------------------------------------------------------

def fig11_vgg(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    sp = layer_speedups("vgg16", cap, phase="bp")
    rows = [{"layer": l,
             "IN": round(sp["IN"][i], 3),
             "IN_OUT": round(sp["IN_OUT"][i], 3),
             "IN_OUT_WR": round(sp["IN_OUT_WR"][i], 3)}
            for i, l in enumerate(sp["layer"])]
    mx = max(sp["IN_OUT_WR"])
    mn = min(sp["IN_OUT_WR"])
    return rows, f"layer_speedup={mn:.2f}x..{mx:.2f}x (paper: 1.46x..7.61x)"


# ---------------------------------------------------------------------------
# Fig. 11b — GoogLeNet Inception-3b
# ---------------------------------------------------------------------------

def fig11_googlenet(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    sp = layer_speedups("googlenet", cap, phase="bp")
    rows = [{"layer": l,
             "IN": round(sp["IN"][i], 3),
             "IN_OUT": round(sp["IN_OUT"][i], 3),
             "IN_OUT_WR": round(sp["IN_OUT_WR"][i], 3)}
            for i, l in enumerate(sp["layer"])]
    return rows, (f"block_speedup={min(sp['IN_OUT_WR']):.2f}x.."
                  f"{max(sp['IN_OUT_WR']):.2f}x (paper: 2.6x..12.6x)")


# ---------------------------------------------------------------------------
# Fig. 12a/b — DenseNet block1 / MobileNet pointwise convs
# ---------------------------------------------------------------------------

def fig12_densenet(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    sp = layer_speedups("densenet121", cap, phase="bp")
    rows = [{"layer": l, "IN_OUT_WR": round(sp["IN_OUT_WR"][i], 3)}
            for i, l in enumerate(sp["layer"])]
    return rows, (f"speedup={min(sp['IN_OUT_WR']):.2f}x.."
                  f"{max(sp['IN_OUT_WR']):.2f}x (paper: 1.69x..3.32x)")


def fig12_mobilenet(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    """MobileNet layer speedups — traces now captured through the sparse
    depthwise lowering, and the dw layers are modeled as grouped convs
    (ConvSpec.groups == C) rather than approximated as full convs, so they
    get their own rows next to the paper's pw bars."""
    sp = layer_speedups("mobilenet", cap, phase="bp")
    rows = [{"layer": l, "kind": "dw" if l.startswith("dw") else "pw",
             "IN_OUT_WR": round(sp["IN_OUT_WR"][i], 3)}
            for i, l in enumerate(sp["layer"])
            if l.startswith(("pw", "dw"))]
    pw = [r["IN_OUT_WR"] for r in rows if r["kind"] == "pw"]
    dw = [r["IN_OUT_WR"] for r in rows if r["kind"] == "dw"]
    return rows, (f"pw_speedup={min(pw):.2f}x..{max(pw):.2f}x "
                  f"(paper: 1.25x..2.1x) "
                  f"dw_speedup={min(dw):.2f}x..{max(dw):.2f}x")


# ---------------------------------------------------------------------------
# Fig. 13 — ResNet18 block2 (BN ⇒ OUT-only in BP)
# ---------------------------------------------------------------------------

def fig13_resnet(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    specs, traces = build_cost_inputs("resnet18", cap)
    rows = []
    gains = []
    for spec, trace in zip(specs, traces):
        dc = cm.layer_cost(spec, trace, "DC").bp.cycles
        inp = cm.layer_cost(spec, trace, "IN").bp.cycles
        full = cm.layer_cost(spec, trace, "IN_OUT_WR").bp.cycles
        rows.append({"layer": spec.name, "has_bn": spec.has_bn,
                     "IN_gain": round(dc / inp, 3),
                     "IN_OUT_WR_gain": round(dc / full, 3)})
        gains.append(dc / full)
    mean_imp = float(np.mean([g - 1 for g in gains]))
    return rows, (f"mean_block_improvement={mean_imp:.2f} "
                  f"(paper: ~0.45 mean, 0.16-0.73 range)")


# ---------------------------------------------------------------------------
# Fig. 15 — end-to-end normalized execution with FP/BP/WG breakdown
# ---------------------------------------------------------------------------

def fig15_end2end(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    rows = []
    overall = {}
    for net in NETS:
        totals = network_totals(net, cap)
        dc = totals["DC"]["total_cycles"]
        for sc in ("DC", "IN", "IN_OUT", "IN_OUT_WR"):
            t = totals[sc]
            rows.append({
                "network": net, "scenario": sc,
                "normalized_total": round(t["total_cycles"] / dc, 4),
                "fp_frac": round(t["fp_cycles"] / dc, 4),
                "bp_frac": round(t["bp_cycles"] / dc, 4),
                "wg_frac": round(t["wg_cycles"] / dc, 4),
            })
        overall[net] = dc / totals["IN_OUT_WR"]["total_cycles"]
    s = " ".join(f"{k}={v:.2f}x" for k, v in overall.items())
    return rows, s + " (paper: vgg~2x goog~2.18x mobile~2.13x dense~1.7x res~1.66x)"


# ---------------------------------------------------------------------------
# Fig. 16 — impact of lane reconfiguration
# ---------------------------------------------------------------------------

def fig16_reconfig(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    rows = []
    for crs, label in ((64, "1x1x64"), (576, "3x3x64")):
        for mode in ("none", "direct", "hierarchical"):
            rows.append({"receptive_field": label, "mode": mode,
                         "lane_utilization":
                             round(cm.lane_utilization(crs, cm.DEFAULT_HW,
                                                       mode), 4)})
    r9 = [r for r in rows if r["receptive_field"] == "3x3x64"]
    gain = r9[2]["lane_utilization"] / r9[0]["lane_utilization"]
    return rows, f"hierarchical_gain_3x3x64={gain:.2f}x (paper: ~1.75x)"


# ---------------------------------------------------------------------------
# Fig. 17 — tile latency min/avg/max under WR (GoogLeNet)
# ---------------------------------------------------------------------------

def fig17_tiles(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    specs, traces = build_cost_inputs("googlenet", cap)
    rows = []
    utils = {}
    for redis, label in ((False, "no_WR"), (True, "WR")):
        # aggregate over conv layers with spatial maps
        us = []
        for spec, trace in zip(specs, traces):
            if trace.bp_active_map is None:
                continue
            work = wr.tile_work_from_mask(trace.bp_active_map, 16, 16,
                                          spec.m * spec.r * spec.s)
            r = wr.simulate(work, redistribute=redis)
            rows.append({"layer": spec.name, "mode": label,
                         "min": round(r.busy_min, 1),
                         "avg": round(r.busy_avg, 1),
                         "max": round(r.busy_max, 1),
                         "makespan": round(r.makespan, 1),
                         "utilization": round(r.utilization, 4)})
            us.append(r.utilization)
        utils[label] = float(np.mean(us)) if us else 1.0
    return rows, (f"utilization no_WR={utils['no_WR']:.3f} → "
                  f"WR={utils['WR']:.3f} (paper: ~0.70 → ~0.829)")


# ---------------------------------------------------------------------------
# Table 2 — platform comparison (iteration latency, batch 16)
# ---------------------------------------------------------------------------

# Published numbers from the paper's Table 2 (cited constants).
_TABLE2_PUBLISHED = [
    # platform, mode, vgg16_ms, res18_ms, power_w, peak_gops
    ("Dual Xeon E5 2560 v3", "CPU, Dense", 8495.0, 2195.0, 85, 614.4),
    ("NVidia GTX 1080 Ti", "GPU, Dense", 128.0, 32.78, 225, 11000),
    ("DaDianNao", "Acc, Dense", 526.0, 61.1, 16.3, 4964),
    ("CNVLUTIN", "Acc, Input Sparse", 365.0, 48.3, 17.4, 4964),
    ("LNPU", "Acc, Input Sparse", 4742.0, 684.0, 0.367, 638),
    ("SparTANN", "Acc, In Sparse(BP&WG)", 12831.0, 1789.0, 0.59, 380),
    ("Selective Grad", "Acc, In Sparse(BP)", 480.0, 61.1, 16.3, 4964),
    ("This Work (paper)", "Acc, In+Out Sparse", 166.81, 23.26, 19.2, 5466),
]


def table2_platforms(cap: Capture = Capture()) -> Tuple[List[dict], str]:
    rows = [{"platform": p, "mode": m, "vgg16_ms": v, "res18_ms": r,
             "power_w": w, "peak_gops": g, "source": "paper Table 2"}
            for p, m, v, r, w, g in _TABLE2_PUBLISHED]
    ours = {}
    for net in ("vgg16", "resnet18"):
        t = network_totals(net, cap)["IN_OUT_WR"]
        ours[net] = t["iteration_ms"]
    rows.append({"platform": "This Work (repro cost model)",
                 "mode": "Acc, In+Out Sparse",
                 "vgg16_ms": round(ours["vgg16"], 2),
                 "res18_ms": round(ours["resnet18"], 2),
                 "power_w": 19.2, "peak_gops": 5466,
                 "source": "trace-driven cost model, this repo"})
    return rows, (f"repro vgg16={ours['vgg16']:.1f}ms res18="
                  f"{ours['resnet18']:.1f}ms (paper: 166.81 / 23.26)")


ALL_FIGURES = {
    "fig03_sparsity": fig03_sparsity,
    "fig11_vgg": fig11_vgg,
    "fig11_googlenet": fig11_googlenet,
    "fig12_densenet": fig12_densenet,
    "fig12_mobilenet": fig12_mobilenet,
    "fig13_resnet": fig13_resnet,
    "fig15_end2end": fig15_end2end,
    "fig16_reconfig": fig16_reconfig,
    "fig17_tiles": fig17_tiles,
    "table2_platforms": table2_platforms,
}
