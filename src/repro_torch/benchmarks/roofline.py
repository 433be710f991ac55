"""The roofline renderer over the dry run's JSONL (the port of
``benchmarks/roofline.py``): per-cell roofline rows and a markdown table,
and rows for *measured paths* — a step or tick the card ran, beside its
analytic bound.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [FILE]

It renders; it times nothing.  Every bound is the analytic model's
(``launch.flops``) on the H100's peaks (``launch.hlo_analysis``); every
measured time is its caller's.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional, Tuple

from repro_torch.launch import flops as aflops
from repro_torch.launch import hlo_analysis as ha

_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                    "dryrun")
_FINAL = os.path.join(_DIR, "dryrun_final.jsonl")
RESULTS = _FINAL if os.path.exists(_FINAL) else os.path.join(_DIR,
                                                            "dryrun.jsonl")

def load(path: str = RESULTS, mesh: Optional[str] = "16x16") -> List[dict]:
    recs = {}
    if not os.path.exists(path):
        return []
    for line in open(path):
        r = json.loads(line)
        if r.get("skipped") or not r.get("ok"):
            continue
        if mesh and r.get("mesh") != mesh:
            continue
        recs[(r["arch"], r["shape"], r["mesh"])] = r   # latest wins
    return list(recs.values())


def roofline_rows(path: str = RESULTS, mesh: str = "16x16"
                  ) -> Tuple[List[dict], str]:
    rows = []
    worst = (None, 1.0)
    for r in load(path, mesh):
        rl = r["roofline"]
        mem = r.get("memory", {})
        rows.append({
            "arch": r["arch"], "shape": r["shape"],
            "compute_s": round(rl["compute_s"], 6),
            "memory_s": round(rl["memory_s"], 6),
            "collective_s": round(rl["collective_s"], 6),
            "dominant": rl["dominant"],
            "useful_flop_fraction":
                rl["useful_flop_fraction"] and round(rl["useful_flop_fraction"], 3),
            "roofline_fraction":
                rl["roofline_fraction"] and round(rl["roofline_fraction"], 4),
            "live_gib": round(mem.get("live_bytes", 0) / 2 ** 30, 2),
            "fits_hbm": mem.get("fits_hbm"),
        })
        rf = rl.get("roofline_fraction")
        if r["shape"] == "train_4k" and rf and rf < worst[1]:
            worst = (f"{r['arch']}×{r['shape']}", rf)
    rows.sort(key=lambda x: (x["arch"], x["shape"]))
    return rows, f"cells={len(rows)} worst_train_rf={worst[0]}@{worst[1]}"


def markdown_table(path: str = RESULTS, mesh: str = "16x16") -> str:
    rows, _ = roofline_rows(path, mesh)
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful-FLOP frac | roofline frac | argument GiB |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_flop_fraction']} | "
            f"{r['roofline_fraction']} | {r['live_gib']} |")
    return "\n".join(lines)


def path_row(name: str, cfg, shape, measured_ms: Optional[float], *,
             dtype: str) -> dict:
    """A measured path beside its analytic bound at its own shape on one
    card (``dp_n = model_n = 1``) at the ``remat`` it ran (``cfg.remat``:
    a train path that recomputed its forward is bounded with that fourth
    pass): FLOPs, bytes, the compute and memory terms on the peak of
    ``dtype`` (the dtype its GEMMs compute in; for float32, as this
    process sets ``allow_tf32``), the dominant term, the measured ms and
    the roofline fraction bound / measured."""
    ac = aflops.analytic_cost(cfg, shape, dp_n=1, model_n=1)
    rl = ha.roofline_terms(hlo_flops=ac.flops_per_device,
                           hlo_bytes=ac.hbm_bytes_per_device,
                           coll_bytes=ac.coll_bytes_per_device,
                           dtype=dtype)
    bound_ms = rl.bound_s * 1e3
    return {
        "path": name, "dtype": dtype, "shape": (shape.global_batch,
                                                 shape.seq_len, shape.kind),
        "flops": ac.flops_per_device, "bytes": ac.hbm_bytes_per_device,
        "peak_flops": rl.peak_flops,
        "compute_ms": rl.compute_s * 1e3, "memory_ms": rl.memory_s * 1e3,
        "bound_ms": bound_ms, "dominant": rl.dominant,
        "measured_ms": measured_ms,
        "roofline_fraction": None if not measured_ms
        else bound_ms / measured_ms,
        "remat": cfg.remat,
    }


def paths_table(rows: List[dict]) -> str:
    hdr = ("| path | dtype | B × T | FLOPs | bytes | compute ms | memory ms "
           "| bound ms (dominant) | measured ms | roofline frac |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        b, t, kind = r["shape"]
        frac = r["roofline_fraction"]
        meas = r["measured_ms"]
        lines.append(
            f"| {r['path']} | {r['dtype']} | {b} × {t} {kind} | "
            f"{r['flops']:.3e} | {r['bytes']:.3e} | {r['compute_ms']:.3f} | "
            f"{r['memory_ms']:.3f} | {r['bound_ms']:.3f} ({r['dominant']}) | "
            f"{'not measured' if meas is None else f'{meas:.2f}'} | "
            f"{'—' if frac is None else f'{frac:.3f}'} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table(*(sys.argv[1:2] or [RESULTS])))
