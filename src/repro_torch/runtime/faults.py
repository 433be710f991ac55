"""Seeded, deterministic fault injection — and the chaos matrix that shows
each fault class is DETECTED (the intended guard fires), ATTRIBUTED (the
right ``guard:*`` / decision-log entry names it) and SURVIVED (training or
the artifact stays within tolerance of the un-faulted run).  The port of
``repro.runtime.faults``.

Faults are addressed by SITE; this module installs into the owning layers'
``set_*_hook`` slots (the kernels/core/checkpoint layers never import it):

  train:params          NaN/Inf planted in the params tree before one step
  train:opt_state       NaN/Inf planted in optimizer state (persistent)
  gemm:spec             compact-queue capacity shrunk at dispatch
  gemm:emit_bits        bit flipped in an emitted dy bitmap
  registry:register     grad-bitmap registrations dropped
  collective:allreduce  one rank's live-block contribution zeroed inside
                        the bitmap-compressed gradient all-reduce (the dense
                        paths sit outside the tamper point)
  checkpoint:post_leaves / checkpoint:pre_commit
                        the checkpoint writer crashes at that point

``python -m repro_torch.runtime.faults --matrix [--device cpu]`` runs the
eight cases (the train cases on ``SMOKE_ARCHS["smollm-360m"]``, the GEMM
cases with ``kernel_impl="pallas"``: on the kernels on the card).  The
collective case runs on the world the process has joined, a world of one
rank when it has joined none, as the reference's runs on its one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels import autotune, stats

SITES: Dict[str, tuple] = {
    "train:params": ("nan", "inf"),
    "train:opt_state": ("nan", "inf"),
    "gemm:spec": ("queue_overflow",),
    "gemm:emit_bits": ("bitmap_flip",),
    "registry:register": ("registry_drop",),
    "collective:allreduce": ("drop_contrib",),
    "checkpoint:post_leaves": ("crash",),
    "checkpoint:pre_commit": ("crash",),
}

class InjectedCrash(RuntimeError):
    """Raised by an armed ``crash`` fault at its checkpoint protocol point."""


@dataclasses.dataclass
class Fault:
    """One armed fault.  ``step`` gates the stepped sites (``train:*``) to
    a single training step; ``seed`` makes the corrupted element/bit/
    capacity deterministic.  ``fired`` counts injections."""
    site: str
    kind: str
    step: Optional[int] = None
    seed: int = 0
    fired: int = 0


_ARMED: Dict[str, Fault] = {}
_PREV_HOOKS: Optional[tuple] = None


def arm(fault: Fault) -> Fault:
    """Arm ``fault`` at its site (replacing any fault already there) and
    install the layer hooks on first use."""
    if fault.site not in SITES:
        raise ValueError(f"unknown fault site {fault.site!r}; "
                         f"one of {sorted(SITES)}")
    if fault.kind not in SITES[fault.site]:
        raise ValueError(f"fault kind {fault.kind!r} not valid at "
                         f"{fault.site!r} (allowed: {SITES[fault.site]})")
    _ARMED[fault.site] = fault
    _install_hooks()
    return fault


def disarm(site: Optional[str] = None) -> None:
    """Disarm one site (or, with None, everything) and restore the layers'
    previous hooks once nothing is armed."""
    if site is None:
        _ARMED.clear()
    else:
        _ARMED.pop(site, None)
    if not _ARMED:
        _uninstall_hooks()


def active() -> Dict[str, Fault]:
    return dict(_ARMED)


def _install_hooks() -> None:
    global _PREV_HOOKS
    if _PREV_HOOKS is not None:
        return
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import sparse_tensor
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives
    _PREV_HOOKS = (
        ops.set_tamper_hook(_tamper_hook),
        sparse_tensor.set_register_hook(_register_hook),
        ckpt.set_crash_hook(_crash_hook),
        collectives.set_collective_hook(_collective_hook),
    )


def _uninstall_hooks() -> None:
    global _PREV_HOOKS
    if _PREV_HOOKS is None:
        return
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import sparse_tensor
    from repro_torch.kernels import ops
    from repro_torch.sharding import collectives
    tamper, register, crash, collective = _PREV_HOOKS
    ops.set_tamper_hook(tamper)
    sparse_tensor.set_register_hook(register)
    ckpt.set_crash_hook(crash)
    collectives.set_collective_hook(collective)
    _PREV_HOOKS = None


# ---------------------------------------------------------------------------
# The injections
# ---------------------------------------------------------------------------

def _tamper_hook(site: str, value):
    f = _ARMED.get(site)
    if f is None:
        return value
    if site == "gemm:spec" and f.kind == "queue_overflow":
        if value.schedule != "compact":
            return value          # nothing to overflow on other schedules
        f.fired += 1
        return value.with_(max_active_blocks=1 + f.seed % 2)
    if site == "gemm:emit_bits" and f.kind == "bitmap_flip":
        f.fired += 1
        return _flip_bit(value, f.seed)
    return value


def _flip_bit(bits: torch.Tensor, seed: int) -> torch.Tensor:
    flat = bits.reshape(-1).clone()
    idx = seed % flat.numel()
    flat[idx] = 1 - flat[idx]
    return flat.reshape(bits.shape)


def _register_hook(obj, bitmap, gran):
    f = _ARMED.get("registry:register")
    if f is not None and f.kind == "registry_drop":
        f.fired += 1
        return False              # veto: the hand-off never happens
    return True


def _collective_hook(site: str, contrib, index: int, size: int):
    """Zero the compact-buffer contribution of ONE rank (``seed`` picks
    which, mod the number of ranks reduced over) inside the compressed
    all-reduce — a torn write on the wire: blocks only that rank owned
    arrive as zeros while the union bitmap still marks them live."""
    f = _ARMED.get(site)
    if f is None or f.kind != "drop_contrib":
        return contrib
    f.fired += 1
    return contrib * float(index != f.seed % size)


def _crash_hook(name: str) -> None:
    f = _ARMED.get(name)
    if f is not None and f.kind == "crash":
        f.fired += 1
        raise InjectedCrash(name)


def tap(site: str, value, *, step: Optional[int] = None):
    """Train-loop-side injection point (``launch.train.train_loop`` offers
    its params/opt-state trees here each step).  A passthrough when the
    site is unarmed or gated to a different step."""
    f = _ARMED.get(site)
    if f is None or f.kind not in ("nan", "inf"):
        return value
    if f.step is not None and step != f.step:
        return value
    f.fired += 1
    return _plant_nonfinite(value, f.kind, f.seed)


def _plant_nonfinite(tree, kind: str, seed: int):
    """Overwrite one element of one float leaf with NaN/Inf (seed picks the
    leaf, in the reference's flatten order, and the element).  The leaf is
    copied, never written in place."""
    leaves = _tree.leaves(tree)
    float_idx = [i for i, l in enumerate(leaves)
                 if torch.is_tensor(l) and l.is_floating_point()
                 and l.numel() > 0]
    if not float_idx:
        return tree
    i = float_idx[seed % len(float_idx)]
    flat = leaves[i].reshape(-1).clone()
    flat[seed % flat.numel()] = float("nan") if kind == "nan" \
        else float("inf")
    leaves = list(leaves)
    leaves[i] = flat.reshape(leaves[i].shape)
    return _tree.unflatten_like(tree, leaves)


# ---------------------------------------------------------------------------
# The chaos matrix — every fault class: inject, detect, attribute,
# survive
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatrixRow:
    fault: str
    site: str
    kind: str
    detected: bool
    guard_key: str       # the guard:* / decision-log entry that named it
    survived: bool
    detail: str

    @property
    def ok(self) -> bool:
        return self.detected and self.survived


_DEVICE = torch.device("cpu")


def _fresh(**autotune_kwargs) -> None:
    stats.reset()
    autotune.reset(**autotune_kwargs)
    disarm()


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(_DEVICE)


def _train(*, guard=None, ckpt_dir=None, steps=6, ckpt_every=0, seed=3):
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train_loop
    cfg = SMOKE_ARCHS["smollm-360m"]
    tcfg = TrainConfig(total_steps=steps, checkpoint_every=ckpt_every,
                       learning_rate=1e-3, seed=seed)
    return train_loop(cfg, tcfg, batch_size=4, seq_len=16, steps=steps,
                      ckpt_dir=ckpt_dir, log_every=0, guard=guard,
                      device=_DEVICE)


def _case_params_nonfinite() -> MatrixRow:
    """NaN planted in params for ONE step → non-finite loss/grads; the
    optimizer skips the update and the master weights regenerate clean
    params — one ``skip`` verdict, no lasting damage."""
    from .guards import StepGuard
    _fresh()
    base = _train()["losses"][-1]
    guard = StepGuard()
    arm(Fault("train:params", "nan", step=2, seed=7))
    try:
        out = _train(guard=guard)
    finally:
        disarm()
    g = stats.guard_counts()
    verdicts = [v for _, v in guard.verdicts]
    detected = g.get("guard:nonfinite_skip", 0) >= 1 and "skip" in verdicts
    survived = abs(out["losses"][-1] - base) < 0.5
    return MatrixRow(
        "params-nan-one-step", "train:params", "nan", detected,
        "guard:nonfinite_skip", survived,
        f"verdicts={verdicts} final={out['losses'][-1]:.4f} base={base:.4f}")


def _case_optstate_rollback() -> MatrixRow:
    """NaN planted in optimizer state → PERSISTENT non-finite steps; the
    guard escalates past the skip budget to a rollback, restoring the
    newest intact checkpoint, and training converges again."""
    import math
    import tempfile

    from .guards import GuardConfig, StepGuard
    _fresh()
    base = _train(steps=10)["losses"][-1]
    guard = StepGuard(GuardConfig(max_consecutive_skips=2))
    arm(Fault("train:opt_state", "nan", step=4, seed=11))
    try:
        with tempfile.TemporaryDirectory() as d:
            out = _train(guard=guard, ckpt_dir=d, steps=10, ckpt_every=2)
    finally:
        disarm()
    g = stats.guard_counts()
    verdicts = [v for _, v in guard.verdicts]
    final = out["losses"][-1]
    detected = g.get("guard:verdict:rollback", 0) >= 1 \
        and g.get("guard:nonfinite_skip", 0) >= 1
    survived = math.isfinite(final) and abs(final - base) < 1.0 \
        and verdicts[-1] == "ok"
    return MatrixRow(
        "optstate-nan-persistent", "train:opt_state", "nan", detected,
        "guard:verdict:rollback", survived,
        f"verdicts={verdicts} final={final:.4f} base={base:.4f}")


def _case_bitmap_flip() -> MatrixRow:
    """Bit flipped in an emitted bitmap → the guard's consistency probe
    catches it, hands back the rescanned (trusted) bitmap, and the degrade
    path books the producing spec as a suspect."""
    from repro_torch.core import policy as pol
    from repro_torch.kernels.ops import sparse_gemm
    from .guards import StepGuard, reference_bitmap
    _fresh()
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((16, 12)) * (rng.random((16, 12)) > 0.6)
         ).astype(np.float32)
    b = rng.standard_normal((12, 16)).astype(np.float32)
    P = pol.IN_OUT.with_(kernel_impl="pallas", block=(8, 8, 8))
    dims = (16, 12, 16)
    spec = P.gemm_spec(dims=dims).with_(
        epilogue=("bitmap_emit",), emit_gran=(4, 4))
    guard = StepGuard()
    arm(Fault("gemm:emit_bits", "bitmap_flip", seed=5))
    try:
        out, bits = sparse_gemm(_tensor(a), _tensor(b), None, spec=spec)
    finally:
        disarm()
    ok, corrected = guard.probe_emit(out, bits, (4, 4), spec=spec, dims=dims)
    demoted = guard.degrade()
    g = stats.guard_counts()
    out_h = out.cpu().numpy()
    ref = reference_bitmap(out_h, (4, 4))
    detected = (not ok) and g.get("guard:bitmap_mismatch", 0) >= 1 \
        and len(demoted) >= 1
    survived = bool(np.array_equal(corrected.cpu().numpy(), ref)) \
        and np.allclose(out_h, a @ b, atol=1e-4)
    return MatrixRow(
        "emitted-bitmap-bit-flip", "gemm:emit_bits", "bitmap_flip", detected,
        "guard:bitmap_mismatch", survived,
        f"probe_ok={ok} demoted={[k.stats_key for k in demoted]}")


def _case_queue_overflow_demote() -> MatrixRow:
    """Compact-queue capacity shrunk at dispatch → every dispatch
    overflows (counted, exact fallback); past the threshold the autotuner
    demotes the key off the compact schedule, with a ``demote:overflow``
    decision-log event."""
    from repro_torch.core import policy as pol
    from repro_torch.kernels.ops import GemmMasks, sparse_gemm
    _fresh(overflow_demote_after=4)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16)).astype(np.float32)
    mask = np.array([[1, 1], [1, 0]], dtype=np.int32)   # 3 of 4 tiles live
    ref = a @ b
    for i in range(2):
        for j in range(2):
            if not mask[i, j]:
                ref[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = 0.0
    P = pol.IN_OUT_WR.with_(kernel_impl="pallas", block=(8, 8, 8))
    dims = (16, 16, 16)
    exact = True
    ta, tb, tm = _tensor(a), _tensor(b), _tensor(mask)
    arm(Fault("gemm:spec", "queue_overflow", seed=0))
    try:
        for _ in range(6):
            spec = P.gemm_spec(dims=dims)
            out = sparse_gemm(ta, tb, GemmMasks(out=tm), spec=spec)
            exact = exact and np.allclose(out.cpu().numpy(), ref, atol=1e-4)
        after = P.gemm_spec(dims=dims)
    finally:
        disarm()
    c = stats.counts()
    demote_rows = [r for r in autotune.log_rows()
                   if r["event"] == "demote:overflow"]
    detected = c.get("fallback:queue_overflow", 0) >= 4 \
        and len(demote_rows) >= 1
    survived = exact and after.schedule == "predicated" \
        and c.get("guard:quarantine_clamp", 0) >= 1
    return MatrixRow(
        "compact-queue-overflow", "gemm:spec", "queue_overflow", detected,
        "autotune-log:demote:overflow", survived,
        f"overflows={c.get('fallback:queue_overflow', 0)} "
        f"after_schedule={after.schedule} "
        f"demoted_key={demote_rows[0]['key'] if demote_rows else None}")


def _case_registry_drop() -> MatrixRow:
    """Grad-bitmap registrations dropped → consumers miss their dy masks.
    The miss-counter delta above the structural baseline is the detection;
    numerics must be unchanged (a lost mask only loses skipping)."""
    from repro_torch.core import policy as pol
    from repro_torch.core.sparse_linear import relu_matmul
    from .guards import StepGuard
    _fresh()
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((33, 31)) * (rng.random((33, 31)) > 0.5)
         ).astype(np.float32)
    w1 = rng.standard_normal((31, 24)).astype(np.float32)
    w2 = rng.standard_normal((24, 18)).astype(np.float32)
    P = pol.IN_OUT.with_(kernel_impl="pallas", block=(16, 16, 16))

    def grad():
        xs = [_tensor(v).requires_grad_(True) for v in (x, w1, w2)]
        loss = (relu_matmul(relu_matmul(xs[0], xs[1], P), xs[2], P) ** 2
                ).sum()
        return torch.autograd.grad(loss, xs)

    base_grads = grad()
    baseline_misses = stats.counts().get("registry:miss", 0)
    guard = StepGuard()
    guard.scan_counters()                      # set the delta baseline
    arm(Fault("registry:register", "registry_drop"))
    try:
        faulted_grads = grad()
    finally:
        disarm()
    deltas = guard.scan_counters(expected_registry_misses=baseline_misses)
    g = stats.guard_counts()
    detected = deltas["registry:miss"] > baseline_misses \
        and g.get("guard:registry_miss", 0) >= 1
    survived = all(torch.allclose(gb, gf, atol=1e-5)
                   for gb, gf in zip(base_grads, faulted_grads))
    return MatrixRow(
        "grad-bitmap-registry-drop", "registry:register", "registry_drop",
        detected, "guard:registry_miss", survived,
        f"misses: baseline={baseline_misses} faulted={deltas['registry:miss']}")


def _case_collective_drop() -> MatrixRow:
    """One rank's live-block contribution zeroed inside the compressed
    gradient all-reduce → blocks only that rank owned arrive all-zero while
    the union bitmap still marks them live; the guard's consistency probe
    (``probe_emit`` on the summed gradient against the union's live bits)
    flags the disagreement, and the summed norm drops below the clean
    reduce's.  Survival: the dense path sits outside the tamper point — the
    same reduce with ``cutoff=1.0`` (capacity ≥ every block ⇒ dense) is
    exact under the still-armed fault.  Runs on the world this process has
    joined (every rank of it must run the case), else on a world of one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_mesh
    from repro_torch.sharding import collectives
    from .guards import StepGuard
    _fresh()
    if dist.is_initialized():
        n = dist.get_world_size()
        mesh = init_mesh((n,), ("data",), backend=dist.get_backend(),
                         device=_DEVICE)
    else:
        mesh = init_mesh((1,), ("data",), backend=None, device=_DEVICE)
    n_dev, me = mesh.size, mesh.rank
    gran, m, n = (4, 4), 16, 16                # 4×4 grid = 16 blocks
    rng = np.random.default_rng(3)
    # Rank 0 (the one the seed drops) alone owns block (0, 0); blocks
    # (1, 1) and (2, 2) are live on every rank; the rest is dead.
    shards = np.zeros((n_dev, m, n), np.float32)
    shards[0, 0:4, 0:4] = rng.standard_normal((4, 4))
    for s in range(n_dev):
        shards[s, 4:8, 4:8] = rng.standard_normal((4, 4))
        shards[s, 8:12, 8:12] = rng.standard_normal((4, 4))
    bms = (np.abs(shards).reshape(n_dev, 4, 4, 4, 4).sum(axis=(2, 4)) > 0
           ).astype(np.int32)
    x, bm = _tensor(shards[me]), _tensor(bms[me])

    def _reduce(cutoff):
        return collectives.sparse_psum(x, bm, gran, mesh=mesh,
                                       axis_name="data", cutoff=cutoff,
                                       return_bits=True)

    guard = StepGuard()
    fault = arm(Fault("collective:allreduce", "drop_contrib", seed=0))
    try:
        out, union = _reduce(0.5)
        out_dense, _ = _reduce(1.0)
    finally:
        disarm()
    ref = shards.sum(0)
    out_h = out.cpu().numpy()
    ok_probe, _ = guard.probe_emit(out_h, (union > 0).to(torch.int32), gran)
    g = stats.guard_counts()
    c = stats.counts()
    norm_drop = 1.0 - float(np.linalg.norm(out_h) / np.linalg.norm(ref))
    detected = (not ok_probe) and g.get("guard:bitmap_mismatch", 0) >= 1 \
        and fault.fired >= 1 and norm_drop > 0.0
    survived = bool(np.allclose(out_dense.cpu().numpy(), ref, atol=1e-5)) \
        and c.get("collective:dense", 0) >= 1
    return MatrixRow(
        "collective-drop-contrib", "collective:allreduce", "drop_contrib",
        detected, "guard:bitmap_mismatch", survived,
        f"probe_ok={ok_probe} norm_drop={norm_drop:.3f} "
        f"dense_exact={survived} ranks={n_dev}")


def _case_ckpt_crash_mid_save() -> MatrixRow:
    """Checkpoint writer dies between the payload write and the commit
    rename → the partial ``.tmp`` dir is never visible as a checkpoint,
    restore lands on the previous intact step, and the next save clears
    the wreckage."""
    import os
    import tempfile

    from repro_torch import checkpoint as ckpt
    _fresh()
    tree2 = {"w": torch.arange(6, dtype=torch.float32, device=_DEVICE)}
    tree4 = {"w": tree2["w"] * 2}
    crashed = wreckage = False
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, tree2)
        arm(Fault("checkpoint:pre_commit", "crash"))
        try:
            ckpt.save(d, 4, tree4)
        except InjectedCrash:
            crashed = True
        finally:
            disarm()
        wreckage = any(n.endswith(".tmp") for n in os.listdir(d))
        visible = ckpt.latest_step(d)
        step, back = ckpt.restore(d, tree2)
        restored_prev = step == 2 and torch.equal(back["w"], tree2["w"])
        ckpt.save(d, 4, tree4)                 # healthy retry
        cleaned = not any(n.endswith(".tmp") for n in os.listdir(d))
    detected = crashed and wreckage and visible == 2
    survived = restored_prev and cleaned
    return MatrixRow(
        "ckpt-crash-pre-commit", "checkpoint:pre_commit", "crash", detected,
        "commit-protocol", survived,
        f"crashed={crashed} visible={visible} cleaned={cleaned}")


def _case_ckpt_corrupt_newest() -> MatrixRow:
    """Newest COMMITTED checkpoint corrupted on disk (truncated payload) →
    auto-resume detects the typed corruption, counts the fallback, lands
    on the previous intact step and quarantines the wreck."""
    import os
    import tempfile

    from repro_torch import checkpoint as ckpt
    _fresh()
    tree2 = {"w": torch.arange(6, dtype=torch.float32, device=_DEVICE)}
    tree4 = {"w": tree2["w"] * 2}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 2, tree2)
        ckpt.save(d, 4, tree4)
        npz = os.path.join(d, "step_00000004", "leaves.npz")
        with open(npz, "r+b") as f:
            f.truncate(16)                     # torn write
        step, back = ckpt.restore(d, tree2)
        quarantined = any(n.endswith(".corrupt") for n in os.listdir(d))
        g = stats.guard_counts()
        restored_prev = step == 2 and torch.equal(back["w"], tree2["w"])
    detected = g.get("guard:ckpt_fallback", 0) >= 1 and quarantined
    survived = restored_prev
    return MatrixRow(
        "ckpt-corrupt-newest", "checkpoint:pre_commit", "crash", detected,
        "guard:ckpt_fallback", survived,
        f"fallbacks={g.get('guard:ckpt_fallback', 0)} "
        f"quarantined={quarantined}")


CASES: List[Callable[[], MatrixRow]] = [
    _case_params_nonfinite,
    _case_optstate_rollback,
    _case_bitmap_flip,
    _case_queue_overflow_demote,
    _case_registry_drop,
    _case_collective_drop,
    _case_ckpt_crash_mid_save,
    _case_ckpt_corrupt_newest,
]


def run_matrix(names: Optional[List[str]] = None,
               device="cuda") -> List[MatrixRow]:
    """Run the fault catalogue (optionally filtered by substring) on
    ``device`` (default CUDA) and return one row per case.  Each case
    isolates its own stats/autotune state and disarms its faults on the way
    out."""
    global _DEVICE
    from repro_torch.device import resolve_device
    prev, _DEVICE = _DEVICE, resolve_device(device)
    rows = []
    try:
        for case in CASES:
            label = case.__name__.replace("_case_", "")
            if names and not any(n in label for n in names):
                continue
            try:
                rows.append(case())
            except Exception as e:                     # noqa: BLE001
                rows.append(MatrixRow(label, "?", "?", False, "", False,
                                      f"case crashed: {e!r}"))
            finally:
                disarm()
    finally:
        _DEVICE = prev
        _fresh()
    return rows


def write_csv(rows: List[MatrixRow], path: str) -> None:
    import csv
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fault", "site", "kind", "detected", "guard_key",
                    "survived", "ok", "detail"])
        for r in rows:
            w.writerow([r.fault, r.site, r.kind, r.detected, r.guard_key,
                        r.survived, r.ok, r.detail])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Chaos matrix: inject every fault class, assert each "
                    "is detected, attributed and survived.")
    ap.add_argument("--matrix", action="store_true",
                    help="run the full fault catalogue")
    ap.add_argument("--only", nargs="*", default=None,
                    help="substring filter on case names")
    ap.add_argument("--csv", default=None, help="write results as CSV")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--fail-on-undetected", action="store_true",
                    help="exit 1 if any fault goes undetected or unsurvived")
    args = ap.parse_args(argv)
    if not args.matrix:
        ap.print_help()
        return 0
    rows = run_matrix(args.only, device=args.device)
    width = max([len(r.fault) for r in rows] + [16]) + 2
    for r in rows:
        mark = "PASS" if r.ok else "FAIL"
        print(f"{mark}  {r.fault:<{width}} detected={str(r.detected):<5} "
              f"survived={str(r.survived):<5} via {r.guard_key}")
        print(f"      {r.detail}")
    if args.csv:
        write_csv(rows, args.csv)
        print(f"wrote {args.csv}")
    bad = [r for r in rows if not r.ok]
    print(f"{len(rows) - len(bad)}/{len(rows)} fault classes detected "
          f"and survived")
    if bad and args.fail_on_undetected:
        return 1
    return 0


if __name__ == "__main__":
    # ``python -m`` runs this file as __main__ while the train loop imports
    # ``repro_torch.runtime.faults``: delegate to the canonical instance so
    # armed faults are the ones the instrumented layers consult.
    from repro_torch.runtime import faults as _canonical
    sys.exit(_canonical.main())
