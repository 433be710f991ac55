"""Fault-tolerant single-device LM training driver — the port of
``repro.launch.train``.

  * an eager train step (``launch/steps.make_train_step``) with gradient
    accumulation over microbatches,
  * atomic checkpointing every N steps, keep-last-k, auto-resume (the data
    cursor is the step index, so the token stream resumes exactly), with
    the autotune cache and the guard state in ``state.json``,
  * the straggler detector,
  * opt-in guarded execution: with a ``runtime.guards.StepGuard`` each
    step's health is folded into a verdict — bounded skips, rollback to the
    newest intact checkpoint, schedule degradation.  Guarded runs read the
    small metric scalars every step; unguarded runs read the losses in
    chunks of ``loss_flush_steps``,
  * the fault-injection taps ``train:params`` / ``train:opt_state``.

The autotuner's device-side telemetry is folded once a step
(``kernels.autotune.fold_pending``).

``spmd=True`` with a ``launch.mesh.Mesh`` runs the data-parallel step
(``sharding.spmd_step``) in every rank of the mesh: params and optimizer
state replicated, each rank's rows of the global batch, the gradient
all-reduce bitmap-compressed.  Every rank restores (the replicated
``checkpoint.restore_resharded``); only rank 0 writes checkpoints and
``state.json``; barriers after each save and around each restore keep
every rank's reads of the directory apart from rank 0's writes.  The
guard reads all-reduced metrics, so its verdicts are the same on every
rank.

A mesh without ``spmd`` runs the eager step on DTensors, the port of the
reference's jit-partitioned step: params and optimizer state placed by
``partition.params_shardings``/``opt_state_pspecs`` (tensor parallelism
on ``model``; with ``fsdp`` also the largest dim of every param of at
least 4 M elements over the data axes), each rank's rows of the batch by
``batch_pspecs``, the activation rules installed for the loop, and the
gradients pinned to the param layout.  Checkpoints hold the full tensors
(every rank joins the gather, rank 0 writes) and restore onto the loop's
layout, whatever layout wrote them.

Decoder-only configs without a frontend train here (dense, MoE, MLA, an
unrolled dense prefix); enc-dec and frontend configs raise, since the
loop's data is ``lm_batch`` tokens only, as in the reference.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
          [--smoke] [--steps 100] [--ckpt-dir DIR] [--device cuda]
      PYTHONPATH=src python -m repro_torch.launch.train \\
          --arch deepseek-v2-lite-16b --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import lm_batch
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune as _autotune
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import lm_init
from repro_torch.optim.optimizer import OptConfig, adamw_init
from repro_torch.runtime import faults as _faults
from repro_torch.runtime.guards import StepGuard
from repro_torch.sharding import partition
from repro_torch.sharding import spmd_step as _spmd
from repro_torch.sharding.context import sharding_rules


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps slower than ``threshold``× the trailing median.  The
    current sample is not part of the median it is judged against, and the
    first observed step (warm-up) never enters the history."""
    window: int = 32
    threshold: float = 2.0
    min_history: int = 8
    skip_first: bool = True
    times: list = dataclasses.field(default_factory=list)
    flags: list = dataclasses.field(default_factory=list)
    _seen: int = 0

    def observe(self, step: int, dt: float) -> bool:
        self._seen += 1
        if self.skip_first and self._seen == 1:
            return False
        hist = self.times[-self.window:]          # trailing, EXCLUDING dt
        med = float(np.median(hist)) if hist else 0.0
        slow = len(hist) >= self.min_history and dt > self.threshold * med
        if slow:
            self.flags.append((step, dt, med))
        self.times.append(dt)
        if len(self.times) > self.window:
            del self.times[:-self.window]
        return slow


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    *,
    batch_size: int,
    seq_len: int,
    steps: int,
    ckpt_dir: Optional[str] = None,
    resume: bool = True,
    mesh=None,
    fsdp: bool = False,
    log_every: int = 10,
    param_dtype=torch.float32,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    guard: Optional[StepGuard] = None,
    loss_flush_steps: int = 4096,
    spmd: bool = False,
    collective_cutoff: float = _spmd.DEFAULT_CUTOFF,
    device="cuda",
) -> Dict[str, Any]:
    """Returns {'params', 'opt_state', 'losses', 'straggler',
    'resumed_from'}.

    ``guard`` opts into guarded execution: each step's metrics feed
    ``StepGuard.observe_step``; a *rollback*/*degrade* verdict restores the
    newest intact checkpoint (degrade first demotes the suspect specs down
    the schedule ladder), and unhealthy steps never produce checkpoints.
    ``spmd=True`` (with ``mesh``) runs the data-parallel step in this rank
    of the mesh, with dense fallback above ``collective_cutoff`` union live
    fraction; a mesh without ``spmd`` places params, optimizer state and
    batch by the partition rules (``fsdp`` as given).  Runs on CUDA unless
    ``device="cpu"``."""
    if spmd:
        if mesh is None:
            raise ValueError("spmd=True requires a mesh")
        if tcfg.microbatches != 1:
            raise ValueError(
                "spmd mode: the mesh IS the data-parallel split; "
                "gradient-accumulation microbatching is the single-process "
                "step's feature (use microbatches=1)")
    if fsdp and (mesh is None or spmd):
        raise ValueError("fsdp places params on a mesh: it needs a mesh, "
                         "and the spmd step replicates them")
    if cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the loop feeds lm_batch tokens only, no frontend "
            f"embeddings (as the reference's loop); train an enc-dec or "
            f"frontend model through launch.steps.make_train_step")
    dev = resolve_device(device)
    opt_cfg = OptConfig(
        learning_rate=tcfg.learning_rate, warmup_steps=tcfg.warmup_steps,
        total_steps=tcfg.total_steps, weight_decay=tcfg.weight_decay,
        beta1=tcfg.beta1, beta2=tcfg.beta2, grad_clip=tcfg.grad_clip,
        loss_scale=tcfg.loss_scale, emit_guard_stats=guard is not None)
    params = lm_init(tcfg.seed, cfg, dtype=param_dtype, device=dev)
    opt_state = adamw_init(params)
    layout = partition.P()              # the spmd step's: all replicated
    rules = None
    if spmd:
        step_fn = _spmd.make_spmd_train_step(cfg, opt_cfg, mesh,
                                             cutoff=collective_cutoff)
    elif mesh is not None:
        layout = {"params": partition.params_shardings(params, mesh,
                                                       fsdp=fsdp),
                  "opt": partition.to_shardings(partition.opt_state_pspecs(
                      opt_state, params, mesh, fsdp=fsdp), mesh)}
        params = partition.place(params, layout["params"])
        opt_state = partition.place(opt_state, layout["opt"])
        rules = {**partition.activation_rules(mesh), "__mesh__": mesh}
        step_fn = make_train_step(cfg, opt_cfg,
                                  microbatches=tcfg.microbatches,
                                  grad_pspecs=layout["params"])
    else:
        step_fn = make_train_step(cfg, opt_cfg,
                                  microbatches=tcfg.microbatches)
    start_step = 0
    resumed_from = None

    def _restore_latest(params, opt_state):
        tpl = {"params": params, "opt": opt_state}
        if mesh is not None:
            step, state = ckpt.restore_resharded(ckpt_dir, tpl, layout)
        else:
            step, state = ckpt.restore(ckpt_dir, tpl)
        return step, state["params"], state["opt"]

    def _barrier():
        """Fences the checkpoint directory: ranks may run apart between
        collectives (replicas along a model axis share none), so no rank
        may write it while another still reads it."""
        if mesh is not None:
            mesh.barrier()

    def _save(step, extra):
        writes = mesh is None or mesh.rank == 0
        state = ckpt.gather_full({"params": params, "opt": opt_state},
                                 keep=writes)
        if writes:
            ckpt.save(ckpt_dir, step, state, keep=tcfg.keep_checkpoints,
                      extra=extra)
        del state
        _barrier()

    def _host_state(step):
        """The state.json resume payload: autotune cache + guard state."""
        extra = {"step": step, "autotune": _autotune.export_state()}
        if guard is not None:
            extra["guard"] = guard.export_state()
        return extra

    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        start_step, params, opt_state = _restore_latest(params, opt_state)
        resumed_from = start_step
        host_state = ckpt.load_state(ckpt_dir, start_step)
        if host_state:
            _autotune.import_state(host_state.get("autotune") or {})
            if guard is not None and host_state.get("guard"):
                guard.import_state(host_state["guard"])
    if ckpt_dir:
        _barrier()

    losses: list = []                 # host floats, flushed chunkwise
    pending: list = []                # device values awaiting one sync
    detector = StragglerDetector()
    for step in range(start_step, steps):
        batch = lm_batch(tcfg.seed, step, batch=batch_size, seq_len=seq_len,
                         vocab=cfg.vocab_size, device=dev)
        if rules is not None:
            batch = partition.place(batch, partition.to_shardings(
                partition.batch_pspecs(batch, mesh), mesh))
        params = _faults.tap("train:params", params, step=step)
        opt_state = _faults.tap("train:opt_state", opt_state, step=step)
        t0 = time.time()
        with (contextlib.nullcontext() if rules is None
              else sharding_rules(rules)):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        dt = time.time() - t0
        _autotune.fold_pending()
        slow = detector.observe(step, dt)
        pending.append(metrics["loss"])
        if len(pending) >= loss_flush_steps:
            losses.extend(float(l) for l in pending)
            pending.clear()
        verdict = "ok"
        host: Optional[Dict[str, float]] = None
        if guard is not None:
            host = {k: float(v) for k, v in metrics.items()}
            verdict = guard.observe_step(
                step, loss=host.get("loss"),
                grad_norm=host.get("grad_norm"),
                skipped=host.get("skipped"))
        log_step = log_every and step % log_every == 0
        if on_metrics or log_step:
            if host is None:
                host = {k: float(v) for k, v in metrics.items()}
            if on_metrics:
                on_metrics(step, {**host, "time_s": dt, "straggler": slow,
                                  "verdict": verdict})
            if log_step:
                print(f"step {step:5d} loss {host['loss']:8.4f} "
                      f"gnorm {host['grad_norm']:8.3f} "
                      f"lr {host['lr']:.2e} {dt*1e3:7.1f} ms"
                      + ("  [straggler]" if slow else "")
                      + ("  [skipped]" if host.get("skipped") else ""))
        if verdict in ("rollback", "degrade"):
            if verdict == "degrade":
                guard.degrade()
            if ckpt_dir:
                _barrier()
                if ckpt.latest_step(ckpt_dir) is not None:
                    _, params, opt_state = _restore_latest(params,
                                                           opt_state)
                _barrier()
        if ckpt_dir and tcfg.checkpoint_every and \
                (step + 1) % tcfg.checkpoint_every == 0 and verdict == "ok":
            # never checkpoint an unhealthy step — a rollback must have an
            # intact state to land on
            _save(step + 1, _host_state(step + 1))
    if ckpt_dir:
        _save(steps, _host_state(steps))
    losses.extend(float(l) for l in pending)   # final chunk sync
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "straggler": detector, "resumed_from": resumed_from}


def main(argv=None) -> None:
    import argparse
    from repro_torch.configs import ARCHS, SMOKE_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (SMOKE_ARCHS if args.smoke else ARCHS)[args.arch]
    tcfg = TrainConfig(total_steps=args.steps, microbatches=args.microbatches,
                       checkpoint_every=max(10, args.steps // 5))
    out = train_loop(cfg, tcfg, batch_size=args.batch, seq_len=args.seq,
                     steps=args.steps, ckpt_dir=args.ckpt_dir,
                     resume=not args.no_resume, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(resumed_from={out['resumed_from']})")


if __name__ == "__main__":
    main()
