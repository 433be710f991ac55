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
(``kernels.autotune.fold_pending``).  Meshes, FSDP and the SPMD step wait
for the sharding port (ROADMAP A18).

Decoder-only configs without a frontend train here (dense, MoE, MLA, an
unrolled dense prefix); enc-dec and frontend configs raise, since the
loop's data is ``lm_batch`` tokens only, as in the reference.

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
          [--smoke] [--steps 100] [--ckpt-dir DIR] [--device cuda]
      PYTHONPATH=src python -m repro_torch.launch.train \\
          --arch deepseek-v2-lite-16b --smoke --steps 20 --device cpu
"""
from __future__ import annotations

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
    device="cuda",
) -> Dict[str, Any]:
    """Returns {'params', 'opt_state', 'losses', 'straggler',
    'resumed_from'}.

    ``guard`` opts into guarded execution: each step's metrics feed
    ``StepGuard.observe_step``; a *rollback*/*degrade* verdict restores the
    newest intact checkpoint (degrade first demotes the suspect specs down
    the schedule ladder), and unhealthy steps never produce checkpoints.
    Runs on CUDA unless ``device="cpu"``."""
    if mesh is not None or fsdp or spmd:
        raise NotImplementedError(
            "mesh / fsdp / spmd training: the sharding port is ROADMAP A18")
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
    step_fn = make_train_step(cfg, opt_cfg, microbatches=tcfg.microbatches)

    params = lm_init(tcfg.seed, cfg, dtype=param_dtype, device=dev)
    opt_state = adamw_init(params)
    start_step = 0
    resumed_from = None

    def _restore_latest(params, opt_state):
        step, state = ckpt.restore(ckpt_dir,
                                   {"params": params, "opt": opt_state})
        return step, state["params"], state["opt"]

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

    losses: list = []                 # host floats, flushed chunkwise
    pending: list = []                # device values awaiting one sync
    detector = StragglerDetector()
    for step in range(start_step, steps):
        batch = lm_batch(tcfg.seed, step, batch=batch_size, seq_len=seq_len,
                         vocab=cfg.vocab_size, device=dev)
        params = _faults.tap("train:params", params, step=step)
        opt_state = _faults.tap("train:opt_state", opt_state, step=step)
        t0 = time.time()
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
            if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
                _, params, opt_state = _restore_latest(params, opt_state)
        if ckpt_dir and tcfg.checkpoint_every and \
                (step + 1) % tcfg.checkpoint_every == 0 and verdict == "ok":
            # never checkpoint an unhealthy step — a rollback must have an
            # intact state to land on
            ckpt.save(ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state},
                      keep=tcfg.keep_checkpoints,
                      extra=_host_state(step + 1))
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state},
                  keep=tcfg.keep_checkpoints, extra=_host_state(steps))
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
