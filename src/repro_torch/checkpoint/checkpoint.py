"""Crash-safe checkpointing: fsync'd atomic commits, keep-last-k, auto-resume
with corrupt-newest fallback — the port of ``repro.checkpoint.checkpoint``.

Layout (the reference's, byte for byte in meaning):

    <dir>/step_00001230/            (atomic: written as .tmp, renamed)
        leaves.npz                  leaf_%05d arrays in the flatten order of
                                    JAX's tree (dict keys sorted)
        treedef.json                leaf paths + metadata
        state.json                  optional host-side extras (autotune
                                    cache + guard state)

so a checkpoint written by either package restores in the other.  Leaves
are saved as full host copies of their values.  A bf16 leaf is written as
the reference writes it, raw ``|V2`` records; the port restores such a
file from either package bit for bit (the reference's own restore cannot
cast ``|V2`` back to bf16: ROADMAP Queue C).

Commit protocol: payload files are written into ``step_X.tmp`` and
fsync'd, then the tmp dir; ``os.rename(tmp, final)`` is the commit point
(a previous ``final`` of the SAME step is moved aside first and deleted
only after the new rename lands); the parent dir is fsync'd; older steps
and wreckage are pruned.  ``restore`` with no explicit step falls back to
the previous intact checkpoint when the newest is corrupt or partial
(counted as ``guard:ckpt_fallback``; the wreck goes to ``*.corrupt``).
``restore_resharded`` restores onto the replicated placement of the
data-parallel path: every rank loads the whole tree onto its own device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels import stats

_STEP_RE = re.compile(r"^step_(\d{8})$")
_WRECKAGE_SUFFIXES = (".tmp", ".old", ".corrupt")


class CheckpointError(Exception):
    """Typed checkpoint failure carrying step/leaf context."""

    def __init__(self, msg: str, *, step: Optional[int] = None,
                 leaf: Optional[str] = None):
        ctx = []
        if step is not None:
            ctx.append(f"step={step}")
        if leaf is not None:
            ctx.append(f"leaf={leaf}")
        super().__init__(f"{msg}" + (f" [{', '.join(ctx)}]" if ctx else ""))
        self.step = step
        self.leaf = leaf


class CheckpointCorruptError(CheckpointError):
    """The stored payload is unreadable or inconsistent — restore may fall
    back to an older intact checkpoint."""


# Fault-injection crash points (``runtime/faults.py``): an installed hook
# may raise at a named protocol point to simulate a writer dying there.
_CRASH_HOOK = None


def set_crash_hook(fn):
    """Install (or, with None, remove) the crash-point hook; returns the
    previous hook."""
    global _CRASH_HOOK
    prev, _CRASH_HOOK = _CRASH_HOOK, fn
    return prev


def _crash_point(name: str) -> None:
    if _CRASH_HOOK is not None:
        _CRASH_HOOK(name)


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _fsync(p: str) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# A bf16 leaf on disk: the reference's ``np.savez`` of an ``ml_dtypes``
# bfloat16 array writes raw 2-byte void records under the descr ``<V2``
# (numpy's own void dtype would say ``|V2``); the port writes the same
# header and bits, and reads 2-byte void records back as bf16.
_BF16_DISK = np.dtype("V2")
_BF16_DESCR = "<V2"


def _savez(path: str, flat: dict) -> None:
    """``np.savez(path, **flat)``, with a bf16 leaf's header written as the
    reference's."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype != _BF16_DISK:
                    np.lib.format.write_array(f, arr)
                    continue
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = _BF16_DESCR
                np.lib.format.write_array_header_1_0(f, header)
                f.write(np.ascontiguousarray(arr).tobytes())


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_DISK)
        return t.numpy()
    return np.asarray(leaf)


def _tensor(got: np.ndarray) -> torch.Tensor:
    """A loaded array as a tensor: ``|V2`` records as bf16 bits."""
    if got.dtype == _BF16_DISK:
        return torch.from_numpy(np.array(got).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(got))


def _flatten(tree) -> Tuple[dict, list]:
    flat, paths = {}, []
    for i, (path, leaf) in enumerate(_tree.leaves_with_paths(tree)):
        flat[f"leaf_{i:05d}"] = _host(leaf)
        paths.append(path)
    return flat, paths


def save(path: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Durable atomic checkpoint write; prunes to the newest ``keep``
    checkpoints.  ``extra`` (JSON-able) is persisted as ``state.json``."""
    os.makedirs(path, exist_ok=True)
    final = _step_dir(path, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, paths = _flatten(tree)
    _savez(os.path.join(tmp, "leaves.npz"), flat)
    _fsync(os.path.join(tmp, "leaves.npz"))
    _crash_point("checkpoint:post_leaves")
    with open(os.path.join(tmp, "treedef.json"), "w") as f:
        json.dump({"paths": paths, "n_leaves": len(paths),
                   "treedef": _tree.treedef_str(tree), "step": step}, f)
        f.flush()
        os.fsync(f.fileno())
    if extra is not None:
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump(extra, f)
            f.flush()
            os.fsync(f.fileno())
    _fsync(tmp)
    _crash_point("checkpoint:pre_commit")
    if os.path.exists(final):
        # Same-step rewrite: the intact previous dir must survive until
        # the new one is committed — move it aside, never rmtree first.
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)                   # commit point
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)                   # commit point
    _fsync(path)
    _prune(path, keep)
    return final


def _prune(path: str, keep: int) -> None:
    steps = _list_steps(path)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(path, s), ignore_errors=True)
    for name in os.listdir(path):
        if name.endswith(_WRECKAGE_SUFFIXES):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)


def _list_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(path, name, "treedef.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = _list_steps(path)
    return steps[-1] if steps else None


def _load_step(path: str, step: int, template: Any) -> Any:
    """Load one committed checkpoint into ``template``'s structure, each
    leaf with its template leaf's dtype and device.  Raises
    ``CheckpointCorruptError`` for unreadable/inconsistent payloads."""
    d = _step_dir(path, step)
    try:
        with np.load(os.path.join(d, "leaves.npz")) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointCorruptError(
            f"unreadable leaves.npz under {d}: {e!r}", step=step) from e
    t_leaves = _tree.leaves(template)
    if len(flat) != len(t_leaves):
        raise CheckpointCorruptError(
            f"leaf count mismatch: checkpoint has {len(flat)}, template "
            f"wants {len(t_leaves)}", step=step)
    out = []
    for i, want in enumerate(t_leaves):
        key = f"leaf_{i:05d}"
        if key not in flat:
            raise CheckpointCorruptError(
                f"missing array {key!r} in leaves.npz", step=step, leaf=key)
        got = flat[key]
        if got.shape != tuple(want.shape):
            raise CheckpointCorruptError(
                f"shape mismatch: checkpoint {got.shape} vs template "
                f"{tuple(want.shape)}", step=step, leaf=key)
        if isinstance(want, torch.Tensor):
            out.append(_tensor(got).to(device=want.device,
                                       dtype=want.dtype))
        else:
            out.append(np.asarray(got, dtype=np.asarray(want).dtype))
    return _tree.unflatten_like(template, out)


def _quarantine(path: str, step: int) -> None:
    """Move a corrupt committed step dir aside (``*.corrupt``)."""
    d = _step_dir(path, step)
    try:
        target = d + ".corrupt"
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(d, target)
    except OSError:
        pass                         # best-effort: fallback still proceeds


def restore(path: str, template: Any, step: Optional[int] = None,
            *, fallback: bool = True) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (shapes validated).  With
    ``step=None`` a corrupt/partial newest checkpoint is quarantined,
    ``guard:ckpt_fallback`` counted, and the previous intact one loaded
    (``fallback=False`` disables the retry).  An explicit ``step`` is
    loaded exactly, raising on failure."""
    if step is not None:
        return step, _load_step(path, step, template)
    steps = _list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    last_err: Optional[CheckpointError] = None
    for s in reversed(steps):
        try:
            return s, _load_step(path, s, template)
        except CheckpointCorruptError as e:
            if not fallback:
                raise
            stats.record("guard:ckpt_fallback")
            _quarantine(path, s)
            last_err = e
    raise CheckpointError(
        f"every checkpoint under {path} is corrupt "
        f"(newest failure: {last_err})", step=steps[-1])


def load_state(path: str, step: Optional[int] = None) -> Optional[dict]:
    """The ``state.json`` extra payload of a checkpoint (newest by
    default), or None when absent/unreadable."""
    if step is None:
        step = latest_step(path)
        if step is None:
            return None
    p = os.path.join(_step_dir(path, step), "state.json")
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _replicated(spec) -> bool:
    return all(entry is None for entry in spec)


def restore_resharded(path: str, template: Any, placements: Any,
                      step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore onto a new layout: ``placements`` is one
    ``sharding.partition.PartitionSpec`` for every leaf, or a tree of them
    matching ``template``.  The replicated placement (every entry None) is
    what the data-parallel path runs: each rank restores the whole tree
    onto its own device, the device of its template leaves.  Any other
    placement is ROADMAP A18b and raises."""
    from repro_torch.sharding.partition import A18B, spec_leaves
    if not all(_replicated(s) for _, s in spec_leaves(placements)):
        raise NotImplementedError(f"restore_resharded: {A18B}")
    return restore(path, template, step)

