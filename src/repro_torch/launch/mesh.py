"""Meshes of ranks — the port of ``repro.launch.mesh``.

JAX sees every device of a host in one process and names them with a
``Mesh``.  PyTorch runs one process per rank and joins them into a
``torch.distributed`` process group.  A ``Mesh`` here names the ranks of
that group by axes:

  * ``axis_names`` and ``shape`` (axis name → size, as the reference's
    ``mesh.shape``); ranks are laid out row-major over the axes;
  * ``coords``: this rank's index along each axis;
  * ``group(axes)``: the process group of the ranks that differ from this
    one only along ``axes`` — the ranks a psum over ``axes`` reduces.  It
    is built with ``new_group`` on first use, by every rank in the same
    order, and cached;
  * ``device_mesh()``: a ``torch.distributed`` ``DeviceMesh`` over the same
    ranks, row-major, with the same axis names, on the ranks' device type
    — what ``DTensor`` placements (``sharding.partition.NamedSharding``)
    refer to.  A rank that joins gloo (on the CPU, or ranks sharing one
    card) has DTensor's functional collectives pointed at synchronous
    ones first (``sharding.shared_card``).  Built on first use by every
    rank in the same order, and cached.

A mesh with no process group (``init_mesh(..., backend=None)``, a world of
one rank) makes every collective the identity: the reference's one-device
mesh, on which its collective tests run the whole traced path.  A mesh
from ``make_abstract_mesh`` has no rank at all, for spec computation only.

``RankPool`` starts a world of ranks that each join the group once and
then run the cases sent to them (``RankPool.run``).  A rank's exception
comes back with its traceback and fails the call; a rank that does not
answer within the call's timeout is killed and fails it too.  This is the
one helper the reference has no counterpart of: JAX needs no processes.
"""
from __future__ import annotations

import math
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import shared_card

# Process groups by their ranks, and DeviceMeshes by (shape, axes, device
# type), shared by every mesh of the process, so a case that builds a
# fresh mesh over the same world reuses them.
_GROUPS: Dict[Tuple[int, ...], object] = {}
_DEVICE_MESHES: Dict[tuple, object] = {}


class Mesh:
    """Named axes over the ranks of one process group (see the module
    docstring).  ``rank`` is None for an abstract mesh; ``distributed`` is
    False for a world of one rank with no process group; ``device_type``
    is the ranks' device type ("cpu" or "cuda")."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 rank: Optional[int] = None, distributed: bool = False,
                 device_type: str = "cpu"):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.distributed = distributed
        self.device_type = device_type
        self.coords: Dict[str, int] = {}
        if rank is not None:
            rest, coords = rank, []
            for name in reversed(self.axis_names):
                rest, c = divmod(rest, self.shape[name])
                coords.append(c)
            self.coords = dict(zip(self.axis_names, reversed(coords)))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"distributed={self.distributed})")

    def _ordered(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return names

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the given order) —
        ``lax.axis_index`` over the same names."""
        idx = 0
        for a in self._ordered(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing without a group)."""
        if self.distributed:
            dist.barrier()

    def device_mesh(self):
        """The ``DeviceMesh`` over this mesh's ranks, or None on a mesh
        without a process group (a world of one rank places nothing)."""
        if self.rank is None:
            raise ValueError("an abstract mesh has no DeviceMesh")
        if not self.distributed:
            return None
        key = (tuple(self.shape.values()), self.axis_names, self.device_type)
        if key not in _DEVICE_MESHES:
            from torch.distributed.device_mesh import DeviceMesh
            _DEVICE_MESHES[key] = DeviceMesh(
                self.device_type,
                torch.arange(self.size).reshape(tuple(self.shape.values())),
                mesh_dim_names=self.axis_names)
        return _DEVICE_MESHES[key]

    def group(self, axes):
        """The process group reducing over ``axes``, or None when the mesh
        has no process group (every collective is then the identity)."""
        if self.rank is None:
            raise ValueError("an abstract mesh has no ranks to reduce over")
        names = set(self._ordered(axes))
        if not self.distributed:
            return None
        if names == set(self.axis_names):
            return dist.group.WORLD
        # Every rank builds every group of the partition, in one order.
        mine = None
        strides = {}
        step = 1
        for a in reversed(self.axis_names):
            strides[a] = step
            step *= self.shape[a]
        inner = [a for a in self.axis_names if a in names]
        for base in range(self.size):
            if any(base // strides[a] % self.shape[a] for a in inner):
                continue                    # not the first rank of a group
            ranks = [base]
            for a in inner:
                ranks = [r + i * strides[a] for r in ranks
                         for i in range(self.shape[a])]
            ranks = tuple(sorted(ranks))
            if ranks not in _GROUPS:
                _GROUPS[ranks] = dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = _GROUPS[ranks]
        return mine


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """Device-free mesh from parallel (shape, axes) sequences."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 ranks a pod ("data", "model"); multi_pod adds a 2-pod
    axis.  Abstract: its sizes only, for spec computation."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *,
                   device="cpu") -> Mesh:
    """("data", "model") mesh over the process group this process already
    joined (``n_data · n_model`` ranks)."""
    return init_mesh((n_data, n_model), ("data", "model"),
                     backend=dist.get_backend(), device=device)


def init_mesh(shape: Sequence[int], axes: Sequence[str], *,
              backend: Optional[str], device, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """A mesh over the ranks of a process group, joining the group first
    when this process has not (``init_method``, ``rank`` and
    ``world_size`` are then required, as nothing here discovers a
    cluster).  ``backend=None`` is the world of one rank with no process
    group.  ``device`` is this rank's card under NCCL.  The backend is the
    caller's: nothing here picks another when one fails."""
    n = math.prod(int(s) for s in shape)
    if backend is None:
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a backend")
        return Mesh(shape, axes, rank=0,
                    device_type=torch.device(device).type)
    if shared_card.needed(backend):
        shared_card.install()
    if not dist.is_initialized():
        if init_method is None or rank is None:
            raise ValueError("joining a process group needs init_method "
                             "and rank")
        world = n if world_size is None else world_size
        if backend == "nccl":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world)
    if dist.get_backend() != backend:
        raise ValueError(f"process group runs {dist.get_backend()}, "
                         f"not {backend}")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh of {n} ranks over a world of "
                         f"{dist.get_world_size()}")
    return Mesh(shape, axes, rank=dist.get_rank(), distributed=True,
                device_type=torch.device(device).type)


def close_mesh() -> None:
    """Leave the process group this process joined (if any)."""
    _GROUPS.clear()
    _DEVICE_MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that was free when asked."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# A pool of ranks
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A case failed or hung in one or more ranks."""


def _rank_main(rank, world, backend, device, init_method, tasks, results):
    try:
        if shared_card.needed(backend):
            shared_card.install()
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        else:
            # The ranks share the host's cores; one thread each also keeps
            # the CPU's sums in one order from run to run.
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world)
    except Exception:                           # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "joined"))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except Exception:                   # noqa: BLE001
                results.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


class RankPool:
    """``world_size`` spawned ranks joined to one ``backend`` group on
    ``device`` (a CUDA device is shared by all of them).  ``run(fn, *args)``
    calls ``fn(*args)`` in every rank and returns the results by rank; ``fn``
    and its arguments and results are pickled (module-level functions,
    host data).  A rank's exception or a timeout closes the pool and raises
    ``RankError`` with every traceback received."""

    def __init__(self, world_size: int, *, device, backend: str = "gloo",
                 timeout: float = 120.0):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._dir = tempfile.mkdtemp(prefix="rank_pool_")
        init_method = "file://" + os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world_size, backend, str(device), init_method,
                  self._tasks[r], self._results))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        self.closed = False
        self._collect(timeout, "join the process group")

    def _collect(self, timeout: float, what: str) -> list:
        deadline = time.monotonic() + timeout
        got: Dict[int, object] = {}
        errors: Dict[int, str] = {}
        while len(got) + len(errors) < self.world_size:
            # After one rank fails the others may wait in a collective that
            # never completes: give them a short grace, not the timeout.
            left = deadline - time.monotonic()
            if errors:
                left = min(left, 5.0)
            try:
                rank, ok, payload = self._results.get(timeout=max(left, 0))
            except _queue.Empty:
                break
            (got if ok else errors)[rank] = payload
        if errors or len(got) < self.world_size:
            silent = [r for r in range(self.world_size)
                      if r not in got and r not in errors]
            self.close()
            msg = [f"{what}: {len(errors)} rank(s) failed, "
                   f"{len(silent)} did not answer {sorted(silent)}"]
            msg += [f"--- rank {r} ---\n{tb}" for r, tb in
                    sorted(errors.items())]
            raise RankError("\n".join(msg))
        return [got[r] for r in range(self.world_size)]

    def run(self, fn: Callable, *args, timeout: float = 120.0) -> list:
        if self.closed:
            raise RankError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(timeout, getattr(fn, "__name__", str(fn)))

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):
                pass
        deadline = time.monotonic() + 10.0
        for p in self._procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for q in self._tasks + [self._results]:
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
