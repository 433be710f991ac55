"""Build and load the port's CUDA kernels.

On first use, every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` (one ``nvcc`` per source, all started together), linked into
one shared library with a plain C interface under ``build/repro_torch/``
(named by a hash of the sources and flags), and loaded with ``ctypes``.
Nothing is built when a module is imported, and nothing here includes
PyTorch's headers, CUTLASS or any downloaded code.

A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_CSRC)))
BUILD_DIR = os.path.join(_REPO, "build", "repro_torch")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the launchers; every one returns its cudaError_t.
_GEMM = [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _P, _P] + [_I] * 13 + [_P]
SIGNATURES = {
    "bitmap_scan_launch": [_P, _L, _P] + [_I] * 9 + [_P],
    "relu_encode_launch": [_P, _P, _P] + [_I] * 9 + [_P],
    "queue_builder_launch": [_P, _I, _I, _I, _P, _P, _P, _P],
    "masked_gemm_launch": _GEMM,
    "masked_gemm_reduce_launch": _GEMM[:-1] + [_I] * 3 + [_P],
    "queue_member_launch": [_P, _P, _P, _I, _I, _P, _L, _P],
    "emit_nan_fixup_launch": [_P, _P] + [_I] * 5 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# What nvcc/ptxas reported for the last build (registers, spills).
build_log: str = ""


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CFLAGS).encode())
    return os.path.join(BUILD_DIR, f"repro_torch_kernels_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    global build_log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs,
                               "-o", so_tmp],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, path)
    build_log = "".join(logs)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet.  Raises on a failed build."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
