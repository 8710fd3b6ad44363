"""The one loader of the port's CUDA kernels.

Each kernel is one source, csrc/<name>.cu, with a plain C entry point.
`load(name, signatures)` compiles it with nvcc for sm_90a into
_build/<name>.so when the library is absent or older than its source or
than a header of csrc/ (csrc/*.cuh, which the sources include),
loads it with ctypes and sets each entry point's argument types (every
entry point returns an int: cudaGetLastError() after its launch).

Builds of different kernels run in parallel when called from several
threads (one lock per kernel); nvcc's output (ptxas registers and
spills) and the seconds each build took are kept per kernel.

`on_device(dev)` is the context every wrapper launches in: the CUDA
runtime launches on the calling thread's current device (and sets a
kernel's shared-memory attribute there), whatever device the pointers
and the stream belong to.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# per kernel: nvcc's output of its last build, and the seconds load() spent
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}

_libs: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit")
    return found


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """csrc/<name>.cu as a loaded library, built first when needed.
    signatures: entry point -> ctypes argument types (c_void_p for every
    pointer and the stream, c_int for an int)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock(name):
        if name in _libs:
            return _libs[name]
        t0 = time.perf_counter()
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"{name}.so")
        newest = max(os.path.getmtime(p) for p in
                     [src] + glob.glob(os.path.join(CSRC, "*.cuh")))
        if not os.path.exists(so) or os.path.getmtime(so) < newest:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            res = subprocess.run(
                [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", tmp, src],
                capture_output=True, text=True)
            BUILD_LOG[name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                                   + BUILD_LOG[name])
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for fn, args in signatures.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = args
        BUILD_SECONDS[name] = time.perf_counter() - t0
        _libs[name] = lib
        return lib


def ptxas_usage(name: str) -> str:
    """The register and spill lines of a kernel's last build."""
    return " / ".join(ln.strip() for ln in BUILD_LOG.get(name, "").splitlines()
                      if "registers" in ln or "spill" in ln)


def on_device(device):
    """A context that makes `device` the thread's current CUDA device for
    a launch, and does nothing for any other device (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(name, t, dtype, shape, device):
    """Raise unless tensor `t` lies on `device` with this dtype and shape,
    contiguous: a kernel takes nothing else."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
