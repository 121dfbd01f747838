"""Build and load the port's CUDA kernels.

Each source under kernels/csrc/ is compiled by its own nvcc process into
a shared library with a plain C interface (all started together), loaded
with ctypes at the first launch. Nothing here runs on import. Output goes
to build/<hash>/ at the repository root, keyed by a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def build_all() -> dict:
    """Compile every missing library, one nvcc per source, in parallel.
    Returns {stem: seconds} for the sources compiled by this call; raises
    with the compiler's output when one fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _sources():
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        log = open(out / f"{src.stem}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           log, tmp, lib, time.perf_counter())
    took, failed = {}, []
    for stem, (proc, log, tmp, lib, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[stem] = time.perf_counter() - t0
        if rc:
            failed.append(f"{stem}.cu (nvcc rc={rc}):\n"
                          + (out / f"{stem}.log").read_text()[-4000:])
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


@functools.cache
def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (built on first use)."""
    build_all()
    return ctypes.CDLL(str(build_dir() / f"lib{stem}.so"))



# ctypes argument types of the C entry points: pointers and the stream
# must be c_void_p, or ctypes passes a 32-bit int and cuts them.
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def typed(stem: str, **signatures) -> ctypes.CDLL:
    """library(stem) with argtypes set for each named entry point (all
    return a cudaError_t as int) and for itt_error_string."""
    lib = library(stem)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = I
    lib.itt_error_string.argtypes = [I]
    lib.itt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def sms(index: int) -> int:
    """The SM count of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream (the capture stream inside a graph)."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err:
        msg = lib.itt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
