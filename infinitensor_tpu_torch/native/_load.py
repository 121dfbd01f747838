"""Build and load the native libraries of native/*.cc at the repository
root, for the port's bindings (graph_core.py, onnx_wire.py, planner.py).

A library is built by g++ on first use and cached beside its source as
lib<stem>-<first 16 hex digits of the source's sha256>.so, the name the
JAX package's bindings give it, so both packages load the same file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def source(name: str) -> str:
    """The path of native/<name> at the repository root."""
    return os.path.join(REPO_ROOT, "native", name)


def load(src: str, stem: str) -> ctypes.CDLL:
    """The library built from `src`. Where it is absent or does not load
    (another process may be writing it), it is built under a temporary
    name, loaded from there and renamed into place. Raises OSError where
    the source is missing, CalledProcessError where g++ fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(os.path.dirname(src), f"lib{stem}-{digest}.so")
    try:
        return ctypes.CDLL(path)
    except OSError:
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                        "-o", tmp], check=True, capture_output=True)
        lib = ctypes.CDLL(tmp)
        os.replace(tmp, path)
        return lib
