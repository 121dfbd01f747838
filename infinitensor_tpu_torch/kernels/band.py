"""Band matmuls of Longformer local attention: G2BMM / GBMM (counterpart
of infinitensor_tpu/kernels/band.py).

g2bmm: out[b, i, j] = sum_k A[b, i, k] * B[b, i + (j - w) d, k]  (scores)
gbmm:  out[b, i, k] = sum_j W[b, i, j] * B[b, i + (j - w) d, k]  (weights @ V)
with j in [0, 2w], terms whose row i + (j - w) d falls outside [0, m)
left out (g2bmm writes 0 there), f32 sums rounded to A's (g2bmm) or B's
(gbmm) dtype.

g2bmm_band and gbmm_band launch a kernel that replaces _g2bmm_kernel and
_gbmm_kernel, in one of two forms that band_form chooses:
  "ring": csrc/band_ring.cu, both operands bf16 or both f32 and k a
          multiple of 8 from 8 to 256 (any m, any w): B's window streams
          through a cp.async ring of 64-row tiles; mma.sync in bf16, a
          register-tiled FMA consumer in f32;
  "simt": csrc/band.cu, the first CUDA form (the window staged whole, one
          FMA per two shared loads), for a mixed bf16 / f32 pair and any
          other k; called directly it raises where that window does not
          fit a block's shared memory, a shape the lowerings' gate
          (band_kernels_usable, below) keeps from it.
`form=` forces either (the ring only where it applies). g2bmm_plain and
gbmm_plain are the plain versions (one f32 multiply-reduce per
diagonal). A CPU tensor takes the plain version; a CUDA tensor launches
the kernel of its form (bf16 or f32 inputs) or raises. `launches` counts
kernel launches: "g2bmm" / "gbmm" every form, "g2bmm_ring" / "gbmm_ring"
the ring form again.

band_kernels_usable is the lowerings' gate, as the JAX package's
(band.py:157-163) is theirs: dilation 1 (a dilated band stays on the
lowering's gather or shift-scan path, as in the JAX package), and
band_launches, a pure function of the op, the two dtypes and the shapes
that is true exactly where the form band_form picks launches: both
operands bf16 or f32, bz at most GRID_Y_MAX (a launch's grid y), and for
the first form a window that fits a block's shared memory (csrc/band.cu
pick_rows; f32 G2BMM at k 512, w 128 needs 529,432 bytes for one row).
What it refuses takes the gather or shift-scan path; it is decided before
any launch, and a launch that fails at a shape it passes raises. Dropped
are the TPU's predicates: k % 128 == 0 (lanes), w <= 128 (the kernel's
static unroll of the diagonals) and a row block that is a multiple of 8
dividing m (VMEM blocks).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels import _build

launches = collections.Counter()
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
RING_MAX_K = 256               # the ring form: k a multiple of 8 up to this
RING_MAX_W = 1 << 20           # ... and w up to this (band_ring.cu kMaxW)
GRID_Y_MAX = 65535             # the most bz a launch takes (grid y)
SIMT_SMEM = 232448             # the first form's shared memory (kSmemMax)


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I = _build.P, _build.I
    sig = [P, I, P, I, P, I, I, I, I, P]
    return _build.typed("band", g2bmm=sig, gbmm=sig)


@functools.cache
def _lib_ring() -> ctypes.CDLL:
    P, I = _build.P, _build.I
    sig = [P, P, P, I, I, I, I, I, P]
    return _build.typed("band_ring", g2bmm_ring=sig, gbmm_ring=sig)


def band_form(a_dtype: torch.dtype, b_dtype: torch.dtype, k: int) -> str:
    """Which form a g2bmm / gbmm launch on the card takes: "ring"
    (csrc/band_ring.cu) when both operands are bf16 or both f32 and k is
    a multiple of 8 from 8 to RING_MAX_K; else "simt" (csrc/band.cu)."""
    return "ring" if a_dtype == b_dtype and a_dtype in KERNEL_DTYPES \
        and k % 8 == 0 and 8 <= k <= RING_MAX_K else "simt"


def shifted_rows(b: torch.Tensor, off: int) -> torch.Tensor:
    """[bz, m, k]: row i holds b[i + off] (zeros where that is outside
    [0, m)), in f32."""
    m = b.shape[1]
    out = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    lo, hi = max(0, -off), min(m, m - off)
    if lo < hi:
        out[:, lo:hi] = b[:, lo + off:hi + off].float()
    return out


def g2bmm_plain(a: torch.Tensor, b: torch.Tensor, w: int, d: int = 1
                ) -> torch.Tensor:
    """A [bz, m, k], B [bz, m, k] -> [bz, m, 2w + 1] in A's dtype: per
    diagonal j, the f32 row dots of A and B shifted by (j - w) d."""
    af = a.float()
    cols = [(af * shifted_rows(b, (j - w) * d)).sum(-1)
            for j in range(2 * w + 1)]
    return torch.stack(cols, dim=-1).to(a.dtype)


def gbmm_plain(wts: torch.Tensor, b: torch.Tensor, w: int, d: int = 1
               ) -> torch.Tensor:
    """W [bz, m, 2w + 1], B [bz, m, k] -> [bz, m, k] in B's dtype: the f32
    sum over diagonals j of W[..., j] times B shifted by (j - w) d."""
    wf = wts.float()
    acc = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    for j in range(2 * w + 1):
        acc += wf[..., j:j + 1] * shifted_rows(b, (j - w) * d)
    return acc.to(b.dtype)


def _simt_stride(k: int, itemsize: int) -> int:
    """csrc/band.cu padded<T>: the row stride (elements) of a staged tile
    of k columns of a type of `itemsize` bytes."""
    if itemsize == 4:
        return k | 1
    s = k + (k & 1)
    return s if s % 4 == 2 else s + 2


def _simt_rows(m: int, w: int, row_bytes: int, win_row_bytes: int) -> int:
    """csrc/band.cu pick_rows: the first form's rows a block, 64 halved
    until its tiles fit SIMT_SMEM, at most m; 0 where one row does not
    fit."""
    def need(r):
        return r * row_bytes + 16 + (r + 2 * w) * win_row_bytes

    r = 64
    while r > 1 and need(r) > SIMT_SMEM:
        r //= 2
    r = min(r, m)
    return r if need(r) <= SIMT_SMEM else 0


def band_launches(op: str, first_dtype: torch.dtype, b_dtype: torch.dtype,
                  bz: int, m: int, k: int, w: int) -> bool:
    """True exactly where g2bmm_band (op "g2bmm", first operand A [bz, m,
    k]) or gbmm_band ("gbmm", first operand W [bz, m, 2w + 1]) over B [bz,
    m, k] launches on the card in the form band_form picks: both operands
    in KERNEL_DTYPES and bz at most GRID_Y_MAX; the ring form w up to
    RING_MAX_W; the first form its window staged whole (_simt_rows)."""
    if op not in ("g2bmm", "gbmm"):
        raise ValueError(f"no band op {op!r}")
    if first_dtype not in KERNEL_DTYPES or b_dtype not in KERNEL_DTYPES \
            or not (0 < bz <= GRID_Y_MAX and m > 0 and k > 0 and w >= 0):
        return False
    if band_form(first_dtype, b_dtype, k) == "ring":
        return w <= RING_MAX_W
    fs, bs = first_dtype.itemsize, b_dtype.itemsize
    if op == "g2bmm":
        row, win_row = _simt_stride(k, fs) * fs, _simt_stride(k, bs) * bs
    else:
        row, win_row = (2 * w + 1) * fs, k * bs
    return _simt_rows(m, w, row, win_row) > 0


def band_kernels_usable(op: str, first_dtype: torch.dtype,
                        b_dtype: torch.dtype, bz: int, m: int, k: int,
                        w: int, d: int) -> bool:
    """The lowerings' gate: dilation 1 and band_launches (see the module
    docstring)."""
    return d == 1 and band_launches(op, first_dtype, b_dtype, bz, m, k, w)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it that starts on 16 bytes (the ring form copies
    rows of A and B 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, first: torch.Tensor, b: torch.Tensor, w: int,
            out: torch.Tensor, form) -> torch.Tensor:
    for what, t in (("first operand", first), ("b", b)):
        if t.device != b.device or t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{name} kernel takes {what} in "
                             f"{KERNEL_DTYPES} on {b.device}, got "
                             f"{t.dtype} on {t.device}")
    first, b = first.contiguous(), b.contiguous()
    bz, m, k = b.shape
    route = band_form(first.dtype, b.dtype, k)
    form = form or route
    if form not in ("ring", "simt") or (form == "ring" and route != "ring"):
        raise ValueError(f"{name}: no form {form!r} for {first.dtype} x "
                         f"{b.dtype} at k {k} (its route: {route!r})")
    p = _build.ptr
    if form == "ring":
        lib = _lib_ring()
        b = _aligned(b)
        if name == "g2bmm":
            first = _aligned(first)
        err = getattr(lib, name + "_ring")(
            p(first), p(b), p(out), b.dtype == torch.float32, bz, m, k, w,
            _build.stream())
        _build.raise_on(lib, err, name + "_ring")
        launches[name + "_ring"] += 1
    else:
        lib = _lib()
        err = getattr(lib, name)(
            p(first), first.dtype == torch.float32, p(b),
            b.dtype == torch.float32, p(out), bz, m, k, w, _build.stream())
        _build.raise_on(lib, err, name)
    launches[name] += 1
    return out


def _check(name, a, b, d):
    if a.dim() != 3 or b.dim() != 3 or a.shape[:2] != b.shape[:2]:
        raise ValueError(f"{name}: operands [bz, m, .] of one bz and m, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cuda" and d != 1:
        raise ValueError(f"{name} kernel takes dilation 1, got {d}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def g2bmm_band(a: torch.Tensor, b: torch.Tensor, w: int, d: int = 1,
               form: Optional[str] = None) -> torch.Tensor:
    """A [bz, m, k] x B [bz, m, k] -> band scores [bz, m, 2w + 1]; on the
    card in the form band_form chooses, or `form` ("ring", "simt")."""
    _check("g2bmm", a, b, d)
    if a.shape != b.shape:
        raise ValueError(f"g2bmm: A {tuple(a.shape)} and B "
                         f"{tuple(b.shape)} differ")
    if a.device.type == "cpu":
        return g2bmm_plain(a, b, w, d)
    out = torch.empty(a.shape[0], a.shape[1], 2 * w + 1, dtype=a.dtype,
                      device=a.device)
    return _launch("g2bmm", a, b, w, out, form)


def gbmm_band(wts: torch.Tensor, b: torch.Tensor, w: int, d: int = 1,
              form: Optional[str] = None) -> torch.Tensor:
    """Band weights [bz, m, 2w + 1] x B [bz, m, k] -> [bz, m, k]; on the
    card in the form band_form chooses, or `form` ("ring", "simt")."""
    _check("gbmm", wts, b, d)
    if wts.shape[2] != 2 * w + 1:
        raise ValueError(f"gbmm: {wts.shape[2]} band columns for w = {w}")
    if wts.device.type == "cpu":
        return gbmm_plain(wts, b, w, d)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    return _launch("gbmm", wts, b, w, out, form)
