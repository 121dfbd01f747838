"""Fused weight-only dequant + matmul for decode (counterpart of
infinitensor_tpu/kernels/quant_matmul.py).

Thirteen kernels, CUDA C++; nine over one group-dot body on the CUDA cores
(csrc/quant_matmul.cuh), four on the tensor cores:
  csrc/quant_matmul.cu
    qmm_group       <- _kernel_group       (group-partial dots, scale per group)
    qmm_group_norm  <- _kernel_group_norm  (RMSNorm fused ahead of the dots)
    qmm_w4a8        <- _kernel_group_w4a8  (int8 activations, int8 dots)
    qmm_norm_w4a8   <- _kernel_group_norm_w4a8 (RMSNorm ahead of qmm_w4a8)
  csrc/quant_matmul_fused.cu
    qmm_group_ln    <- _kernel_group_ln    (LayerNorm ahead, bias behind)
    qmm_slab        <- _kernel_group_slab  (paired int4 scales)
    qmm_slab_norm   <- _kernel_group_norm_slab (RMSNorm ahead of qmm_slab)
  csrc/quant_matmul_chunk.cu
    qmm_chunk       <- _kernel             (scales into bf16 weights, then dot)
    qmm_group2d     <- _kernel_group2d     (group dots split along K)
  csrc/quant_matmul_mma.cu
    qmm_group_mma   <- _kernel_group       (the same group dots on the
                                            tensor cores, mma.sync + cp.async)
    qmm_group_norm_mma <- _kernel_group_norm (an RMSNorm pre-pass, then
                                            that tile)
    qmm_group_ln_mma <- _kernel_group_ln   (a LayerNorm pre-pass, then
                                            that tile with the bias behind)
  csrc/quant_matmul_w4a8_mma.cu
    qmm_w4a8_mma    <- _kernel_group_w4a8  (a quantize pre-pass, then the
                                            int8 tensor cores, m16n8k32)

Four kernels have two forms on the card, one function each:
  qmm_group     a bf16 or f16 x without a norm at MMA_MIN_ROWS rows or
                more takes qmm_group_mma (group_form);
  qmm_group_norm  a bf16 x at MMA_MIN_ROWS rows or more takes
                qmm_group_norm_mma (group_form);
  qmm_group_ln  a bf16 x at MMA_MIN_ROWS rows or more takes
                qmm_group_ln_mma (ln_form);
  qmm_w4a8      a bf16 or f32 x at W4A8_MMA_MIN_ROWS rows or more takes
                qmm_w4a8_mma (w4a8_form);
any other launch takes the CUDA-core form. The thresholds are where the
two forms' times cross on the card (chip_smoke.py phase 3, PERF.md).
launches[name] counts both forms of a kernel and launches[name + "_mma"]
the tensor-core one again (qmm_group_ln_mma for qmm_group_ln,
qmm_group_norm_mma for qmm_group_norm).

A CUDA-core launch of qmm_group, qmm_slab or qmm_chunk without a fused
RMSNorm, or of qmm_group_ln, whose grid is short (wo and w_down at one
row are 32 blocks on 132 SMs, GPT-2's w_qkv and w_up 24 and 32) takes the
split form (csrc/quant_matmul.cuh, KSPLIT): group_splits blocks share
each tile and split K (with the LayerNorm, each takes the row's
statistics and normalizes its own slice), and the tile's last block to
finish sums their partials in a fixed order (then the bias), in one
launch; launches[name + "_split"] counts it again. The split count comes
from the shapes and the SM count only.

Each has a plain PyTorch version here that computes the same function step
by step (`*_plain`). A wrapper given a CPU tensor runs the plain version;
given a CUDA tensor it launches the kernel or raises. `launches` counts
kernel launches per kernel; under CUDA-graph replay it counts the capture,
not the replays.

The variant is chosen as the JAX package chooses it (quant_matmul.py:
511-530, 606-607, 651-710): a tuning table keyed "din:dout:bits" (the
file INFINITPU_QMM_TUNE names, else this package's own copy,
qmm_tune.json beside this module; a missing or unreadable file is an
empty table), read at every call. quant_matmul takes the caller's
`variant`, then the table entry's, then INFINITPU_QMM_VARIANT, then
"group"; quant_matmul_norm the table entry's, then the env var, then
"group". A table entry wins over the env var. Then, as in the JAX package:
a paired int4 weight takes the slab kernels whatever was asked, and
"slab" asked for an unpaired weight becomes "group"; "group2d" takes
qmm_group2d where the table entry has a `kb` (a multiple of the group
dividing the packed rows) and a `bn` dividing the physical columns, and
the group is a multiple of 128, else "group"; "group", "w4a8" and "slab"
on a group that is no multiple of 128 (or does not divide the packed
rows) become "chunk". quant_matmul_norm falls back to rmsnorm +
quant_matmul where its fused kernels do not apply. The table's `bn` is a
TPU tile: it is read only where the JAX package uses it to choose a route
(group2d's), never as a CUDA tile. Not carried over are the JAX package's
TPU-tile refusals (quant_matmul.py:708: `bn == 0`, no multiple of 128
dividing dout; `chunk % 128`, the chunk that _pick_chunk finds for the
VMEM budget): the CUDA kernels take any column count that is a multiple
of 4 and any group dividing the packed rows. A variant name outside
VARIANTS raises, where the JAX package would take its chunk kernel.

Above 256 rows (a long prompt), for a group that divides no packed row
count, and for an odd number of unpaired int4 scale rows the JAX package
takes no kernel: it dequantizes the weight and runs one matmul
(quant_matmul_ref, quant_matmul.py:39-41,599-604,708-710), with the "group"
semantics even for a shape tuned to w4a8. The wrappers follow that rule on
every device (weight_only.dequant_matmul) and count it in `launches` as
"dequant_matmul", a route and not a kernel of this package. So does a
weight whose physical columns are no multiple of 4 (the kernels read 4
adjacent columns at once; the JAX kernels refuse a dout with no 128-column
tile and take quant_matmul_ref, :693-710).

Activations: bf16, f16 or f32. On the card the kernels without a fused
norm take an f16 or f32 x and write x's type (one template parameter of
their x load, the x_kind of a launch), as the TPU kernels take any float x
and write x's type; an f16 x under "w4a8" takes qmm_group, as the JAX
package sends it to its group kernel (quant_matmul.py:704-705); the
fused-norm wrappers run norm + quant_matmul for a non-bf16 x, as the JAX
package does. On the CPU a non-bf16 x takes the JAX package's off-chip
math (quant_matmul.py:656-662): quant_matmul_w4a8_ref under the "w4a8"
variant (route "w4a8_ref"), else the dequant route, in x's dtype. Another
dtype (f64) on the card raises NotImplementedError.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import json
import os
from pathlib import Path
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.quant.weight_only import (
    QuantizedLinear, _unpack_nibbles, dequant_matmul, dequantize_weight,
)

TUNE_DEFAULT = str(Path(__file__).with_name("qmm_tune.json"))
VARIANTS = ("group", "w4a8", "slab", "chunk", "group2d")
KERNEL_MAX_ROWS = 256
# The fewest rows whose bf16 / f16 qmm_group launch (bf16 qmm_group_ln
# launch) takes the tensor-core form, and the same for a bf16 / f32
# qmm_w4a8 launch: chip_smoke.py phase 3 times both forms in one call
# (PERF.md).
MMA_MIN_ROWS = 2
W4A8_MMA_MIN_ROWS = 3
SPLIT_MAX = 8                   # blocks a tile of the split form
_SPLITS = None                  # when set, the split count of every launch
#                                 of the four kernels (1: the unsplit form)
_COUNTERS = {}                  # (device, stream) -> (capture id, counters)
X_KINDS = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

launches = collections.Counter()


@functools.lru_cache(maxsize=8)
def _load_tune(path: str) -> dict:
    """The tuning table at `path`; {} when it is missing or unreadable."""
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    return table if isinstance(table, dict) else {}


def _tuned(din: int, dout: int, bits: int) -> Optional[dict]:
    """The table entry for a weight shape (dout logical), or None."""
    path = os.environ.get("INFINITPU_QMM_TUNE", TUNE_DEFAULT)
    return _load_tune(path).get(f"{din}:{dout}:{bits}")


def _env_variant() -> str:
    return os.environ.get("INFINITPU_QMM_VARIANT", "group")


def _known(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    return variant


def _rows(x: torch.Tensor) -> int:
    return x.numel() // max(x.shape[-1], 1)


def _packed_rows(q: QuantizedLinear) -> int:
    return q.qweight.shape[0]


def _group_kernel_takes(q: QuantizedLinear) -> bool:
    """The group-dot kernels' condition (quant_matmul.py:360-363, 597-600,
    696): the group a multiple of 128 dividing the packed rows and, for
    unpaired int4, an even number of scale rows."""
    g = q.group_size
    return (g % 128 == 0 and _packed_rows(q) % g == 0
            and not (q.bits == 4 and not q.paired and q.scales.shape[0] % 2))


def _refusal(x: torch.Tensor, q: QuantizedLinear) -> Optional[str]:
    """Why no route of this module takes (x, q), or None."""
    din = x.shape[-1]
    if q.bits not in (4, 8):
        return f"bits={q.bits}: only 4 and 8"
    if din != q.in_features:
        return f"x has {din} features, weight {q.in_features}"
    if q.scales.shape[0] * q.group_size * (2 if q.paired else 1) != din:
        return (f"{q.scales.shape[0]} scale rows do not cover {din} "
                f"features in groups of {q.group_size}")
    if not x.dtype.is_floating_point:
        return f"x must be floating point, got {x.dtype}"
    return None


def _check(x: torch.Tensor, q: QuantizedLinear) -> None:
    """Raise on what no kernel takes; callers send more than
    KERNEL_MAX_ROWS rows to dequant_matmul instead."""
    why = _refusal(x, q)
    if why:
        raise ValueError(why)


def route(x: torch.Tensor, q: QuantizedLinear,
          variant: Optional[str] = None) -> tuple:
    """(name, kb): what quant_matmul(x, q, variant) runs, a kernel name,
    "dequant_matmul" or "w4a8_ref", and the split of qmm_group2d (else 0).
    Raises ValueError on what no route takes."""
    if _rows(x) > KERNEL_MAX_ROWS:
        return "dequant_matmul", 0
    _check(x, q)
    tuned = _tuned(x.shape[-1], q.out_features, q.bits) or {}
    variant = _known(variant or tuned.get("variant") or _env_variant())
    if x.dtype != torch.bfloat16 and x.device.type == "cpu":
        return ("w4a8_ref" if variant == "w4a8" else "dequant_matmul"), 0
    if q.out_physical % 4:
        return "dequant_matmul", 0
    if x.dtype not in X_KINDS:
        raise NotImplementedError(
            f"{x.dtype} activations: the matmul kernels take bf16, f16 "
            "and f32")
    g, kr = q.group_size, _packed_rows(q)
    if q.paired:
        variant = "slab"        # paired scales exist for the slab kernel
    elif variant == "slab":
        variant = "group"       # slab math needs the paired partition
    if variant == "group2d":
        kb, bn = int(tuned.get("kb", 0)), int(tuned.get("bn", 0))
        if (kb and bn and q.out_physical % bn == 0 and kb % g == 0
                and kr % kb == 0 and g % 128 == 0):
            return "qmm_group2d", kb
        variant = "group"
    if variant != "chunk" and not (g % 128 == 0 and kr % g == 0):
        variant = "chunk"
    if variant == "w4a8" and x.dtype == torch.float16:
        variant = "group"       # quant_matmul.py:704-705
    if (q.paired and variant != "slab") or kr % g or (
            q.bits == 4 and not q.paired and q.scales.shape[0] % 2):
        return "dequant_matmul", 0
    return "qmm_" + variant, 0


def _dequant_route(x: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    if x.shape[-1] != q.in_features:
        raise ValueError(f"x has {x.shape[-1]} features, weight "
                         f"{q.in_features}")
    launches["dequant_matmul"] += 1
    return dequant_matmul(x, q)


def quant_matmul_w4a8_ref(x: torch.Tensor, q: QuantizedLinear
                          ) -> torch.Tensor:
    """quant_matmul_w4a8_ref (quant_matmul.py:391-401): the per-row int8
    activations of quantize_rows_i8 times the weight dequantized in f32,
    in f32, times sx, rounded to x's dtype. x [..., din] -> [..., out]."""
    *lead, din = x.shape
    xq, sx = quantize_rows_i8(x.reshape(-1, din))
    w = dequantize_weight(q, dtype=torch.float32)
    out = (xq.float() @ w) * sx
    return out.to(x.dtype).reshape(*lead, q.out_features)


def _per_group(x2: torch.Tensor, q: QuantizedLinear, w_lo, w_hi):
    """Per-group partial dots of the split-half int4 layout:
    returns ([rows, ngh, dout_p] x_lo . w_lo, same for x_hi . w_hi, and
    sum(x_lo) per group [rows, ngh, 1]); inputs f32."""
    g = q.group_size
    half = q.qweight.shape[0]
    ngh = half // g
    rows = x2.shape[0]
    xl = x2[:, :half].reshape(rows, ngh, g)
    xh = x2[:, half:].reshape(rows, ngh, g)
    pd_lo = torch.einsum("rcg,cgo->rco", xl, w_lo.reshape(ngh, g, -1))
    pd_hi = torch.einsum("rcg,cgo->rco", xh, w_hi.reshape(ngh, g, -1))
    return pd_lo, pd_hi, xl.sum(-1, keepdim=True)


def qmm_group_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots step by step: x [rows, din] bf16, f16 or f32 -> [rows,
    dout_p] in x's dtype.
    int4: per group c, (x_lo . (u & 15) - 8 * sum(x_lo)) * s[c] +
    x_hi . (u & 0xF0) * s[ng/2 + c] / 16, f32 accumulation; int8:
    (x . w) * s[c]."""
    xf = x2.float()
    sc = q.scales.float()
    g = q.group_size
    if q.bits == 8:
        ng = q.qweight.shape[0] // g
        pd = torch.einsum("rcg,cgo->rco", xf.reshape(-1, ng, g),
                          q.qweight.float().reshape(ng, g, -1))
        return (pd * sc[None]).sum(1).to(x2.dtype)
    u = q.qweight
    lo8 = (u & 15).float()                 # lo + 8 (offset-binary)
    hi16 = (u & -16).float()               # 16 * hi
    pd_lo, pd_hi, sxl = _per_group(xf, q, lo8, hi16)
    ngh = pd_lo.shape[1]
    acc = (pd_lo - sxl * 8.0) * sc[None, :ngh] \
        + pd_hi * (sc[None, ngh:] * 0.0625)
    return acc.sum(1).to(x2.dtype)


def qmm_slab_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots_slab step by step, for a paired int4 weight: per packed
    group c one dot of [x_lo, x_hi / 16] (the /16 in bf16, exact) against
    [u & 15; u & 0xF0], minus 8 * sum(x_lo), times the one scale s[c]; f32
    accumulation. x [rows, din] bf16 or f32 -> [rows, dout_p] in x's
    dtype."""
    sc = q.scales.float()
    u = q.qweight
    x_hi = (x2[:, q.qweight.shape[0]:] * 0.0625).float()
    xf = torch.cat([x2[:, :q.qweight.shape[0]].float(), x_hi], dim=1)
    pd_lo, pd_hi, sxl = _per_group(xf, q, (u & 15).float(),
                                   (u & -16).float())
    acc = (pd_lo + pd_hi - sxl * 8.0) * sc[None]
    return acc.sum(1).to(x2.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """_kernel_group_ln's norm (quant_matmul.py:308-313; gpt2._ln is the
    same): f32 mean, f32 variance of x - mean, (x - mean) * rsqrt(var +
    eps) * gamma + beta in f32, rounded once to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def qmm_group_ln_plain(x2: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, q: QuantizedLinear,
                       bias: Optional[torch.Tensor], eps: float
                       ) -> torch.Tensor:
    """_kernel_group_ln step by step: LayerNorm rounded to bf16, the group
    dots rounded to bf16, then + bias (zero-padded to the physical
    columns) in f32, rounded again. -> [rows, dout_p] bf16."""
    out = qmm_group_plain(layer_norm(x2, gamma, beta, eps), q).float()
    if bias is not None:
        out[:, :bias.shape[-1]] += bias.float()
    return out.to(torch.bfloat16)


def rmsnorm_bf16(x2: torch.Tensor, norm_w: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """The fused kernels' norm (quant_matmul.py:92-95): f32 mean of
    squares, x * rsqrt(ms + eps) rounded to bf16, times the bf16 weight."""
    x32 = x2.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(torch.bfloat16) \
        * norm_w.to(torch.bfloat16)


def quantize_rows_i8(x2: torch.Tensor):
    """_quantize_rows_i8: per-row symmetric int8, sx = max(amax, 1e-30) *
    f32(1/127), round half to even, clip +-127. -> (xq int8, sx f32
    [rows, 1])."""
    x32 = x2.float()
    amax = x32.abs().amax(-1, keepdim=True)
    sx = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def qmm_w4a8_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_group_dots_w4a8 step by step: exact integer group dots (held in
    f64, which is exact at these magnitudes), rescaled in f32 per group by
    s_lo and s_hi / 16, times sx."""
    xq, sx = quantize_rows_i8(x2)
    sc = q.scales.float()
    g = q.group_size
    xd = xq.double()
    if q.bits == 8:
        ng = q.qweight.shape[0] // g
        pd = torch.einsum("rcg,cgo->rco", xd.reshape(-1, ng, g),
                          q.qweight.double().reshape(ng, g, -1))
        acc = (pd.float() * sc[None]).sum(1)
        return (acc * sx).to(x2.dtype)
    u = q.qweight
    pd_lo, pd_hi, sxl = _per_group(xd, q, (u & 15).double(),
                                   (u & -16).double())
    ngh = pd_lo.shape[1]
    acc = (pd_lo - sxl * 8).float() * sc[None, :ngh] \
        + pd_hi.float() * (sc[None, ngh:] * 0.0625)
    return (acc.sum(1) * sx).to(x2.dtype)


def qmm_norm_w4a8_plain(x2: torch.Tensor, norm_w: torch.Tensor,
                        q: QuantizedLinear, eps: float) -> torch.Tensor:
    """_kernel_group_norm_w4a8 step by step: the fused kernels' RMSNorm,
    then qmm_w4a8_plain on the normalized rows."""
    return qmm_w4a8_plain(rmsnorm_bf16(x2, norm_w, eps), q)


def _weight_values(q: QuantizedLinear) -> torch.Tensor:
    """The exact weight values [din, dout_p] as f32: int4 split halves
    lo = (u & 15) - 8 over hi = (u << 24) >> 28, int8 the plain cast."""
    if q.bits == 8:
        return q.qweight.float()
    lo, hi = _unpack_nibbles(q.qweight)
    return torch.cat([lo, hi], dim=0).float()


def qmm_chunk_plain(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    """_kernel step by step: each weight value times its group's scale in
    f32 (the scale as stored, bf16 or f32), rounded to bf16; then x . w in
    f32, rounded once. It shares no code with dequant_matmul, whose
    dequantize_weight rounds the scale to bf16 and multiplies in bf16:
    the two differ by a bf16 rounding for f32 scales. x [rows, din] ->
    [rows, dout_p] in x's dtype."""
    w = _weight_values(q)
    ng = q.scales.shape[0]
    w = (w.reshape(ng, q.group_size, -1) * q.scales.float()[:, None]
         ).reshape(w.shape).to(torch.bfloat16)
    return (x2.float() @ w.float()).to(x2.dtype)


def qmm_group2d_plain(x2: torch.Tensor, q: QuantizedLinear, kb: int
                      ) -> torch.Tensor:
    """_kernel_group2d step by step: per scale group, x . (exact weight
    values) in f32 times the group's scale; the groups of each split of kb
    packed rows summed into its partial, the partials summed in split
    order, rounded once to x's dtype. x [rows, din] bf16 or f32 ->
    [rows, dout_p]."""
    g, kr = q.group_size, _packed_rows(q)
    w = _weight_values(q)
    ng = w.shape[0] // g
    xf = x2.float()
    pd = torch.einsum("rcg,cgo->rco", xf.reshape(xf.shape[0], ng, g),
                      w.reshape(ng, g, -1)) * q.scales.float()[None]
    if q.bits == 4:                  # packed group c holds groups c, c + ngh
        ngh = ng // 2
        pd = pd[:, :ngh] + pd[:, ngh:]
    per_split = pd.reshape(pd.shape[0], kr // kb, kb // g, -1).sum(2)
    out = per_split[:, 0]
    for k in range(1, kr // kb):
        out = out + per_split[:, k]
    return out.to(x2.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    lib = _build.typed(
        "quant_matmul",
        qmm_group=[P, I, P, P, P, I, P, I, I, I, I, I, I, F, I, P, P, P],
        qmm_w4a8=[P, I, P, P, I, P, I, I, I, I, I, P],
        qmm_norm_w4a8=[P, P, P, P, I, P, I, I, I, I, I, F, P])
    lib.itt_capture_id.argtypes = [P]
    lib.itt_capture_id.restype = ctypes.c_ulonglong
    return lib


@functools.cache
def _lib_fused() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed(
        "quant_matmul_fused",
        qmm_group_ln=[P, P, P, I, P, P, I, P, I, I, P, I, I, I, I, I, F, I, P,
                      P, P],
        qmm_slab=[P, I, P, P, P, I, P, I, I, I, I, I, F, I, P, P, P])


@functools.cache
def _lib_mma() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed(
        "quant_matmul_mma",
        qmm_group_mma=[P, I, P, P, I, P, P, I, I, I, I, I, I, I, P],
        qmm_group_norm_mma=[P, P, P, P, P, I, P, P, I, I, I, I, I, F, I, I,
                            P],
        qmm_group_ln_mma=[P, P, P, I, P, P, P, I, P, I, I, P, P, I, I, I, I,
                          I, F, I, I, P])


@functools.cache
def _lib_w4a8_mma() -> ctypes.CDLL:
    P, I = _build.P, _build.I
    return _build.typed(
        "quant_matmul_w4a8_mma",
        qmm_w4a8_mma=[P, I, P, P, P, P, I, P, P, I, I, I, I, I, I, I, P])


@functools.cache
def _lib_chunk() -> ctypes.CDLL:
    P, I = _build.P, _build.I
    return _build.typed(
        "quant_matmul_chunk",
        qmm_chunk=[P, I, P, P, I, P, I, I, I, I, I, I, P, P, P],
        qmm_group2d=[P, I, P, P, I, P, P, I, I, I, I, I, I, P])


def _check_cuda(x2: torch.Tensor, q: QuantizedLinear) -> None:
    for name, t in (("x", x2), ("qweight", q.qweight), ("scales", q.scales)):
        if t.device != x2.device:
            raise ValueError(f"{name} on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.qweight.dtype != torch.int8 or q.qweight.data_ptr() % 16:
        raise ValueError("qweight must be 16-byte aligned int8")
    if q.scales.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"scales must be bf16 or f32, got {q.scales.dtype}")


def _out(x2: torch.Tensor, q: QuantizedLinear) -> torch.Tensor:
    return torch.empty(x2.shape[0], q.out_physical, dtype=x2.dtype,
                       device=x2.device)


def _x_kind(x2: torch.Tensor) -> int:
    """The x_kind of a launch (common.cuh: kXBf16, kXF16, kXF32); the
    fused-norm launches take bf16."""
    return X_KINDS[x2.dtype]


def group_form(rows: int, dtype: torch.dtype, norm: bool) -> str:
    """Which form a qmm_group launch on the card takes: "mma" (the
    tensor cores, csrc/quant_matmul_mma.cu) at MMA_MIN_ROWS rows or more
    for a bf16 or f16 x without a norm and for a bf16 x with the fused
    RMSNorm (qmm_group_norm: a pre-pass, then the same tile), else
    "cuda_core" (csrc/quant_matmul.cuh; an f32 x stays there, as rounding
    it to 16 bits would change its numbers)."""
    if rows >= MMA_MIN_ROWS and (dtype == torch.bfloat16 or (
            dtype == torch.float16 and not norm)):
        return "mma"
    return "cuda_core"


def ln_form(rows: int, dtype: torch.dtype) -> str:
    """Which form a qmm_group_ln launch on the card takes: "mma" (a
    LayerNorm pre-pass and qmm_group_mma's tile, csrc/quant_matmul_mma.cu)
    for a bf16 x at MMA_MIN_ROWS rows or more, else "cuda_core"
    (csrc/quant_matmul_fused.cu)."""
    return "mma" if dtype == torch.bfloat16 and rows >= MMA_MIN_ROWS \
        else "cuda_core"


def w4a8_form(rows: int, dtype: torch.dtype) -> str:
    """Which form a qmm_w4a8 launch on the card takes: "mma" (the int8
    tensor cores, csrc/quant_matmul_w4a8_mma.cu) for a bf16 or f32 x at
    W4A8_MMA_MIN_ROWS rows or more, else "cuda_core" (csrc/quant_matmul.cu;
    an f16 x takes qmm_group, route)."""
    return "mma" if dtype in (torch.bfloat16, torch.float32) \
        and rows >= W4A8_MMA_MIN_ROWS else "cuda_core"


MMA_COLS = 128                  # output columns of a block (kBN)
MMA_ROW_TILES = (8, 16, 32, 64)  # rows of a block the C entries take


def mma_plan(rows: int, dout_p: int, krows: int, group: int, sms: int
             ) -> tuple:
    """(row_tile, splits) of a launch of the tensor-core tile
    (qmm_group_mma, qmm_group_ln_mma, qmm_w4a8_mma), the fastest of the
    variants timed on the card: rows per block 8 or 16 up to that many
    rows, 32 up to 64 rows, 64 above; and the number of blocks K is split
    across, by whole scale groups (at most one split a group), so that
    column tiles x row tiles x splits reach 2 blocks per SM (1 for the
    64-row tile, whose partials cost more than its extra blocks gain)."""
    tile = 8 if rows <= 8 else 16 if rows <= 16 else 32 if rows <= 64 \
        else 64
    target = sms if tile == 64 else 2 * sms
    blocks = -(-dout_p // MMA_COLS) * -(-rows // tile)
    splits = 1 if blocks >= target else min(krows // group,
                                            -(-target // blocks))
    return tile, splits


def _split_rows(rows: int) -> int:
    """Rows a block of the split form holds (csrc ksplit_rows)."""
    return 4 if rows >= 4 else 2 if rows >= 2 else 1


def group_splits(rows: int, dout_p: int, krows: int, group: int, sms: int
                 ) -> int:
    """The split count of a CUDA-core launch of qmm_group, qmm_slab or
    qmm_chunk without a norm, or of qmm_group_ln (1: the unsplit form):
    the largest power of two that keeps column tiles x row blocks x
    splits within twice the SMs (a 1- or 2-row block fits twice an SM),
    at most SPLIT_MAX and at most the scale groups (packed rows //
    group). Past that a second wave
    costs more than the split gains. A 4-row block (4 rows and more) is
    not split: at 8 rows the split lost to the unsplit form on wo and
    w_down (chip_smoke.py phase 3's split crossover), its partials being
    4x a 1-row block's. From shapes only, so one captured graph serves
    every step."""
    r = _split_rows(rows)
    if r == 4:
        return 1
    blocks = -(-dout_p // MMA_COLS) * -(-rows // r)
    splits = 1
    while blocks * 2 * splits <= 2 * sms and 2 * splits <= min(
            SPLIT_MAX, krows // group):
        splits *= 2
    return splits


def _split_plan(x2: torch.Tensor, q: QuantizedLinear) -> tuple:
    """(splits, part, counters) of a launch of the four kernels on this
    card: _SPLITS where set, else group_splits; for the split form its
    f32 partials [splits, rows, dout_p] and _counters, else None, None."""
    rows, dout_p = x2.shape[0], q.out_physical
    splits = _SPLITS or group_splits(rows, dout_p, _packed_rows(q),
                                     q.group_size,
                                     _build.sms(x2.device.index or 0))
    if splits == 1:
        return 1, None, None
    part = torch.empty(splits, rows, dout_p, dtype=torch.float32,
                       device=x2.device)
    need = -(-dout_p // MMA_COLS) * -(-rows // _split_rows(rows))
    return splits, part, _counters(x2.device, need)


def _counters(device: torch.device, need: int) -> torch.Tensor:
    """The split form's tile counters (int32, one per tile and row block)
    for a launch on the current stream: zero between launches, as the
    kernel's last block sets its counter back. Two launches that share
    counters must not overlap, so each stream has its own, made once and
    kept; inside a graph capture each capture has its own, made (its
    zeroing a node of the graph) at its first split launch on that
    stream and held until the next capture there."""
    stream = torch.cuda.current_stream(device).cuda_stream
    capture = _lib().itt_capture_id(ctypes.c_void_p(stream)) \
        if torch.cuda.is_current_stream_capturing() else 0
    key = (device.index or 0, stream)
    have = _COUNTERS.get(key)
    if have is None or have[0] != capture or have[1].numel() < need:
        have = capture, torch.zeros(max(need, 4096), dtype=torch.int32,
                                    device=device)
        _COUNTERS[key] = have
    return have[1]


def _launched_split(lib, err: int, name: str, out: torch.Tensor,
                    splits: int) -> torch.Tensor:
    _launched(lib, err, name, out)
    if splits > 1:
        launches[name + "_split"] += 1
    return out


def _tile_plan(x2: torch.Tensor, q: QuantizedLinear) -> tuple:
    """(row_tile, splits, part) of a launch of the tensor-core tile:
    mma_plan on this card, and the f32 partials [splits, rows, dout_p]
    where K is split (else None)."""
    rows, dout_p = x2.shape[0], q.out_physical
    tile, splits = mma_plan(rows, dout_p, _packed_rows(q), q.group_size,
                            _build.sms(x2.device.index or 0))
    part = None if splits == 1 else torch.empty(
        splits, rows, dout_p, dtype=torch.float32, device=x2.device)
    return tile, splits, part


def _launched(lib: ctypes.CDLL, err: int, name: str, out: torch.Tensor
              ) -> torch.Tensor:
    _build.raise_on(lib, err, name)
    launches[name] += 1
    return out


def _launch_group(x2, norm_w, q, eps: float, name: str,
                  form: Optional[str] = None) -> torch.Tensor:
    """qmm_group (qmm_group_norm with norm_w) in the form group_form
    chooses; `form` forces "mma" or "cuda_core" (tests and chip_smoke.py's
    side-by-side timing only)."""
    _check_cuda(x2, q)
    norm = norm_w is not None
    form = form or group_form(x2.shape[0], x2.dtype, norm)
    if form == "mma":
        if norm:
            return _launch_group_norm_mma(x2, norm_w, q, eps)
        return _launch_group_mma(x2, q, name)
    splits, part, counters = (1, None, None) if norm else _split_plan(x2, q)
    out, lib, p = _out(x2, q), _lib(), _build.ptr
    err = lib.qmm_group(
        p(x2), _x_kind(x2), p(norm_w), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(out), x2.shape[0], x2.shape[1],
        q.out_physical, q.bits, q.group_size, norm_w is not None, eps,
        splits, p(part), p(counters), _build.stream())
    return _launched_split(lib, err, name, out, splits)


def _launch_group_mma(x2, q, name: str) -> torch.Tensor:
    if x2.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"qmm_group_mma takes a bf16 or f16 x, not "
                         f"{x2.dtype}")
    if x2.data_ptr() % 16:
        x2 = x2.clone()                 # cp.async reads 16-byte chunks
    tile, splits, part = _tile_plan(x2, q)
    out, lib, p = _out(x2, q), _lib_mma(), _build.ptr
    err = lib.qmm_group_mma(
        p(x2), _x_kind(x2), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(part), p(out), x2.shape[0],
        x2.shape[1], q.out_physical, q.bits, q.group_size, tile, splits,
        _build.stream())
    _launched(lib, err, name, out)
    launches["qmm_group_mma"] += 1
    return out


def _launch_group_norm_mma(x2, norm_w, q, eps: float,
                           xn: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """qmm_group_norm's tensor-core form: the RMSNorm pre-pass writes the
    rows normalized to `xn` (bf16 like x2; a buffer of its own unless
    given, as a test does to read it), then qmm_group_mma's tile."""
    if x2.dtype != torch.bfloat16 or norm_w.dtype != torch.bfloat16:
        raise ValueError(f"qmm_group_norm_mma takes a bf16 x and norm "
                         f"weight, not {x2.dtype} and {norm_w.dtype}")
    if norm_w.device != x2.device or not norm_w.is_contiguous():
        raise ValueError(f"norm_w must be contiguous on {x2.device}")
    xn = torch.empty_like(x2) if xn is None else xn
    if xn.shape != x2.shape or xn.dtype != x2.dtype or \
            not xn.is_contiguous() or xn.data_ptr() % 16:
        raise ValueError("xn must be a contiguous, 16-byte aligned bf16 "
                         f"buffer of x's shape {tuple(x2.shape)}")
    tile, splits, part = _tile_plan(x2, q)
    out, lib, p = _out(x2, q), _lib_mma(), _build.ptr
    err = lib.qmm_group_norm_mma(
        p(x2), p(norm_w), p(xn), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(part), p(out), x2.shape[0],
        x2.shape[1], q.out_physical, q.bits, q.group_size, eps, tile,
        splits, _build.stream())
    _launched(lib, err, "qmm_group_norm", out)
    launches["qmm_group_norm_mma"] += 1
    return out


def _launch_slab(x2, norm_w, q, eps: float, name: str) -> torch.Tensor:
    _check_cuda(x2, q)
    splits, part, counters = (1, None, None) if norm_w is not None \
        else _split_plan(x2, q)
    out, lib, p = _out(x2, q), _lib_fused(), _build.ptr
    err = lib.qmm_slab(
        p(x2), _x_kind(x2), p(norm_w), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(out), x2.shape[0], x2.shape[1],
        q.out_physical, q.group_size, norm_w is not None, eps, splits,
        p(part), p(counters), _build.stream())
    return _launched_split(lib, err, name, out, splits)


def _launch_group_ln(x2, gamma, beta, q, bias, eps: float,
                     form: Optional[str] = None) -> torch.Tensor:
    """qmm_group_ln in the form ln_form chooses; `form` forces "mma" or
    "cuda_core" (tests and chip_smoke.py's side-by-side timing only). The
    CUDA-core form takes _split_plan's K split on a short grid."""
    _check_cuda(x2, q)
    for name, t in (("gamma", gamma), ("beta", beta), ("bias", bias)):
        if t is not None and (t.device != x2.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x2.device}")
    if bias is not None and (
            bias.dtype not in (torch.bfloat16, torch.float32)
            or bias.shape[-1] > q.out_physical):
        raise ValueError(f"bias {bias.dtype} {tuple(bias.shape)}: bf16 or "
                         f"f32, at most {q.out_physical} columns")
    if (form or ln_form(x2.shape[0], x2.dtype)) == "mma":
        return _launch_group_ln_mma(x2, gamma, beta, q, bias, eps)
    splits, part, counters = _split_plan(x2, q)
    out, lib, p = _out(x2, q), _lib_fused(), _build.ptr
    err = lib.qmm_group_ln(
        p(x2), p(gamma), p(beta), gamma.dtype == torch.bfloat16,
        p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(bias),
        bias is not None and bias.dtype == torch.bfloat16,
        0 if bias is None else bias.shape[-1], p(out), x2.shape[0],
        x2.shape[1], q.out_physical, q.bits, q.group_size, eps, splits,
        p(part), p(counters), _build.stream())
    return _launched_split(lib, err, "qmm_group_ln", out, splits)


def _launch_group_ln_mma(x2, gamma, beta, q, bias, eps: float
                         ) -> torch.Tensor:
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"qmm_group_ln_mma takes a bf16 x, not {x2.dtype}")
    tile, splits, part = _tile_plan(x2, q)
    xn = torch.empty_like(x2)           # the normalized rows (pre-pass)
    out, lib, p = _out(x2, q), _lib_mma(), _build.ptr
    err = lib.qmm_group_ln_mma(
        p(x2), p(gamma), p(beta), gamma.dtype == torch.bfloat16, p(xn),
        p(q.qweight), p(q.scales), q.scales.dtype == torch.bfloat16,
        p(bias), bias is not None and bias.dtype == torch.bfloat16,
        0 if bias is None else bias.shape[-1], p(part), p(out), x2.shape[0],
        x2.shape[1], q.out_physical, q.bits, q.group_size, eps, tile,
        splits, _build.stream())
    _launched(lib, err, "qmm_group_ln", out)
    launches["qmm_group_ln_mma"] += 1
    return out


def _launch_w4a8(x2, q, norm_w=None, eps: float = 0.0,
                 form: Optional[str] = None) -> torch.Tensor:
    """qmm_w4a8 in the form w4a8_form chooses (`form` forces "mma" or
    "cuda_core": tests and chip_smoke.py's side-by-side timing only), or
    with norm_w qmm_norm_w4a8 (CUDA cores)."""
    _check_cuda(x2, q)
    if norm_w is None and (form or w4a8_form(x2.shape[0], x2.dtype)) \
            == "mma":
        return _launch_w4a8_mma(x2, q)
    out, lib, p = _out(x2, q), _lib(), _build.ptr
    shape = (x2.shape[0], x2.shape[1], q.out_physical, q.bits, q.group_size)
    sc_bf16 = q.scales.dtype == torch.bfloat16
    if norm_w is None:
        err = lib.qmm_w4a8(p(x2), _x_kind(x2), p(q.qweight), p(q.scales),
                           sc_bf16, p(out), *shape, _build.stream())
        return _launched(lib, err, "qmm_w4a8", out)
    err = lib.qmm_norm_w4a8(p(x2), p(norm_w), p(q.qweight), p(q.scales),
                            sc_bf16, p(out), *shape, eps, _build.stream())
    return _launched(lib, err, "qmm_norm_w4a8", out)


def _launch_w4a8_mma(x2, q) -> torch.Tensor:
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmm_w4a8_mma takes a bf16 or f32 x, not "
                         f"{x2.dtype}")
    tile, splits, part = _tile_plan(x2, q)
    # the quantized rows and their scales (pre-pass)
    xq = torch.empty(x2.shape, dtype=torch.int8, device=x2.device)
    sx = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    out, lib, p = _out(x2, q), _lib_w4a8_mma(), _build.ptr
    err = lib.qmm_w4a8_mma(
        p(x2), _x_kind(x2), p(xq), p(sx), p(q.qweight), p(q.scales),
        q.scales.dtype == torch.bfloat16, p(part), p(out), x2.shape[0],
        x2.shape[1], q.out_physical, q.bits, q.group_size, tile, splits,
        _build.stream())
    _launched(lib, err, "qmm_w4a8", out)
    launches["qmm_w4a8_mma"] += 1
    return out


def _launch_chunk(x2, q) -> torch.Tensor:
    _check_cuda(x2, q)
    splits, part, counters = _split_plan(x2, q)
    out, lib, p = _out(x2, q), _lib_chunk(), _build.ptr
    err = lib.qmm_chunk(p(x2), _x_kind(x2), p(q.qweight), p(q.scales),
                        q.scales.dtype == torch.bfloat16, p(out), x2.shape[0],
                        x2.shape[1], q.out_physical, q.bits, q.group_size,
                        splits, p(part), p(counters), _build.stream())
    return _launched_split(lib, err, "qmm_chunk", out, splits)


def _launch_group2d(x2, q, kb: int) -> torch.Tensor:
    _check_cuda(x2, q)
    out, lib, p = _out(x2, q), _lib_chunk(), _build.ptr
    part = torch.empty(_packed_rows(q) // kb, x2.shape[0], q.out_physical,
                       dtype=torch.float32, device=x2.device)
    err = lib.qmm_group2d(p(x2), _x_kind(x2), p(q.qweight), p(q.scales),
                          q.scales.dtype == torch.bfloat16, p(part), p(out),
                          x2.shape[0], x2.shape[1], q.out_physical, q.bits,
                          q.group_size, kb, _build.stream())
    return _launched(lib, err, "qmm_group2d", out)


def _dispatch(x2: torch.Tensor, plain, launch):
    if x2.device.type == "cpu":
        return plain()
    if x2.device.type == "cuda":
        return launch()
    raise ValueError(f"unsupported device {x2.device}")


def quant_matmul(x: torch.Tensor, q: QuantizedLinear,
                 variant: Optional[str] = None) -> torch.Tensor:
    """x [..., din] (bf16, f16 or f32) @ q -> [..., out_features] in x's
    dtype.

    variant: one of VARIANTS or None (the table entry for the shape, then
    INFINITPU_QMM_VARIANT, then "group"); `route` says what runs."""
    *lead, din = x.shape
    name, kb = route(x, q, variant)
    if name == "dequant_matmul":
        return _dequant_route(x, q)
    if name == "w4a8_ref":
        launches["w4a8_ref"] += 1
        return quant_matmul_w4a8_ref(x, q)
    x2 = x.reshape(-1, din).contiguous()
    if name == "qmm_slab":
        out = _dispatch(x2, lambda: qmm_slab_plain(x2, q),
                        lambda: _launch_slab(x2, None, q, 0.0, name))
    elif name == "qmm_group":
        out = _dispatch(x2, lambda: qmm_group_plain(x2, q),
                        lambda: _launch_group(x2, None, q, 0.0, name))
    elif name == "qmm_w4a8":
        out = _dispatch(x2, lambda: qmm_w4a8_plain(x2, q),
                        lambda: _launch_w4a8(x2, q))
    elif name == "qmm_chunk":
        out = _dispatch(x2, lambda: qmm_chunk_plain(x2, q),
                        lambda: _launch_chunk(x2, q))
    else:
        out = _dispatch(x2, lambda: qmm_group2d_plain(x2, q, kb),
                        lambda: _launch_group2d(x2, q, kb))
    return out[:, :q.out_features].reshape(*lead, q.out_features)


def _rmsnorm(x: torch.Tensor, norm_w: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """The JAX fallback's norm (quant_matmul.py:568-570): f32 mean of
    squares, x * rsqrt(ms + eps) rounded to x's dtype, times norm_w;
    rmsnorm_bf16 for a bf16 x and a bf16 norm_w."""
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * norm_w


def quant_matmul_norm(x: torch.Tensor, norm_w: torch.Tensor,
                      q: QuantizedLinear, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(x) * norm_w @ q with the norm fused into the kernel; x is
    the raw residual stream [..., din] bf16.

    The variant is the table entry's, then INFINITPU_QMM_VARIANT's, then
    "group": a paired weight takes qmm_slab_norm, "w4a8" qmm_norm_w4a8,
    any other but "slab" qmm_group_norm. What the fused kernels do not
    take (quant_matmul.py:599-604, 610-612: more than KERNEL_MAX_ROWS rows,
    a group that is no multiple of 128 or does not divide the packed rows,
    an odd number of unpaired int4 scale rows, a non-bf16 x, "slab" for an
    unpaired weight) runs rmsnorm + quant_matmul, as in the JAX package."""
    *lead, din = x.shape

    def fallback():
        return quant_matmul(_rmsnorm(x, norm_w, eps), q)

    if (_rows(x) > KERNEL_MAX_ROWS or x.dtype != torch.bfloat16
            or not _group_kernel_takes(q)):
        return fallback()
    _check(x, q)
    tuned = _tuned(din, q.out_features, q.bits) or {}
    variant = _known(tuned.get("variant") or _env_variant())
    if variant == "slab" and not q.paired:
        return fallback()
    x2 = x.reshape(-1, din).contiguous()
    nw = norm_w.to(torch.bfloat16).contiguous()
    if q.paired:
        out = _dispatch(
            x2, lambda: qmm_slab_plain(rmsnorm_bf16(x2, nw, eps), q),
            lambda: _launch_slab(x2, nw, q, eps, "qmm_slab_norm"))
    elif variant == "w4a8":
        out = _dispatch(x2, lambda: qmm_norm_w4a8_plain(x2, nw, q, eps),
                        lambda: _launch_w4a8(x2, q, nw, eps))
    else:
        out = _dispatch(
            x2, lambda: qmm_group_plain(rmsnorm_bf16(x2, nw, eps), q),
            lambda: _launch_group(x2, nw, q, eps, "qmm_group_norm"))
    return out[:, :q.out_features].reshape(*lead, q.out_features)


def quant_matmul_ln(x: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, q: QuantizedLinear,
                    bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x; gamma, beta) @ q + bias in one kernel (GPT-2 decode's
    pattern); x is the raw residual stream [..., din] bf16. gamma and beta
    are read as bf16 or f32 and used in f32, as the TPU kernel reads them.

    What _kernel_group_ln does not take (quant_matmul.py:359-365: more
    than KERNEL_MAX_ROWS rows, a paired int4 weight, a group that is no
    multiple of 128, a non-bf16 x) runs the exact composition, as in the
    JAX package: layer_norm, then quant_matmul (qmm_group, qmm_slab or
    qmm_chunk on the card, the dequant route above KERNEL_MAX_ROWS rows),
    then + bias."""
    *lead, din = x.shape
    if (_rows(x) > KERNEL_MAX_ROWS or q.paired or x.dtype != torch.bfloat16
            or not _group_kernel_takes(q)):
        out = quant_matmul(layer_norm(x, gamma, beta, eps), q)
        return out if bias is None else out + bias
    _check(x, q)
    x2 = x.reshape(-1, din).contiguous()
    if gamma.dtype != torch.bfloat16 or beta.dtype != torch.bfloat16:
        gamma, beta = gamma.float(), beta.float()     # exact; read as f32
    gamma, beta = gamma.contiguous(), beta.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = _dispatch(
        x2, lambda: qmm_group_ln_plain(x2, gamma, beta, q, bias, eps),
        lambda: _launch_group_ln(x2, gamma, beta, q, bias, eps))
    return out[:, :q.out_features].reshape(*lead, q.out_features)
