"""Decode attention with cache append, over a float or an INT8 KV cache
(counterpart of infinitensor_tpu/kernels/attention.py:37-160,395-476).

The cache is a static [B, Hkv, S_max, D] buffer: bf16, or int8 with
per-(b, h, s) f32 scales. The append (_append_kv, and quantize_kv_row for
int8) is plain PyTorch and writes the new row IN PLACE with scatter_ at
`pos` (the JAX package donates the buffer instead); `pos` stays a device
tensor throughout, so a decode step can be captured in a CUDA graph. The
read side is a kernel in csrc/flash_decode.cu: flash_decode (float cache)
replacing _flash_decode_hb_kernel, flash_decode_q8 (int8 cache) replacing
_flash_decode_q8_hb_kernel; *_plain are their plain versions. At few
(batch, kv head) blocks both take their split form: the rows of a head are
split across decode_splits(...) blocks, which write partial (acc, m, l),
and flash_decode_merge (a second kernel) combines them; *_split_plain and
flash_decode_merge_plain are the plain versions of the two steps.

Two forms on the card (fast_form chooses). A bf16, f16 or f32 q over a
cache of its own dtype or int8 at head dim 64 or 128 takes the fast
kernels above; a q dtype other than the cache's, or another head dim D (a
multiple of 8 from 8 to 256) takes the any-type form,
csrc/attention_any.cuh (flash_decode_any, flash_decode_merge_any), as the
TPU kernels take any float type and head dim and write q's dtype.
launches[name] counts both forms and launches[name + "_any"] the any-type
one again. `launches` counts kernel launches (captures, not CUDA-graph
replays).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from infinitensor_tpu_torch.kernels import _build

launches = collections.Counter()
FAST_HEAD_DIMS = (64, 128)       # the fast kernels of csrc/flash_decode.cu
FAST_DTYPES = (torch.bfloat16, torch.float16)   # flash_attention's
FAST_DECODE_DTYPES = FAST_DTYPES + (torch.float32,)   # the fast decode's q
MAX_FAST_PREFILL_D = 128         # flash_attention's: D a multiple of 8 up to it
MAX_HEAD_DIM = 256               # the any-type form: D % 8 == 0, 8 <= D <= 256
MAX_REP = 16                     # query heads a kv head, both forms
# The kind codes of the C entries (csrc/common.cuh): q and out in bf16,
# f16 or f32; a cache in those or int8 (with f32 row scales).
KINDS = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
         torch.int8: 3}
# The split form: a head's rows are split so that the launch has about
# SPLIT_BLOCKS_PER_SM blocks an SM (so at most SPLIT_BLOCKS_PER_SM * sms
# / 2 heads, B * Hkv, are split; more fill the card unsplit), each split
# at least SPLIT_MIN_ROWS rows of the cache's S, at most SPLIT_MAX splits
# (past 16 the 8-head GQA launch is no faster). The crossover behind all
# three: chip_smoke.py phase 3.
SPLIT_BLOCKS_PER_SM = 2
SPLIT_MIN_ROWS = 64
SPLIT_MAX = 16
MAX_SPLITS = 64                  # the fast merge takes at most D splits
_SPLITS = None                   # when set, the split count of every launch


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("flash_decode",
                        flash_decode_q8=[P, I] + [P] * 7 + [I] * 6 + [F, P],
                        flash_decode=[P, I] + [P] * 5 + [I] * 6 + [F, P],
                        flash_decode_merge=[P, P] + [I] * 4 + [P],
                        flash_decode_any=[P, I] + [P] * 4 + [I] + [P] * 3
                        + [I] * 6 + [F, P],
                        flash_decode_merge_any=[P, P] + [I] * 4 + [P])


def fast_form(q_dtype, cache_dtype, D: int) -> bool:
    """Whether a decode-attention launch takes the fast kernels (a bf16,
    f16 or f32 q over a cache of its own dtype or int8, at D 64 or 128),
    else the any-type form."""
    return (q_dtype in FAST_DECODE_DTYPES and D in FAST_HEAD_DIMS
            and cache_dtype in (q_dtype, torch.int8))


def fast_prefill(dtype, D: int) -> bool:
    """Whether a flash_attention launch (q, k and v of one dtype, D a
    multiple of 8) takes the tensor-core kernel (bf16 or f16, D up to
    MAX_FAST_PREFILL_D), else the any-type form."""
    return dtype in FAST_DTYPES and D <= MAX_FAST_PREFILL_D


def check_head_dim(name: str, D: int) -> None:
    """Refuse a head dim no form takes: D a multiple of 8 from 8 to
    MAX_HEAD_DIM."""
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel takes a head dim D that is a "
                         f"multiple of 8 from 8 to {MAX_HEAD_DIM}, not {D}")


def decode_splits(B: int, Hkv: int, S: int, sms: int) -> int:
    """Splits of a dense decode-attention launch of B * Hkv heads over a
    cache of S rows on a card of `sms` SMs: 1 is the unsplit form. From
    shapes only, never from pos: the launch may sit in a captured CUDA
    graph while pos moves."""
    return max(1, min(SPLIT_BLOCKS_PER_SM * sms // (B * Hkv),
                      S // SPLIT_MIN_ROWS, SPLIT_MAX))


def launch_splits(B: int, Hkv: int, S: int, index: int = 0) -> int:
    """The split count a dense decode-attention launch of this shape takes
    on card `index`: _SPLITS where set, else decode_splits."""
    return _SPLITS or decode_splits(B, Hkv, S, _build.sms(index))


def merge_launches(calls: int, B: int, Hkv: int, S: int,
                   index: int = 0) -> dict:
    """What `calls` dense decode-attention launches of this shape add to
    `launches` beside their own counts: one flash_decode_merge each in the
    split form."""
    split = launch_splits(B, Hkv, S, index) > 1
    return {"flash_decode_merge": calls} if split else {}


def _normalize_pos(pos, batch: int) -> torch.Tensor:
    """pos (scalar or [B]) -> int32 [batch]; a length other than batch
    broadcasts its first entry."""
    pos = torch.as_tensor(pos).reshape(-1).to(torch.int32)
    if pos.shape[0] != batch:
        pos = pos[:1].expand(batch).contiguous()
    return pos


def quantize_kv_row(x: torch.Tensor):
    """Per-(batch, head) symmetric int8 quantization of one K/V row
    [B, Hkv, 1, D] -> (int8 row, scale [B, Hkv, 1]); scale =
    max(absmax / 127, 1e-8), round half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.round(x32 / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _append_kv(k_cache, v_cache, k, v, pos):
    """Write k/v [B, H, 1, D] at row pos[b] of each batch's cache, in
    place (scatter_), and return the caches."""
    idx = pos.to(torch.int64).view(-1, 1, 1, 1).expand(
        k.shape[0], k.shape[1], 1, k.shape[3])
    k_cache.scatter_(2, idx, k.to(k_cache.dtype))
    v_cache.scatter_(2, idx, v.to(v_cache.dtype))
    return k_cache, v_cache


def _append_scale(scale_cache, s, pos):
    idx = pos.to(torch.int64).view(-1, 1, 1).expand(s.shape[0], s.shape[1], 1)
    scale_cache.scatter_(2, idx, s.to(scale_cache.dtype))
    return scale_cache


def decode_attention_gqa(k_cache, v_cache, q, k, v, pos):
    """Grouped-query decode attention over a bf16 cache: caches [B, Hkv, S,
    D]; q [B, H, 1, D] (H = Hkv * rep); k/v [B, Hkv, 1, D]; pos [B] (the
    row the new k/v go to, attended inclusively). The caches are updated in
    place. Returns (out [B, H, 1, D], k_cache, v_cache)."""
    pos = _normalize_pos(pos, k_cache.shape[0]).to(k_cache.device)
    _append_kv(k_cache, v_cache, k, v, pos)
    out = flash_decode(q.contiguous(), k_cache, v_cache, pos)
    return out, k_cache, v_cache


def decode_attention(k_cache, v_cache, q, k, v, pos):
    """MHA decode (H == Hkv): append + flash_decode."""
    return decode_attention_gqa(k_cache, v_cache, q, k, v, pos)


def decode_attention_gqa_q8(k_cache, v_cache, k_scale, v_scale, q, k, v,
                            pos):
    """INT8-KV-cache decode attention: caches int8 [B, Hkv, S, D], scales
    f32 [B, Hkv, S]; q [B, H, 1, D] bf16; k/v [B, Hkv, 1, D]; pos [B]
    (the row the new k/v go to, attended inclusively). The caches are
    updated in place. Returns (out [B, H, 1, D], k_cache, v_cache,
    k_scale, v_scale)."""
    B = k_cache.shape[0]
    pos = _normalize_pos(pos, B).to(k_cache.device)
    kq, ks = quantize_kv_row(k)
    vq, vs = quantize_kv_row(v)
    _append_kv(k_cache, v_cache, kq, vq, pos)
    _append_scale(k_scale, ks, pos)
    _append_scale(v_scale, vs, pos)
    out = flash_decode_q8(q.contiguous(), k_cache, v_cache, k_scale,
                          v_scale, pos)
    return out, k_cache, v_cache, k_scale, v_scale


def _live(S: int, pos, device) -> torch.Tensor:
    """[B, 1, 1, S] mask of the cache rows s <= pos[b]."""
    rows = torch.arange(S, device=device)[None, :] <= pos.to(device)[:, None]
    return rows[:, None, None, :]


def flash_decode_plain(q, k_cache, v_cache, pos):
    """The TPU kernel's function, dense: scores = (q . K) / sqrt(D) in f32
    over rows s <= pos, softmax, p . V. Returns [B, H, 1, D] in q's
    dtype."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    p = torch.softmax(torch.where(_live(S, pos, q.device), s,
                                  float("-inf")), dim=-1)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def flash_decode_q8_plain(q, k_cache, v_cache, k_scale, v_scale, pos):
    """The TPU kernel's function, dense: scores = q . K_int8 * (ks / sqrt(D))
    over rows s <= pos, softmax, (p * vs) . V_int8. Returns [B, H, 1, D]
    in q's dtype."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float())
    s = s * (k_scale.float() * scale)[:, :, None, :]
    p = torch.softmax(torch.where(_live(S, pos, q.device), s,
                                  float("-inf")), dim=-1)
    pv = p * v_scale.float()[:, :, None, :]
    out = torch.einsum("bgrs,bgsd->bgrd", pv, v_cache.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def _split_partials(s, vals, pos, splits):
    """s [B, Hkv, rep, S] f32 scores (scaled), vals [B, Hkv, S, D] f32 ->
    part [B, H, splits, D + 2]: split j of row b takes rows [j n / splits,
    (j + 1) n / splits) of n = pos[b] + 1; its unnormalized acc = p . vals,
    m = the split's max score (-inf if empty), l = sum p (0 if empty)."""
    B, G, R, S = s.shape
    n = pos.to(s.device, torch.int64).clamp(0, S - 1) + 1
    edges = torch.arange(splits + 1, device=s.device)[None] * n[:, None] \
        // splits                                           # [B, splits+1]
    rows = torch.arange(S, device=s.device)
    inside = (rows >= edges[:, :-1, None]) & (rows < edges[:, 1:, None])
    sj = torch.where(inside[:, None, None], s[:, :, :, None, :],
                     float("-inf"))                      # [B, G, R, ns, S]
    m = sj.amax(-1)
    p = torch.exp(sj - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    acc = torch.einsum("bgrjs,bgsd->bgrjd", p, vals)
    part = torch.cat([acc, m[..., None], p.sum(-1)[..., None]], -1)
    return part.reshape(B, G * R, splits, -1)


def flash_decode_split_plain(q, k_cache, v_cache, pos, splits):
    """The split form's first step, plain: flash_decode_plain's scores,
    each split's partial [B, H, splits, D + 2] f32 (acc, m, l)."""
    B, H, _, D = q.shape
    Hkv = k_cache.shape[1]
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    return _split_partials(s, v_cache.float(), pos, splits)


def flash_decode_q8_split_plain(q, k_cache, v_cache, k_scale, v_scale, pos,
                                splits):
    """As flash_decode_split_plain over the INT8 cache: scores q . K_int8 *
    (ks / sqrt(D)), acc = (p * vs) . V_int8."""
    B, H, _, D = q.shape
    Hkv = k_cache.shape[1]
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, k_cache.float())
    s = s * (k_scale.float() * (1.0 / math.sqrt(D)))[:, :, None, :]
    return _split_partials(s, v_cache.float() * v_scale.float()[..., None],
                           pos, splits)


def flash_decode_merge_plain(part):
    """part [B, H, splits, D + 2] -> [B, H, 1, D] f32: the splits with l > 0
    combined, sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M)."""
    D = part.shape[-1] - 2
    acc, m, l = part[..., :D], part[..., D], part[..., D + 1]
    live = l > 0
    mx = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    out = (acc * w[..., None]).sum(-2) / (l * w).sum(-1, keepdim=True)
    return out[:, :, None]


def flash_decode_merge(part, dtype=torch.bfloat16):
    """The split form's second step: part f32 [B, H, splits, D + 2] ->
    [B, H, 1, D] in `dtype` (q's). CPU tensors take
    flash_decode_merge_plain; CUDA tensors launch the kernel or raise: the
    fast merge for a bf16 or f16 out at D 64 or 128 and at most MAX_SPLITS
    splits (f32 too), else flash_decode_merge_any (any D from 8 to 256, a
    multiple of 8)."""
    B, H, splits, D2 = part.shape
    D = D2 - 2
    if part.device.type == "cpu":
        return flash_decode_merge_plain(part).to(dtype)
    check_head_dim("flash_decode_merge", D)
    if part.dtype != torch.float32 or not part.is_contiguous() \
            or dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError("flash_decode_merge takes contiguous f32 partials "
                         "and a bf16, f16 or f32 out")
    out = torch.empty(B, H, 1, D, dtype=dtype, device=part.device)
    lib = _lib()
    fast = fast_form(dtype, dtype, D) and splits <= MAX_SPLITS
    if fast:
        err = lib.flash_decode_merge(_build.ptr(part), _build.ptr(out),
                                     KINDS[dtype], B * H, splits, D,
                                     _build.stream())
    else:
        err = lib.flash_decode_merge_any(_build.ptr(part), _build.ptr(out),
                                         KINDS[dtype], B * H, splits, D,
                                         _build.stream())
    _build.raise_on(lib, err, "flash_decode_merge")
    launches["flash_decode_merge"] += 1
    if not fast:
        launches["flash_decode_merge_any"] += 1
    return out


def _check_launch(name, q, pos, tensors) -> None:
    """Refuse on the card what no form takes: D a multiple of 8 from 8 to
    MAX_HEAD_DIM, H / Hkv <= MAX_REP, contiguous tensors of the expected
    types on q's device (a bf16, f16 or f32 q; a tuple of types allows
    any of them), pos [B], 16-byte aligned caches."""
    B, H, _, D = q.shape
    Hkv = tensors["k_cache"][0].shape[1]
    check_head_dim(name, D)
    if H // Hkv > MAX_REP:
        raise ValueError(f"{name} kernel takes H/Hkv <= {MAX_REP}")
    floats = (torch.bfloat16, torch.float16, torch.float32)
    tensors = {"q": (q, floats), "pos": (pos, torch.int32), **tensors}
    for what, (t, dt) in tensors.items():
        ok = t.dtype in dt if isinstance(dt, tuple) else t.dtype == dt
        if t.device != q.device or not ok or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous {dt} on {q.device}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be [{B}]")
    if any(tensors[c][0].data_ptr() % 16 for c in ("k_cache", "v_cache")):
        raise ValueError("k_cache and v_cache must be 16-byte aligned")


def _check_shapes(name, q, k_cache, v_cache) -> None:
    B, H, _, D = q.shape
    Bk, Hkv, _, Dk = k_cache.shape
    if (Bk, Dk) != (B, D) or H % Hkv or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: inconsistent shapes")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _outputs(q, k_cache, splits):
    """(splits, out, part) of a launch: the split count (launch_splits on
    this card unless forced), then out in q's dtype for the unsplit form
    or the f32 partials for the split form (the other None)."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    if splits is None:
        splits = launch_splits(B, Hkv, S, q.device.index or 0)
    if splits == 1:
        return 1, torch.empty_like(q), None
    return splits, None, torch.empty(B, H, splits, D + 2,
                                     dtype=torch.float32, device=q.device)


def _launch(name, q, k_cache, v_cache, k_scale, v_scale, pos, splits):
    """One launch of the dense decode attention on the card, in the form
    fast_form picks, then the merge where it was split."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    splits, out, part = _outputs(q, k_cache, splits)
    lib = _lib()
    p = _build.ptr
    fast = fast_form(q.dtype, k_cache.dtype, D)
    if not fast:
        err = lib.flash_decode_any(
            p(q), KINDS[q.dtype], p(k_cache), p(v_cache), p(k_scale),
            p(v_scale), KINDS[k_cache.dtype], p(pos), p(out), p(part), B, H,
            Hkv, S, D, splits, 1.0 / math.sqrt(D), _build.stream())
    elif k_scale is None:
        err = lib.flash_decode(p(q), KINDS[q.dtype], p(k_cache), p(v_cache),
                               p(pos), p(out), p(part), B, H, Hkv, S, D,
                               splits, 1.0 / math.sqrt(D), _build.stream())
    else:
        err = lib.flash_decode_q8(
            p(q), KINDS[q.dtype], p(k_cache), p(v_cache), p(k_scale),
            p(v_scale), p(pos), p(out), p(part), B, H, Hkv, S, D, splits,
            1.0 / math.sqrt(D), _build.stream())
    _build.raise_on(lib, err, name)
    launches[name] += 1
    if not fast:
        launches[name + "_any"] += 1
    return out if part is None else flash_decode_merge(part, q.dtype)


def flash_decode(q, k_cache, v_cache, pos, *, _splits=None):
    """Float-cache flash decode over caches already appended at pos [B]
    int32. q [B, H, 1, D] -> [B, H, 1, D] in q's dtype. CPU tensors take
    the plain version; CUDA tensors launch a kernel or raise: q in bf16,
    f16 or f32, the cache in bf16, f16 or f32, D a multiple of 8 from 8 to
    256, H / Hkv <= 16 (the fast kernel for a bf16, f16 or f32 q over a
    cache of its dtype at D 64 or 128, else the any-type form), in the
    split form
    with its merge where decode_splits (or the private _splits) is above
    1."""
    _check_shapes("flash_decode", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, pos)
    floats = (torch.bfloat16, torch.float16, torch.float32)
    _check_launch("flash_decode", q, pos, {"k_cache": (k_cache, floats),
                                           "v_cache": (v_cache, floats)})
    return _launch("flash_decode", q, k_cache, v_cache, None, None, pos,
                   _splits)


def flash_decode_q8(q, k_cache, v_cache, k_scale, v_scale, pos, *,
                    _splits=None):
    """INT8-KV flash decode over caches already appended at pos [B] int32.
    q [B, H, 1, D] -> [B, H, 1, D] in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch a kernel or raise: q in bf16, f16
    or f32, D a multiple of 8 from 8 to 256, H / Hkv <= 16 (the fast
    kernel at D 64 or 128, else the any-type form), in
    the split form with its merge where decode_splits (or the private
    _splits) is above 1."""
    _check_shapes("flash_decode_q8", q, k_cache, v_cache)
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    if k_scale.shape != (B, Hkv, S) or v_scale.shape != (B, Hkv, S):
        raise ValueError("flash_decode_q8: inconsistent shapes")
    if q.device.type == "cpu":
        return flash_decode_q8_plain(q, k_cache, v_cache, k_scale, v_scale,
                                     pos)
    _check_launch("flash_decode_q8", q, pos,
                  {"k_cache": (k_cache, torch.int8),
                   "v_cache": (v_cache, torch.int8),
                   "k_scale": (k_scale, torch.float32),
                   "v_scale": (v_scale, torch.float32)})
    return _launch("flash_decode_q8", q, k_cache, v_cache, k_scale, v_scale,
                   pos, _splits)
