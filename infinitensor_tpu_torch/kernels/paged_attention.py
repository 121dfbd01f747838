"""Paged decode attention: a pool of fixed-size KV pages plus a per-slot
block table (counterpart of infinitensor_tpu/kernels/paged_attention.py).

Pages are [N, Hkv, P, D] (bf16, or int8 with f32 scale pages [N, Hkv, P]);
block_table [B, MP] int32 holds each slot's page ids, and row s of slot b
lives in page block_table[b, s // P] at offset s % P. The append
(paged_append, paged_append_q8) is plain PyTorch and writes the new row IN
PLACE with one indexed assignment (index_put_) at device page ids and
offsets (the JAX package
donates the pool instead): no host read, so a decode step can be captured
in a CUDA graph. The read side is a kernel in csrc/paged_flash_decode.cu:
paged_flash_decode (float pages) replacing _paged_kernel,
paged_flash_decode_q8 (int8 pages) replacing _paged_q8_kernel;
paged_decode_plain and paged_decode_q8_plain are their plain versions
(gather to dense, masked GQA attention), which the CPU takes and nothing on
the card calls.

Two forms on the card, as for the dense decode attention
(attention.fast_form chooses): a bf16, f16 or f32 q over pages of its own
dtype or int8 at head dim 64 or 128 takes the fast kernels; a q dtype
other than the pages', or another head dim (a multiple of 8 from 8 to
256) takes the any-type form, csrc/attention_any.cuh
(paged_flash_decode_any). launches[name] counts both forms and
launches[name + "_any"] the any-type one again (captures, not CUDA-graph
replays).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from infinitensor_tpu_torch.kernels import _build
from infinitensor_tpu_torch.kernels.attention import (
    KINDS, MAX_REP, check_head_dim, fast_form, quantize_kv_row)

launches = collections.Counter()


@functools.cache
def _lib() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.typed("paged_flash_decode",
                        paged_flash_decode_q8=[P, I] + [P] * 7 + [I] * 6
                        + [F, P],
                        paged_flash_decode=[P, I] + [P] * 5 + [I] * 6
                        + [F, P],
                        paged_flash_decode_any=[P, I] + [P] * 4 + [I]
                        + [P] * 3 + [I] * 6 + [F, P])


def gather_pages(pages, block_table):
    """[N, Hkv, P, D], [B, MP] -> dense [B, Hkv, MP*P, D]."""
    g = pages[block_table.long()]               # [B, MP, Hkv, P, D]
    B, MP, Hkv, P, D = g.shape
    return g.transpose(1, 2).reshape(B, Hkv, MP * P, D)


def gather_scale_pages(scale_pages, block_table):
    """[N, Hkv, P], [B, MP] -> dense [B, Hkv, MP*P]."""
    g = scale_pages[block_table.long()]         # [B, MP, Hkv, P]
    B, MP, Hkv, P = g.shape
    return g.transpose(1, 2).reshape(B, Hkv, MP * P)


def _page_slots(block_table, pos, P: int):
    """The (page id, offset) [B] int64 of row pos[b] of each slot."""
    pos = pos.long()
    page_ids = torch.gather(block_table.long(), 1, (pos // P)[:, None])[:, 0]
    return page_ids, pos % P


def paged_append(k_pages, v_pages, k, v, block_table, pos):
    """Write new k/v [B, Hkv, 1, D] at per-slot positions, in place.

    block_table [B, MP] int32; pos [B] int32 (the slot's current length).
    Returns (k_pages, v_pages)."""
    page_ids, offs = _page_slots(block_table, pos, k_pages.shape[2])
    for pages, new in ((k_pages, k), (v_pages, v)):
        pages[page_ids, :, offs] = new[:, :, 0].to(pages.dtype)
    return k_pages, v_pages


def paged_append_q8(k_pages, v_pages, ks_pages, vs_pages, k, v,
                    block_table, pos):
    """INT8 variant of paged_append: quantize each new K/V row (per-(b,
    head) symmetric scale) and write the int8 row and its scale into the
    pools in place. ks/vs_pages [N, Hkv, P] f32."""
    page_ids, offs = _page_slots(block_table, pos, k_pages.shape[2])
    kq, ks = quantize_kv_row(k)                 # [B,Hkv,1,D] / [B,Hkv,1]
    vq, vs = quantize_kv_row(v)
    for pages, new in ((k_pages, kq), (v_pages, vq), (ks_pages, ks),
                       (vs_pages, vs)):
        pages[page_ids, :, offs] = new[:, :, 0].to(pages.dtype)
    return k_pages, v_pages, ks_pages, vs_pages


def _masked_gqa(q, kd, vd, pos, k_scale=None, v_scale=None):
    """q [B, H, 1, D]; kd/vd dense [B, Hkv, S, D] (with k_scale/v_scale
    [B, Hkv, S]: int8 codes); rows s <= pos[b] are attended, and rows past
    pos may hold anything (NaN included). The scales fold in as in the
    kernel: scores = (q . K) * (ks / sqrt(D)), out = (p * vs) . V."""
    B, H, _, D = q.shape
    Hkv, S = kd.shape[1], kd.shape[2]
    live = (torch.arange(S, device=q.device)[None, :]
            <= pos.to(q.device)[:, None])[:, None, :]           # [B, 1, S]
    kd = torch.where(live[..., None], kd.float(), 0.0)
    vd = torch.where(live[..., None], vd.float(), 0.0)
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qf, kd)
    scale = 1.0 / math.sqrt(D)
    if k_scale is not None:
        s = s * (torch.where(live, k_scale.float(), 0.0) * scale)[:, :, None]
    else:
        s = s * scale
    p = torch.softmax(torch.where(live[:, :, None], s, float("-inf")), -1)
    if v_scale is not None:
        p = p * torch.where(live, v_scale.float(), 0.0)[:, :, None]
    out = torch.einsum("bgrs,bgsd->bgrd", p, vd)
    return out.reshape(B, H, 1, D).to(q.dtype)


def paged_decode_plain(q, k_pages, v_pages, block_table, pos):
    """The TPU kernel's function, dense: gather the pages and run masked
    GQA attention in f32. q [B, H, 1, D]; pages [N, Hkv, P, D];
    block_table [B, MP]; pos [B] (attend to rows [0, pos]). Returns
    [B, H, 1, D] in q's dtype."""
    return _masked_gqa(q, gather_pages(k_pages, block_table),
                       gather_pages(v_pages, block_table), pos)


def paged_decode_q8_plain(q, k_pages, v_pages, ks_pages, vs_pages,
                          block_table, pos):
    """INT8 pages with f32 scale pages [N, Hkv, P]: gather, then masked GQA
    attention with the row scales folded into scores and probabilities."""
    return _masked_gqa(q, gather_pages(k_pages, block_table),
                       gather_pages(v_pages, block_table), pos,
                       gather_scale_pages(ks_pages, block_table),
                       gather_scale_pages(vs_pages, block_table))


def _check(name, q, k_pages, v_pages, block_table, pos, scales=()):
    """Shapes for every device; on the card also what a kernel takes: D a
    multiple of 8 from 8 to 256, H / Hkv <= 16, contiguous tensors of the
    expected types on q's device (q bf16, f16 or f32; float pages bf16,
    f16 or f32), 16-byte aligned pools, pool rows indexable in int32."""
    B, H, one, D = q.shape
    N, Hkv, P, Dk = k_pages.shape
    if one != 1 or Dk != D or H % Hkv or v_pages.shape != k_pages.shape \
            or block_table.ndim != 2 or block_table.shape[0] != B \
            or pos.shape != (B,) \
            or any(s.shape != (N, Hkv, P) for s in scales):
        raise ValueError(f"{name}: inconsistent shapes")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_head_dim(name, D)
    if H // Hkv > MAX_REP:
        raise ValueError(f"{name} kernel takes H/Hkv <= {MAX_REP}")
    if N * Hkv * P >= 2 ** 31:
        raise ValueError(f"{name}: the pool has too many rows")
    floats = (torch.bfloat16, torch.float16, torch.float32)
    page_dt = (torch.int8,) if scales else floats
    want = [("q", q, floats), ("k_pages", k_pages, page_dt),
            ("v_pages", v_pages, page_dt),
            ("block_table", block_table, (torch.int32,)),
            ("pos", pos, (torch.int32,))]
    want += [("scale pages", s, (torch.float32,)) for s in scales]
    for what, t, dt in want:
        if t.device != q.device or t.dtype not in dt \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous {dt} on {q.device}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages and v_pages must be 16-byte aligned")


def _launch(name, q, k_pages, v_pages, ks_pages, vs_pages, block_table,
            pos):
    """One launch on the card, in the form attention.fast_form picks."""
    B, H, _, D = q.shape
    _, Hkv, P, _ = k_pages.shape
    MP = block_table.shape[1]
    out = torch.empty_like(q)
    lib = _lib()
    p = _build.ptr
    fast = fast_form(q.dtype, k_pages.dtype, D)
    if not fast:
        err = lib.paged_flash_decode_any(
            p(q), KINDS[q.dtype], p(k_pages), p(v_pages), p(ks_pages),
            p(vs_pages), KINDS[k_pages.dtype], p(block_table), p(pos),
            p(out), B, H, Hkv, P, MP, D, 1.0 / math.sqrt(D), _build.stream())
    elif ks_pages is None:
        err = lib.paged_flash_decode(
            p(q), KINDS[q.dtype], p(k_pages), p(v_pages), p(block_table),
            p(pos), p(out), B, H, Hkv, P, MP, D, 1.0 / math.sqrt(D),
            _build.stream())
    else:
        err = lib.paged_flash_decode_q8(
            p(q), KINDS[q.dtype], p(k_pages), p(v_pages), p(ks_pages),
            p(vs_pages), p(block_table), p(pos), p(out), B, H, Hkv, P, MP, D,
            1.0 / math.sqrt(D), _build.stream())
    _build.raise_on(lib, err, name)
    launches[name] += 1
    if not fast:
        launches[name + "_any"] += 1
    return out


def paged_flash_decode(q, k_pages, v_pages, block_table, pos):
    """Paged flash decode over float pages already appended at pos. q
    [B, H, 1, D]; pages [N, Hkv, P, D]; block_table [B, MP] int32 page
    ids; pos [B] int32. Returns [B, H, 1, D] in q's dtype. CPU tensors take
    the plain version; CUDA tensors launch a kernel or raise: q bf16, f16
    or f32, pages bf16, f16 or f32, D a multiple of 8 from 8 to 256,
    H / Hkv <= 16, any page size."""
    _check("paged_flash_decode", q, k_pages, v_pages, block_table, pos)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_table, pos)
    return _launch("paged_flash_decode", q, k_pages, v_pages, None, None,
                   block_table, pos)


def paged_flash_decode_q8(q, k_pages, v_pages, ks_pages, vs_pages,
                          block_table, pos):
    """INT8 paged flash decode. q [B, H, 1, D] bf16, f16 or f32; pages
    int8 [N, Hkv, P, D]; scale pages f32 [N, Hkv, P]; block_table [B, MP]
    int32; pos [B] int32. Returns [B, H, 1, D] in q's dtype. CPU tensors
    take the plain version; CUDA tensors launch a kernel (D a multiple of
    8 from 8 to 256, H / Hkv <= 16) or raise."""
    _check("paged_flash_decode_q8", q, k_pages, v_pages, block_table, pos,
           (ks_pages, vs_pages))
    if q.device.type == "cpu":
        return paged_decode_q8_plain(q, k_pages, v_pages, ks_pages,
                                     vs_pages, block_table, pos)
    return _launch("paged_flash_decode_q8", q, k_pages, v_pages, ks_pages,
                   vs_pages, block_table, pos)
