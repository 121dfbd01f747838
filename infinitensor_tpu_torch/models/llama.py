"""Llama-family forward passes (counterpart of
infinitensor_tpu/models/llama.py).

Plain functions on tensors; parameters are a dict laid out like the JAX
pytree (params["layers"][i]["wqkv"], ...), with QuantizedLinear leaves.
The slices ported here are prompt -> generate with INT4/INT8 weight-only
matmuls over a bf16 or an INT8 KV cache:

  greedy_generate -> llama_prefill -> _block_prefill x L
      (rmsnorm; _qkv unfused: quant_matmul, or dequant_matmul above 256
       rows; rope at [0, S); cache rows [0, S) written in place;
       flash_attention on the unquantized k/v, kv heads repeated for GQA;
       wo; rmsnorm; _mlp)
    -> rmsnorm -> lm_head (all S positions) -> argmax of the last
  -> llama_decode_multi -> llama_decode_step -> _block_decode x L
      (_qkv: fused RMSNorm + wqkv, quant_matmul_norm;
       decode_attention_gqa (bf16 cache: append + flash_decode) or
       decode_attention_gqa_q8 (INT8 cache: append + flash_decode_q8);
       wo: quant_matmul; _mlp: fused RMSNorm + w_gateup, w_down)
    -> rmsnorm -> lm_head (quant_matmul, W4A8 at the 7B shape) -> argmax.
With quantize_llama_params(paired=True) weights every one of those matmuls
takes the slab kernels instead (qmm_slab_norm, qmm_slab), the lm_head too.

llama_verify_step (speculative verification) is plain torch, as the JAX
package leaves it to XLA. The KV cache is updated IN PLACE (the JAX
package donates it instead), and a decode step's `pos` stays a device
int32 tensor, so on the card one step captures into a CUDA graph.

A paged cache ("k_pages", init_paged_kv_cache) sends llama_decode_step
through _block_decode_paged: rmsnorm and the projections UNFUSED (as the
JAX package has it: wqkv and w_gateup take quant_matmul, not
quant_matmul_norm), paged_append(_q8) and paged_flash_decode(_q8) over the
page pool and the device block table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels.attention import (
    decode_attention_gqa, decode_attention_gqa_q8, quantize_kv_row,
)
from infinitensor_tpu_torch.kernels.flash_attention import flash_attention
from infinitensor_tpu_torch.kernels.paged_attention import (
    paged_append, paged_append_q8, paged_flash_decode, paged_flash_decode_q8,
)
from infinitensor_tpu_torch.kernels.quant_matmul import quant_matmul_norm
from infinitensor_tpu_torch.quant.weight_only import (
    QuantizedLinear, concat_qlinear, quantize_weight, wo_matmul,
)
from infinitensor_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_70b(**kw) -> "LlamaConfig":
        return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                           intermediate=28672, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                           n_kv_heads=2, intermediate=128, max_seq=64, **kw)


def init_llama_params(cfg: LlamaConfig, generator: torch.Generator,
                      device=None, dtype=None) -> dict:
    """Random dense parameters (normal / sqrt(din)); `generator` must
    live on `device`."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def dense(din, dout):
        w = torch.randn(din, dout, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * (1.0 / math.sqrt(din))).to(dtype)

    kvd = cfg.n_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": torch.ones(cfg.dim, dtype=dtype, device=device),
            "wq": dense(cfg.dim, cfg.dim),
            "wk": dense(cfg.dim, kvd),
            "wv": dense(cfg.dim, kvd),
            "wo": dense(cfg.dim, cfg.dim),
            "mlp_norm": torch.ones(cfg.dim, dtype=dtype, device=device),
            "w_gate": dense(cfg.dim, cfg.intermediate),
            "w_up": dense(cfg.dim, cfg.intermediate),
            "w_down": dense(cfg.intermediate, cfg.dim),
        })
    return {
        "embed": dense(cfg.vocab_size, cfg.dim),
        "final_norm": torch.ones(cfg.dim, dtype=dtype, device=device),
        "lm_head": dense(cfg.dim, cfg.vocab_size),
        "layers": layers,
    }


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llama_params(params: dict, bits: int = 8,
                          group_size: Optional[int] = None,
                          fuse: bool = True, paired: bool = False) -> dict:
    """Weight-only quantize every layer matmul and the lm_head.

    fuse concatenates Q/K/V and gate/up into "wqkv" and "w_gateup" (fewer,
    larger decode kernels); without it the layers keep wq/wk/wv and
    w_gate/w_up. paired (int4 only, ignored for int8): one scale row per
    pair of split-half groups, the layout the slab kernels read."""
    kw = {"paired": True} if (paired and bits == 4) else {}
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": quantize_weight(params["lm_head"], bits, group_size,
                                      **kw),
           "layers": []}
    for layer in params["layers"]:
        ql = {k: v for k, v in layer.items() if k not in _QUANT_KEYS}
        qw = {k: quantize_weight(layer[k], bits, group_size, **kw)
              for k in _QUANT_KEYS}
        if fuse:
            ql["wqkv"] = concat_qlinear(qw["wq"], qw["wk"], qw["wv"])
            ql["w_gateup"] = concat_qlinear(qw["w_gate"], qw["w_up"])
            ql["wo"] = qw["wo"]
            ql["w_down"] = qw["w_down"]
        else:
            ql.update(qw)
        out["layers"].append(ql)
    return out


def _linear(x, w):
    if isinstance(w, QuantizedLinear):
        return wo_matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _linear_norm(x, norm_w, w, eps):
    """rmsnorm(x) * norm_w @ w; fused into the matmul kernel for quantized
    weights when dim >= 512, as the JAX package does on its chip."""
    if isinstance(w, QuantizedLinear) and x.shape[-1] >= 512:
        return quant_matmul_norm(x, norm_w, w, eps=eps)
    return _linear(rmsnorm(x, norm_w, eps), w)


def rmsnorm(x, w, eps):
    x32 = x.float()
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps)).to(x.dtype) * w


def rope(x, pos, theta: float):
    """Rotate-half RoPE. x [B, S, H, D]; pos [B, S] int32."""
    D = x.shape[-1]
    half = D // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) * 2.0 / D
    inv_freq = torch.pow(float(theta), exponent)
    ang = pos.float()[:, :, None, None] * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def init_kv_cache(cfg: LlamaConfig, batch: int,
                  max_seq: Optional[int] = None, dtype=None,
                  kv_quant: bool = False, *, device=None) -> dict:
    """Per-layer K/V [B, Hkv, S, D] in `dtype` (default cfg.dtype); with
    kv_quant, int8 K/V plus f32 scales [B, Hkv, S]."""
    device = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(cfg.n_layers)]

    if not kv_quant:
        dtype = dtype or cfg.dtype
        return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
            "k_scale": zeros(shape[:-1], torch.float32),
            "v_scale": zeros(shape[:-1], torch.float32)}


def init_paged_kv_cache(cfg: LlamaConfig, n_pages: int, page_size: int,
                        max_slots: int, max_seq: Optional[int] = None,
                        dtype=None, kv_quant: bool = False, *,
                        device=None) -> dict:
    """Paged cache dict (serving/paged_cache.py manages the host-side free
    list): per-layer "k_pages"/"v_pages" [N, Hkv, P, D] and one
    "block_table" [max_slots, ceil(max_seq / P)] int32. llama_decode_step
    dispatches on "k_pages"; kv_quant makes the pages int8 and adds per-row
    f32 scale pages "ks_pages"/"vs_pages" [N, Hkv, P]."""
    from infinitensor_tpu_torch.serving.paged_cache import init_paged_cache
    device = resolve_device(device)
    c = init_paged_cache(cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                         cfg.head_dim, max_slots, max_seq or cfg.max_seq,
                         torch.int8 if kv_quant else (dtype or cfg.dtype),
                         device=device)
    out = {"k_pages": c.k_pages, "v_pages": c.v_pages,
           "block_table": c.block_table}
    if kv_quant:
        sshape = (n_pages, cfg.n_kv_heads, page_size)
        for key in ("ks_pages", "vs_pages"):
            out[key] = [torch.zeros(sshape, dtype=torch.float32,
                                    device=device)
                        for _ in range(cfg.n_layers)]
    return out


def _qkv(cfg, layer, h, norm_w=None, eps=1e-5):
    """Project to q/k/v, through the fused QKV matrix when present. With
    norm_w given, h is the RAW residual and the rmsnorm fuses into the
    matmul (_linear_norm)."""
    B, S, _ = h.shape
    kvd = cfg.n_kv_heads * cfg.head_dim

    def lin(w):
        if norm_w is not None:
            return _linear_norm(h, norm_w, w, eps)
        return _linear(h, w)

    if "wqkv" in layer:
        qkv = lin(layer["wqkv"])
        q = qkv[..., :cfg.dim]
        k = qkv[..., cfg.dim:cfg.dim + kvd]
        v = qkv[..., cfg.dim + kvd:]
    else:
        q, k, v = lin(layer["wq"]), lin(layer["wk"]), lin(layer["wv"])
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def _mlp(cfg, layer, h2, norm_w=None, eps=1e-5):
    """SwiGLU MLP; with norm_w given, h2 is the RAW residual and the
    rmsnorm fuses into the gate/up matmul."""
    def lin(w):
        if norm_w is not None:
            return _linear_norm(h2, norm_w, w, eps)
        return _linear(h2, w)

    if "w_gateup" in layer:
        gu = lin(layer["w_gateup"]).float()
        gate, up = gu[..., :cfg.intermediate], gu[..., cfg.intermediate:]
    else:
        gate, up = lin(layer["w_gate"]).float(), lin(layer["w_up"]).float()
    gate = torch.nn.functional.silu(gate)
    return _linear((gate * up).to(h2.dtype), layer["w_down"])


def _block_decode(cfg, layer, x, pos, cache_k, cache_v, k_scale=None,
                  v_scale=None):
    """x [B, 1, dim]; pos [B]; cache [B, Hkv, Smax, D], bf16 or (with
    k_scale/v_scale [B, Hkv, Smax]) INT8, appended in place at pos."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, layer, x, layer["attn_norm"], cfg.norm_eps)
    pos2 = pos[:, None]
    q = rope(q, pos2, cfg.rope_theta)
    k = rope(k, pos2, cfg.rope_theta)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if k_scale is not None:
        out, *_ = decode_attention_gqa_q8(cache_k, cache_v, k_scale, v_scale,
                                          qh, kh, vh, pos)
    else:
        out, *_ = decode_attention_gqa(cache_k, cache_v, qh, kh, vh, pos)
    attn = out.transpose(1, 2).reshape(B, 1, cfg.dim)
    x = x + _linear(attn, layer["wo"])
    return x + _mlp(cfg, layer, x, layer["mlp_norm"], cfg.norm_eps)


def _block_decode_paged(cfg, layer, x, pos, k_pages, v_pages, table,
                        ks_pages=None, vs_pages=None):
    """Decode block against a paged KV cache (kernels/paged_attention.py):
    x [B, 1, dim]; pos [B]; pages [N, Hkv, P, D], appended in place; table
    [B, MP] int32. With ks_pages/vs_pages the pages are INT8 with per-row
    f32 scales. The norms are not fused into the matmuls here."""
    B = x.shape[0]
    h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, layer, h)
    pos2 = pos[:, None]
    q = rope(q, pos2, cfg.rope_theta)
    k = rope(k, pos2, cfg.rope_theta)
    qh = q.transpose(1, 2).contiguous()
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if ks_pages is not None:
        paged_append_q8(k_pages, v_pages, ks_pages, vs_pages, kh, vh, table,
                        pos)
        out = paged_flash_decode_q8(qh, k_pages, v_pages, ks_pages, vs_pages,
                                    table, pos)
    else:
        paged_append(k_pages, v_pages, kh, vh, table, pos)
        out = paged_flash_decode(qh, k_pages, v_pages, table, pos)
    attn = out.transpose(1, 2).reshape(B, 1, cfg.dim)
    x = x + _linear(attn, layer["wo"])
    h2 = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + _mlp(cfg, layer, h2)


def _embed(params, tokens):
    """tokens [...] -> [..., dim]."""
    x = params["embed"].index_select(0, tokens.reshape(-1))
    return x.reshape(*tokens.shape, x.shape[-1])


def _layer_caches(cache, i):
    """Layer i's (k, v, k_scale, v_scale); the scales are None for a bf16
    cache."""
    quant = "k_scale" in cache
    return (cache["k"][i], cache["v"][i],
            cache["k_scale"][i] if quant else None,
            cache["v_scale"][i] if quant else None)


def _block_prefill(cfg, layer, x, pos, cache_k, cache_v, k_scale=None,
                   v_scale=None):
    """x [B, S, dim]; pos [B, S] = [0, S). Writes the cache rows [0, S)
    in place (quantized per row for an INT8 cache) and attends with
    flash_attention on the unquantized k/v."""
    B, S, _ = x.shape
    h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, layer, h)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # [B, Hkv, S, D]
    if k_scale is not None:
        kq, ks = quantize_kv_row(kh)
        vq, vs = quantize_kv_row(vh)
        for buf, new in ((cache_k, kq), (cache_v, vq), (k_scale, ks),
                         (v_scale, vs)):
            buf[:, :, :S].copy_(new)
    else:
        cache_k[:, :, :S].copy_(kh)
        cache_v[:, :, :S].copy_(vh)
    rep = cfg.n_heads // cfg.n_kv_heads
    kf = kh.repeat_interleave(rep, dim=1) if rep > 1 else kh
    vf = vh.repeat_interleave(rep, dim=1) if rep > 1 else vh
    attn = flash_attention(q.transpose(1, 2).contiguous(), kf.contiguous(),
                           vf.contiguous(), causal=True)
    x = x + _linear(attn.transpose(1, 2).reshape(B, S, cfg.dim),
                    layer["wo"])
    h2 = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + _mlp(cfg, layer, h2)


def llama_prefill(params, cfg: LlamaConfig, tokens, cache):
    """tokens [B, S] int32 -> (logits [B, S, vocab], cache); the cache
    rows [0, S) are written in place."""
    B, S = tokens.shape
    if S > cache["k"][0].shape[2]:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's "
                         f"{cache['k'][0].shape[2]} rows")
    x = _embed(params, tokens)
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, S)
    for i, layer in enumerate(params["layers"]):
        x = _block_prefill(cfg, layer, x, pos, *_layer_caches(cache, i))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["lm_head"]), cache


def llama_decode_step(params, cfg: LlamaConfig, token, pos, cache):
    """One decode step. token [B] int32, pos [B] int32 (write positions).

    Returns (logits [B, vocab], cache); the cache dict (dense bf16, dense
    INT8 with "k_scale", or paged with "k_pages" and "block_table") is the
    one passed in, its tensors updated in place."""
    x = _embed(params, token)[:, None, :]
    paged = "k_pages" in cache
    q8 = "ks_pages" in cache
    for i, layer in enumerate(params["layers"]):
        if paged:
            x = _block_decode_paged(
                cfg, layer, x, pos, cache["k_pages"][i], cache["v_pages"][i],
                cache["block_table"], cache["ks_pages"][i] if q8 else None,
                cache["vs_pages"][i] if q8 else None)
        else:
            x = _block_decode(cfg, layer, x, pos, *_layer_caches(cache, i))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x[:, 0], params["lm_head"]), cache


def _attention(q, k, v, mask):
    """q [B, S, H, D], k/v [B, T, Hkv, D], mask [B, S, T] -> [B, S, H, D];
    GQA by grouping the query heads, f32 scores and softmax."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, D)
    scores = torch.einsum("bshrd,bthd->bhrst", qf, k.float()) / math.sqrt(D)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrst,bthd->bshrd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _block_verify(cfg, layer, x, positions, cache_k, cache_v, k_scale=None,
                  v_scale=None):
    """Multi-token decode block for speculative verification. x [B, K,
    dim]; positions [B, K] = pos0[:, None] + arange(K). Writes the K/V rows
    of all K positions in place, then each token attends to the cache rows
    <= its own position."""
    B, K, _ = x.shape
    S = cache_k.shape[2]
    h = rmsnorm(x, layer["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, layer, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # [B, Hkv, K, D]
    rows = positions.to(torch.int64)[:, None, :].expand(B, kh.shape[1], K)
    idx = rows[..., None].expand(*rows.shape, kh.shape[3])
    if k_scale is not None:
        kq, ks = quantize_kv_row(kh)
        vq, vs = quantize_kv_row(vh)
        cache_k.scatter_(2, idx, kq)
        cache_v.scatter_(2, idx, vq)
        k_scale.scatter_(2, rows, ks)
        v_scale.scatter_(2, rows, vs)
        kf = (cache_k.float() * k_scale[..., None]).to(q.dtype)
        vf = (cache_v.float() * v_scale[..., None]).to(q.dtype)
    else:
        cache_k.scatter_(2, idx, kh.to(cache_k.dtype))
        cache_v.scatter_(2, idx, vh.to(cache_v.dtype))
        kf, vf = cache_k.to(q.dtype), cache_v.to(q.dtype)
    cols = torch.arange(S, device=x.device)
    mask = cols[None, None, :] <= positions[:, :, None]       # [B, K, S]
    attn = _attention(q, kf.transpose(1, 2), vf.transpose(1, 2), mask)
    x = x + _linear(attn.reshape(B, K, cfg.dim), layer["wo"])
    h2 = rmsnorm(x, layer["mlp_norm"], cfg.norm_eps)
    return x + _mlp(cfg, layer, h2)


def llama_verify_step(params, cfg: LlamaConfig, tokens, pos, cache):
    """Speculative-decoding verify pass: tokens [B, K] int32 (token j is
    the input at write position pos + j); pos [B] int32. Returns (logits
    [B, K, vocab], cache). Rows past the accepted prefix stay in the cache
    unseen until overwritten: not advancing pos is the rollback."""
    B, K = tokens.shape
    x = _embed(params, tokens)
    positions = pos.to(torch.int32)[:, None] + torch.arange(
        K, dtype=torch.int32, device=tokens.device)[None]
    for i, layer in enumerate(params["layers"]):
        x = _block_verify(cfg, layer, x, positions, *_layer_caches(cache, i))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x, params["lm_head"]), cache


def _greedy(logits) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


class DecodeGraph:
    """One greedy decode step (llama_decode_step + argmax) captured in a
    CUDA graph over static token, pos and cache buffers, replayed once per
    token: the counterpart of the JAX package's lax.scan fusion.

    Construction runs the step once eagerly at (token, pos) to warm up,
    which writes the cache rows at pos that the first replay writes
    again with the same values, then captures it. Each replay appends at
    pos, writes the next token into `token` and the token history, and
    advances pos by one.
    """

    def __init__(self, params, cfg: LlamaConfig, token, pos, cache,
                 n_steps: int):
        B = token.shape[0]
        self.n_steps = n_steps
        self.token = token.to(torch.int32).clone()
        self.pos = pos.to(torch.int32).clone()
        self.tokens = torch.zeros(B, n_steps, dtype=torch.int32,
                                  device=token.device)
        self._col = torch.zeros(B, 1, dtype=torch.int64, device=token.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            llama_decode_step(params, cfg, self.token, self.pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            logits, _ = llama_decode_step(params, cfg, self.token, self.pos,
                                          cache)
            nxt = _greedy(logits)
            self.tokens.scatter_(1, self._col, nxt[:, None])
            self._col.add_(1)
            self.token.copy_(nxt)
            self.pos.add_(1)

    def reset(self, token, pos) -> None:
        self.token.copy_(token)
        self.pos.copy_(pos)

    def run(self) -> torch.Tensor:
        """Replay n_steps decode steps; returns the tokens [B, n_steps]
        (the static buffer: clone it to keep it across runs)."""
        self._col.zero_()
        for _ in range(self.n_steps):
            self.graph.replay()
        return self.tokens


def llama_decode_multi(params, cfg: LlamaConfig, token, pos, cache,
                       n_steps: int):
    """n_steps greedy decode steps. On the card, one captured step
    (DecodeGraph) replayed n_steps times; on the CPU, a Python loop.

    Returns (tokens [B, n_steps], last_token, next_pos, cache)."""
    if token.device.type == "cuda":
        g = DecodeGraph(params, cfg, token, pos, cache, n_steps)
        toks = g.run().clone()
        return toks, g.token.clone(), g.pos.clone(), cache
    toks = []
    for _ in range(n_steps):
        logits, cache = llama_decode_step(params, cfg, token, pos, cache)
        token = _greedy(logits)
        toks.append(token)
        pos = pos + 1
    return torch.stack(toks, dim=1), token, pos, cache


def greedy_generate(params, cfg: LlamaConfig, prompt_tokens, n_steps: int,
                    cache=None):
    """Prefill the prompt [B, S], take the argmax of its last logits, then
    n_steps - 1 greedy decode steps from pos S (llama_decode_multi: one
    CUDA graph on the card, a loop on the CPU). The default cache is bf16
    (init_kv_cache's default). Returns ([B, n_steps] int32, cache)."""
    B, S = prompt_tokens.shape
    if cache is None:
        cache = init_kv_cache(cfg, B, device=prompt_tokens.device)
    logits, cache = llama_prefill(params, cfg, prompt_tokens, cache)
    token = _greedy(logits[:, -1])
    if n_steps <= 1:
        return token[:, None], cache
    pos = torch.full((B,), S, dtype=torch.int32, device=token.device)
    toks, *_ = llama_decode_multi(params, cfg, token, pos, cache,
                                  n_steps - 1)
    return torch.cat([token[:, None], toks], dim=1), cache
