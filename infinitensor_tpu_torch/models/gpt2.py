"""GPT-2 family with a static KV cache (counterpart of
infinitensor_tpu/models/gpt2.py).

Plain functions on tensors; parameters are a dict laid out like the JAX
pytree (params["layers"][i]["w_qkv"], ...), with QuantizedLinear leaves
after quantize_gpt2_params (weight-only INT8/INT4, and an int8 transposed
copy of the tied wte as "lm_head_q"). The line served is GPT-2 345M INT8
under the continuous batcher (serving.ServingEngine with prefill_fn /
decode_fn / init_cache_fn from here):

  gpt2_prefill: embeddings -> per layer (_ln; w_qkv; causal attention in
      plain f32 torch ops, as the JAX package leaves it outside any
      kernel; w_o; _ln; w_up; tanh GELU in f32; w_down) -> _ln -> lm_head
      at all S positions; the cache rows [0, S) written in place. Its
      matmuls take quant_matmul up to 256 rows and the dequant route
      above (wo_matmul).
  gpt2_decode_step: per layer quant_matmul_ln (LayerNorm + w_qkv + bias,
      one kernel: qmm_group_ln), decode_attention_gqa (bf16 cache: append
      + flash_decode) or decode_attention_gqa_q8 (INT8 cache), w_o
      (qmm_group), quant_matmul_ln for w_up, GELU, w_down; _ln; lm_head.

INFINITPU_GPT2_FUSED_LN=0 (read at each decode step, default "1") runs
_ln + _linear in place of quant_matmul_ln. The KV cache is updated IN
PLACE (the JAX package returns a new one), and `pos` stays a device
tensor, so the serving engine captures one decode step in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels.attention import (
    decode_attention_gqa, decode_attention_gqa_q8, quantize_kv_row,
)
from infinitensor_tpu_torch.kernels.quant_matmul import (
    layer_norm, quant_matmul_ln,
)
from infinitensor_tpu_torch.quant.weight_only import (
    QuantizedLinear, quantize_weight, wo_matmul,
)
from infinitensor_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 1024          # 345M ("gpt2-medium") geometry by default
    n_layers: int = 24
    n_heads: int = 16
    max_seq: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def gpt2_small(**kw) -> "GPT2Config":
        return GPT2Config(dim=768, n_layers=12, n_heads=12, **kw)

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        return GPT2Config(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                          max_seq=64, **kw)


def init_gpt2_params(cfg: GPT2Config, generator: torch.Generator,
                     device=None, dtype=None) -> dict:
    """Random dense parameters (normal * 0.02, wpe * 0.01, unit gammas,
    zero betas and biases); `generator` must live on `device`."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype

    def dense(din, dout, std=0.02):
        w = torch.randn(din, dout, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1_g": ones(cfg.dim), "ln1_b": zeros(cfg.dim),
            "w_qkv": dense(cfg.dim, 3 * cfg.dim),
            "b_qkv": zeros(3 * cfg.dim),
            "w_o": dense(cfg.dim, cfg.dim), "b_o": zeros(cfg.dim),
            "ln2_g": ones(cfg.dim), "ln2_b": zeros(cfg.dim),
            "w_up": dense(cfg.dim, 4 * cfg.dim), "b_up": zeros(4 * cfg.dim),
            "w_down": dense(4 * cfg.dim, cfg.dim), "b_down": zeros(cfg.dim),
        })
    return {
        "wte": dense(cfg.vocab_size, cfg.dim),
        "wpe": dense(cfg.max_seq, cfg.dim, std=0.01),
        "lnf_g": ones(cfg.dim), "lnf_b": zeros(cfg.dim),
        "layers": layers,
    }


_QKEYS = ("w_qkv", "w_o", "w_up", "w_down")


def quantize_gpt2_params(params: dict, bits: int = 8,
                         group_size: Optional[int] = None,
                         quant_lm_head: bool = True) -> dict:
    """Weight-only quantize the four matmuls of every layer. With
    quant_lm_head the tied lm_head gets a quantized transposed copy of wte
    ("lm_head_q", columns padded to a multiple of 1024: 50257 -> 51200) for
    the logits matmul, while the embedding gather keeps the float wte."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for k in _QKEYS:
            ql[k] = quantize_weight(layer[k], bits, group_size)
        out["layers"].append(ql)
    if quant_lm_head:
        out["lm_head_q"] = quantize_weight(
            params["wte"].t().to(torch.float32), bits, group_size,
            pad_out=1024)
    return out


def _dense(x, w):
    """x [..., din] @ w [din, dout] -> f32 [..., dout]: the products of
    x's and w's values summed in f32 (jnp.matmul(...,
    preferred_element_type=float32)). On the card a 16-bit pair is one
    cuBLAS call with an f32 result, so w is read as it is stored."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype == w.dtype and \
            x.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(x2.float(), w.float())
    return out.reshape(*lead, w.shape[-1])


def _linear(x, w, b=None):
    if isinstance(w, QuantizedLinear):
        y = wo_matmul(x, w)
    else:
        y = _dense(x, w).to(x.dtype)
    if b is not None:
        y = y + b
    return y


_ln = layer_norm     # (x, gamma, beta, eps): f32, rounded once to x's dtype


def _gelu(x):
    """tanh-form GELU in f32 (jax.nn.gelu(approximate=True))."""
    return torch.nn.functional.gelu(x.float(), approximate="tanh")


def init_gpt2_cache(cfg: GPT2Config, batch: int,
                    max_seq: Optional[int] = None, dtype=None,
                    kv_quant: bool = False, *, device=None) -> dict:
    """Per-layer K/V [B, H, S, D] in `dtype` (default cfg.dtype); with
    kv_quant, int8 K/V plus f32 scales [B, H, S]."""
    device = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (batch, cfg.n_heads, S, cfg.head_dim)

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(cfg.n_layers)]

    if not kv_quant:
        dtype = dtype or cfg.dtype
        return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
            "k_scale": zeros(shape[:-1], torch.float32),
            "v_scale": zeros(shape[:-1], torch.float32)}


def _lm_head(params, x):
    """x [..., dim] -> f32 logits [..., vocab]."""
    if "lm_head_q" in params:
        return wo_matmul(x, params["lm_head_q"]).float()
    return torch.matmul(x.float(), params["wte"].float().t())


def gpt2_prefill(params, cfg: GPT2Config, tokens, cache):
    """tokens [B, S] int32 -> (f32 logits [B, S, vocab], cache); the cache
    rows [0, S) are overwritten in place and the rows past S zeroed (the
    JAX package builds a fresh zero cache)."""
    B, S = tokens.shape
    if S > cache["k"][0].shape[2]:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's "
                         f"{cache['k'][0].shape[2]} rows")
    x = params["wte"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, cfg.dim) + params["wpe"][:S][None]
    quant_cache = "k_scale" in cache
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool,
                                   device=tokens.device))[None, None]
    eps = cfg.layer_norm_eps
    for i, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln1_g"], layer["ln1_b"], eps)
        qkv = _linear(h, layer["w_qkv"], layer["b_qkv"])
        q, k, v = (t.reshape(B, S, cfg.n_heads, cfg.head_dim)
                   for t in qkv.split(cfg.dim, dim=-1))
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
            / math.sqrt(cfg.head_dim)
        scores = torch.where(causal, scores, -1e30)
        p = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhst,bthd->bshd", p, v.float()).reshape(
            B, S, cfg.dim).to(x.dtype)
        x = x + _linear(att, layer["w_o"], layer["b_o"])
        h2 = _ln(x, layer["ln2_g"], layer["ln2_b"], eps)
        u = _gelu(_linear(h2, layer["w_up"], layer["b_up"]))
        x = x + _linear(u.to(x.dtype), layer["w_down"], layer["b_down"])
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)      # [B, H, S, D]
        new = {"k": kh, "v": vh}
        if quant_cache:
            new["k"], new["k_scale"] = quantize_kv_row(kh)
            new["v"], new["v_scale"] = quantize_kv_row(vh)
        for key, val in new.items():
            buf = cache[key][i]
            buf[:, :, :S].copy_(val)
            buf[:, :, S:].zero_()
    x = _ln(x, params["lnf_g"], params["lnf_b"], eps)
    return _lm_head(params, x), cache


def gpt2_decode_step(params, cfg: GPT2Config, token, pos, cache):
    """token [B] int32, pos [B] int32 -> (f32 logits [B, vocab], cache).
    An INT8 cache ("k_scale" present) takes the q8 decode attention. The
    cache dict is the one passed in, its tensors updated in place."""
    B = token.shape[0]
    quant_cache = "k_scale" in cache
    x = (params["wte"].index_select(0, token)
         + params["wpe"].index_select(0, pos))[:, None, :]
    fuse_ln = os.environ.get("INFINITPU_GPT2_FUSED_LN", "1") == "1"
    eps = cfg.layer_norm_eps

    def ln_linear(x, g, b, w, bias):
        if fuse_ln and isinstance(w, QuantizedLinear):
            return quant_matmul_ln(x, g, b, w, bias=bias, eps=eps)
        return _linear(_ln(x, g, b, eps), w, bias)

    def heads(t):
        return t.reshape(B, 1, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    for i, layer in enumerate(params["layers"]):
        qkv = ln_linear(x, layer["ln1_g"], layer["ln1_b"], layer["w_qkv"],
                        layer["b_qkv"])
        qh, kh, vh = (heads(t) for t in qkv.split(cfg.dim, dim=-1))
        if quant_cache:
            out, *_ = decode_attention_gqa_q8(
                cache["k"][i], cache["v"][i], cache["k_scale"][i],
                cache["v_scale"][i], qh, kh, vh, pos)
        else:
            out, *_ = decode_attention_gqa(cache["k"][i], cache["v"][i], qh,
                                           kh, vh, pos)
        att = out.transpose(1, 2).reshape(B, 1, cfg.dim)
        x = x + _linear(att, layer["w_o"], layer["b_o"])
        up = ln_linear(x, layer["ln2_g"], layer["ln2_b"], layer["w_up"],
                       layer["b_up"])
        x = x + _linear(_gelu(up).to(x.dtype), layer["w_down"],
                        layer["b_down"])
    x = _ln(x, params["lnf_g"], params["lnf_b"], eps)
    return _lm_head(params, x[:, 0]), cache
