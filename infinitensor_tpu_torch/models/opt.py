"""OPT family with a static KV cache (counterpart of
infinitensor_tpu/models/opt.py).

Same infrastructure as models/gpt2.py: a parameter dict laid out like the
JAX pytree, prefill + decode, optional weight-only INT8 / INT4
(quantize_opt_params). OPT specifics against GPT-2 (HF modeling_opt.py):

* learned positional embeddings with a +2 offset (table rows = max_seq + 2)
* ReLU FFN activation
* pre-layernorm (do_layer_norm_before=True, the standard configs)
* LM head tied to the token embedding: a plain wte.T matmul with f32
  logits (gpt2._dense: the products summed in f32, as the JAX package's
  preferred_element_type=float32; on the card one cuBLAS call that reads
  the bf16 wte as stored)

opt_prefill: embeddings -> per layer (_ln; w_qkv; causal attention in
    plain f32 torch ops, outside any kernel as in the JAX package; w_o;
    _ln; w_up; ReLU in f32; w_down) -> _ln -> tied lm_head; the cache rows
    [0, S) written in place and the rows past S zeroed (the JAX package
    returns a fresh zero cache past S).
opt_decode_step: the same layers at one row, decode_attention_gqa (cache
    append + flash_decode, split at few heads with flash_decode_merge).

The matmuls go through gpt2._linear: quantized weights take wo_matmul
(quant_matmul's kernels from 512 input features and up to 256 rows,
dequant_matmul above), float weights gpt2._dense rounded to x's dtype.
The KV cache is updated IN PLACE, and `pos` stays a device tensor, so a
decode step can be captured in one CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels.attention import decode_attention_gqa
from infinitensor_tpu_torch.models.gpt2 import _dense, _linear, _ln
from infinitensor_tpu_torch.quant.weight_only import quantize_weight
from infinitensor_tpu_torch.utils.platform import resolve_device

_POS_OFFSET = 2


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    dim: int = 768           # opt-125m geometry by default
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq: int = 2048
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def opt_1b3(**kw) -> "OPTConfig":
        return OPTConfig(dim=2048, n_layers=24, n_heads=32, ffn_dim=8192,
                         **kw)

    @staticmethod
    def tiny(**kw) -> "OPTConfig":
        return OPTConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         ffn_dim=128, max_seq=64, **kw)


def init_opt_params(cfg: OPTConfig, generator: torch.Generator,
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
            "w_up": dense(cfg.dim, cfg.ffn_dim), "b_up": zeros(cfg.ffn_dim),
            "w_down": dense(cfg.ffn_dim, cfg.dim), "b_down": zeros(cfg.dim),
        })
    return {
        "wte": dense(cfg.vocab_size, cfg.dim),
        "wpe": dense(cfg.max_seq + _POS_OFFSET, cfg.dim, std=0.01),
        "lnf_g": ones(cfg.dim), "lnf_b": zeros(cfg.dim),
        "layers": layers,
    }


_QKEYS = ("w_qkv", "w_o", "w_up", "w_down")


def quantize_opt_params(params: dict, bits: int = 8,
                        group_size: Optional[int] = None) -> dict:
    """Weight-only quantize the four matmuls of every layer (the tied
    wte stays float for the embedding and the lm_head)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for layer in params["layers"]:
        ql = dict(layer)
        for k in _QKEYS:
            ql[k] = quantize_weight(layer[k], bits, group_size)
        out["layers"].append(ql)
    return out


def init_opt_cache(cfg: OPTConfig, batch: int,
                   max_seq: Optional[int] = None, dtype=None, *,
                   device=None) -> dict:
    """Per-layer K/V [B, H, S, D] in `dtype` (default cfg.dtype)."""
    device = resolve_device(device)
    S = max_seq or cfg.max_seq
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.n_heads, S, cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.n_layers)]}


def _relu(y: torch.Tensor) -> torch.Tensor:
    return torch.relu(y.float())


def opt_prefill(params, cfg: OPTConfig, tokens, cache):
    """tokens [B, S] int32 -> (f32 logits [B, S, vocab], cache); the cache
    rows [0, S) are overwritten in place and the rows past S zeroed."""
    B, S = tokens.shape
    if S > cache["k"][0].shape[2]:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's "
                         f"{cache['k'][0].shape[2]} rows")
    x = params["wte"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, cfg.dim) + params["wpe"][_POS_OFFSET:_POS_OFFSET + S][None]
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
        u = _relu(_linear(h2, layer["w_up"], layer["b_up"]))
        x = x + _linear(u.to(x.dtype), layer["w_down"], layer["b_down"])
        for key, val in (("k", k), ("v", v)):
            buf = cache[key][i]
            buf[:, :, :S].copy_(val.transpose(1, 2))
            buf[:, :, S:].zero_()
    x = _ln(x, params["lnf_g"], params["lnf_b"], eps)
    return _dense(x, params["wte"].t()), cache


def opt_decode_step(params, cfg: OPTConfig, token, pos, cache):
    """token [B] int32, pos [B] int32 -> (f32 logits [B, vocab], cache).
    The cache dict is the one passed in, its tensors updated in place."""
    B = token.shape[0]
    x = (params["wte"].index_select(0, token)
         + params["wpe"].index_select(0, pos + _POS_OFFSET))[:, None, :]
    eps = cfg.layer_norm_eps

    def heads(t):
        return t.reshape(B, 1, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    for i, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln1_g"], layer["ln1_b"], eps)
        qkv = _linear(h, layer["w_qkv"], layer["b_qkv"])
        qh, kh, vh = (heads(t) for t in qkv.split(cfg.dim, dim=-1))
        ck, cv = cache["k"][i], cache["v"][i]
        out, *_ = decode_attention_gqa(ck, cv, qh, kh.to(ck.dtype),
                                       vh.to(cv.dtype), pos)
        att = out.transpose(1, 2).reshape(B, 1, cfg.dim)
        x = x + _linear(att, layer["w_o"], layer["b_o"])
        h2 = _ln(x, layer["ln2_g"], layer["ln2_b"], eps)
        u = _relu(_linear(h2, layer["w_up"], layer["b_up"]))
        x = x + _linear(u.to(x.dtype), layer["w_down"], layer["b_down"])
    x = _ln(x, params["lnf_g"], params["lnf_b"], eps)
    return _dense(x[:, 0], params["wte"].t()), cache
