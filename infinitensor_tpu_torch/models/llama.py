"""Llama-family decode (counterpart of infinitensor_tpu/models/llama.py).

Plain functions on tensors; parameters are a dict laid out like the JAX
pytree (params["layers"][i]["wqkv"], ...), with QuantizedLinear leaves.
The slice ported here is greedy decode with INT4/INT8 weight-only
matmuls and an INT8 KV cache:

  llama_decode_multi -> llama_decode_step -> _block_decode x L
    (_qkv: fused RMSNorm + wqkv, quant_matmul_norm;
     decode_attention_gqa_q8: in-place append + flash_decode_q8;
     wo: quant_matmul; _mlp: fused RMSNorm + w_gateup, w_down)
  -> rmsnorm -> lm_head (quant_matmul, W4A8 at the 7B shape) -> argmax.

The KV cache is updated IN PLACE (the JAX package donates it instead), and
`pos` stays a device int32 tensor, so on the card one step captures into a
CUDA graph. Prefill, the bf16 cache and paged caches are later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from infinitensor_tpu_torch.kernels.attention import decode_attention_gqa_q8
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
                          group_size: Optional[int] = None) -> dict:
    """Weight-only quantize every layer matmul and the lm_head, with Q/K/V
    and gate/up concatenated into "wqkv" and "w_gateup"."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": quantize_weight(params["lm_head"], bits, group_size),
           "layers": []}
    for layer in params["layers"]:
        ql = {k: v for k, v in layer.items() if k not in _QUANT_KEYS}
        qw = {k: quantize_weight(layer[k], bits, group_size)
              for k in _QUANT_KEYS}
        ql["wqkv"] = concat_qlinear(qw["wq"], qw["wk"], qw["wv"])
        ql["w_gateup"] = concat_qlinear(qw["w_gate"], qw["w_up"])
        ql["wo"] = qw["wo"]
        ql["w_down"] = qw["w_down"]
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
                  max_seq: Optional[int] = None, device=None,
                  kv_quant: bool = True) -> dict:
    """Per-layer int8 K/V [B, Hkv, S, D] plus f32 scales [B, Hkv, S]."""
    if not kv_quant:
        raise NotImplementedError(
            "bf16 KV cache: its kernel flash_decode is not ported yet "
            "(ROADMAP Queue 2 item 8)")
    device = resolve_device(device)
    S = max_seq or cfg.max_seq
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)

    def zeros(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(cfg.n_layers)]

    return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
            "k_scale": zeros(shape[:-1], torch.float32),
            "v_scale": zeros(shape[:-1], torch.float32)}


def _qkv(cfg, layer, h, norm_w, eps):
    """q/k/v from the fused wqkv; h is the raw residual, normalized inside
    the matmul (_linear_norm)."""
    B, S, _ = h.shape
    kvd = cfg.n_kv_heads * cfg.head_dim
    qkv = _linear_norm(h, norm_w, layer["wqkv"], eps)
    q = qkv[..., :cfg.dim]
    k = qkv[..., cfg.dim:cfg.dim + kvd]
    v = qkv[..., cfg.dim + kvd:]
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def _mlp(cfg, layer, x, norm_w, eps):
    """SwiGLU MLP on the raw residual x, its RMSNorm fused into w_gateup."""
    gu = _linear_norm(x, norm_w, layer["w_gateup"], eps).float()
    gate, up = gu[..., :cfg.intermediate], gu[..., cfg.intermediate:]
    gate = torch.nn.functional.silu(gate)
    return _linear((gate * up).to(x.dtype), layer["w_down"])


def _block_decode(cfg, layer, x, pos, cache_k, cache_v, k_scale, v_scale):
    """x [B, 1, dim]; pos [B]; INT8 cache [B, Hkv, Smax, D] with scales
    [B, Hkv, Smax], appended in place at pos."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, layer, x, layer["attn_norm"], cfg.norm_eps)
    pos2 = pos[:, None]
    q = rope(q, pos2, cfg.rope_theta)
    k = rope(k, pos2, cfg.rope_theta)
    out, *_ = decode_attention_gqa_q8(
        cache_k, cache_v, k_scale, v_scale, q.transpose(1, 2),
        k.transpose(1, 2), v.transpose(1, 2), pos)
    attn = out.transpose(1, 2).reshape(B, 1, cfg.dim)
    x = x + _linear(attn, layer["wo"])
    return x + _mlp(cfg, layer, x, layer["mlp_norm"], cfg.norm_eps)


def llama_decode_step(params, cfg: LlamaConfig, token, pos, cache):
    """One decode step. token [B] int32, pos [B] int32 (write positions).

    Returns (logits [B, vocab], cache); the cache dict is the one passed
    in, its tensors updated in place."""
    if "k_scale" not in cache:
        raise NotImplementedError(
            "bf16 KV cache: its kernel flash_decode is not ported yet "
            "(ROADMAP Queue 2 item 8)")
    x = params["embed"].index_select(0, token)[:, None, :]
    for i, layer in enumerate(params["layers"]):
        x = _block_decode(cfg, layer, x, pos, cache["k"][i], cache["v"][i],
                          cache["k_scale"][i], cache["v_scale"][i])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _linear(x[:, 0], params["lm_head"]), cache


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
