"""BERT encoder family + INT8 dynamic quantization path (counterpart of
infinitensor_tpu/models/bert.py).

BASELINE config: "BERT-base ONNX INT8 dynamic-quantized (QuantizeLinear/
DequantizeLinear ops, single chip)". Two surfaces:

* a functional BERT encoder in torch (``bert_encode``: plain dense ops,
  f32 by default; no Pallas kernel in the JAX package either), and
* ``build_bert_layer_graph(..., dynamic_quant=True)`` / ``build_bert_graph``
  constructing the graph through this package's GraphHandler with the ONNX
  dynamic-quantization pattern (DynamicQuantizeLinear -> MatMulInteger ->
  scale multiply), i.e. what onnxruntime's dynamic quantizer emits. The
  graphs are built from numpy copies of the weights, so the same
  parameters give the JAX package's graph op for op; they run on the card
  unless the handler's runtime is the CPU's (``h.runtime =
  cpu_runtime()`` before ``h.run``).

Parameters are a dict laid out like the JAX pytree (params["layers"][i]
["wq"], ...), torch tensors in [in, out] layout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.handler import GraphHandler
from infinitensor_tpu_torch.kernels.quant_matmul import layer_norm
from infinitensor_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    intermediate: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        return BertConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                          intermediate=128, max_seq=64, **kw)


def init_bert_params(cfg: BertConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random parameters (normal * 0.02, unit gammas, zero betas and
    biases) in cfg.dtype; `generator` must live on `device`."""
    device = resolve_device(device)

    def dense(din, dout):
        w = torch.randn(din, dout, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * 0.02).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(cfg.dim, cfg.dim), "bq": zeros(cfg.dim),
            "wk": dense(cfg.dim, cfg.dim), "bk": zeros(cfg.dim),
            "wv": dense(cfg.dim, cfg.dim), "bv": zeros(cfg.dim),
            "wo": dense(cfg.dim, cfg.dim), "bo": zeros(cfg.dim),
            "ln1_g": ones(cfg.dim), "ln1_b": zeros(cfg.dim),
            "w_up": dense(cfg.dim, cfg.intermediate),
            "b_up": zeros(cfg.intermediate),
            "w_down": dense(cfg.intermediate, cfg.dim),
            "b_down": zeros(cfg.dim),
            "ln2_g": ones(cfg.dim), "ln2_b": zeros(cfg.dim),
        })
    return {
        "tok": dense(cfg.vocab_size, cfg.dim),
        "pos": dense(cfg.max_seq, cfg.dim),
        "type": dense(cfg.type_vocab, cfg.dim),
        "emb_ln_g": ones(cfg.dim), "emb_ln_b": zeros(cfg.dim),
        "layers": layers,
    }


_ln = layer_norm     # (x, gamma, beta, eps): f32, rounded once to x's dtype


def bert_encode(params, cfg: BertConfig, tokens, attn_mask=None,
                token_types=None):
    """tokens [B, S] -> hidden [B, S, dim], on the device of the params.
    The attention is the JAX package's f32 einsum (a -1e30 bias where the
    mask is 0), the GELU the exact (erf) form."""
    B, S = tokens.shape
    x = params["tok"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, cfg.dim) + params["pos"][:S][None]
    if token_types is not None:
        x = x + params["type"].index_select(
            0, token_types.reshape(-1)).reshape(B, S, cfg.dim)
    else:
        x = x + params["type"][0][None, None]
    x = _ln(x, params["emb_ln_g"], params["emb_ln_b"], cfg.eps)
    if attn_mask is None:
        bias = 0.0
    else:
        bias = torch.where(attn_mask[:, None, None, :] > 0, 0.0, -1e30)
    hd = cfg.dim // cfg.n_heads
    for layer in params["layers"]:
        q = (x @ layer["wq"] + layer["bq"]).reshape(B, S, cfg.n_heads, hd)
        k = (x @ layer["wk"] + layer["bk"]).reshape(B, S, cfg.n_heads, hd)
        v = (x @ layer["wv"] + layer["bv"]).reshape(B, S, cfg.n_heads, hd)
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
            / math.sqrt(hd) + bias
        p = torch.softmax(scores, dim=-1)
        att = torch.einsum("bhst,bthd->bshd", p, v.float()).reshape(
            B, S, cfg.dim).to(x.dtype)
        x = _ln(x + (att @ layer["wo"] + layer["bo"]), layer["ln1_g"],
                layer["ln1_b"], cfg.eps)
        u = torch.nn.functional.gelu(
            (x @ layer["w_up"] + layer["b_up"]).float(), approximate="none")
        x = _ln(x + (u.to(x.dtype) @ layer["w_down"] + layer["b_down"]),
                layer["ln2_g"], layer["ln2_b"], cfg.eps)
    return x


# ---------------------------------------------------------------------------
# graph path with ONNX-style dynamic INT8 quantization
# ---------------------------------------------------------------------------

def _dyn_quant_matmul(h: GraphHandler, x, w_np: np.ndarray, b_np: np.ndarray):
    """x @ w + b with the ORT dynamic-quant pattern:
    DynamicQuantizeLinear(x) -> MatMulInteger(x_q, w_q) -> y_int32
    -> Cast -> * (x_scale * w_scale) -> + bias."""
    # weight quantized offline, symmetric per-tensor (ORT default style)
    w_scale = float(np.abs(w_np).max() / 127.0) or 1e-8
    w_q = np.clip(np.round(w_np / w_scale), -127, 127).astype(np.int8)
    wq_t = h.weight(w_q)
    xq, x_scale, x_zp = h._add("DynamicQuantizeLinear", [x], {}, n_outputs=3)
    y_i32 = h._add("MatMulInteger", [xq, wq_t, x_zp], {})
    y_f = h.cast(y_i32, 1)  # float32
    scale = h.mul(x_scale, h.weight(np.float32(w_scale).reshape(())))
    y = h.mul(y_f, scale)
    return h.add(y, h.weight(b_np))


def _np(a):
    """A parameter as f32 numpy (a torch tensor on any device, or numpy)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _build_layer(h: GraphHandler, cfg: BertConfig, layer_params: dict,
                 x, batch: int, seq: int, dynamic_quant: bool):
    hd = cfg.dim // cfg.n_heads

    def linear(t, wname, bname):
        w_np, b_np = _np(layer_params[wname]), _np(layer_params[bname])
        if dynamic_quant:
            flat = h.reshape(t, (batch * seq, w_np.shape[0]))
            y = _dyn_quant_matmul(h, flat, w_np, b_np)
            return h.reshape(y, (batch, seq, w_np.shape[1]))
        return h.add(h.matmul(t, h.weight(w_np)), h.weight(b_np))

    q = h.reshape(linear(x, "wq", "bq"), (batch, seq, cfg.n_heads, hd))
    k = h.reshape(linear(x, "wk", "bk"), (batch, seq, cfg.n_heads, hd))
    v = h.reshape(linear(x, "wv", "bv"), (batch, seq, cfg.n_heads, hd))
    qT = h.transpose(q, perm=[0, 2, 1, 3])
    kT = h.transpose(k, perm=[0, 2, 3, 1])
    vT = h.transpose(v, perm=[0, 2, 1, 3])
    scores = h.matmul(qT, kT)
    scaled = h.mul(scores, h.weight(np.float32(1.0 / math.sqrt(hd)).reshape(())))
    att = h.matmul(h.softmax(scaled, axis=-1), vT)
    merged = h.reshape(h.transpose(att, perm=[0, 2, 1, 3]),
                       (batch, seq, cfg.dim))
    attn_out = linear(merged, "wo", "bo")
    x1 = h.layer_normalization(
        h.add(x, attn_out), h.weight(_np(layer_params["ln1_g"])),
        h.weight(_np(layer_params["ln1_b"])), axis=-1, epsilon=cfg.eps)
    up = h.gelu(linear(x1, "w_up", "b_up"))
    down = linear(up, "w_down", "b_down")
    return h.layer_normalization(
        h.add(x1, down), h.weight(_np(layer_params["ln2_g"])),
        h.weight(_np(layer_params["ln2_b"])), axis=-1, epsilon=cfg.eps)


def build_bert_layer_graph(cfg: BertConfig, layer_params: dict,
                           batch: int, seq: int,
                           dynamic_quant: bool = False) -> GraphHandler:
    """One BERT encoder layer as a graph (float or dynamic-INT8)."""
    h = GraphHandler(name="bert_layer")
    x = h.input((batch, seq, cfg.dim), name="x")
    _build_layer(h, cfg, layer_params, x, batch, seq, dynamic_quant)
    h.graph.infer_output_roles()
    return h


def build_bert_graph(cfg: BertConfig, params: dict, batch: int, seq: int,
                     dynamic_quant: bool = False) -> GraphHandler:
    """FULL BERT encoder as a graph: token/position/type embeddings + LN +
    every layer (float or ORT-style dynamic-INT8 matmuls). Tokens in,
    hidden states out — the BASELINE config-2 model on the graph path."""
    h = GraphHandler(name="bert")
    tokens = h.input((batch, seq), dtype=dt.INT32, name="tokens")
    tok_emb = h.gather(h.weight(_np(params["tok"]), name="tok_emb"),
                       tokens, axis=0)
    pos_emb = h.weight(_np(params["pos"])[:seq][None], name="pos_emb")
    type_emb = h.weight(_np(params["type"])[0][None, None],
                        name="type_emb")
    x = h.add(h.add(tok_emb, pos_emb), type_emb)
    x = h.layer_normalization(
        x, h.weight(_np(params["emb_ln_g"])),
        h.weight(_np(params["emb_ln_b"])), axis=-1, epsilon=cfg.eps)
    for lp in params["layers"]:
        x = _build_layer(h, cfg, lp, x, batch, seq, dynamic_quant)
    h.graph.infer_output_roles()
    return h
