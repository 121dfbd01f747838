"""Llama-family decoder built ON THE GRAPH IR (counterpart of
infinitensor_tpu/models/graph_llama.py).

The analog of the reference's flagship example, which decodes Llama
through its graph engine with the fused AttentionKVCache op (reference
examples/python/llama_kvcache_inference.py:102-144). The hand-written
model (models/llama.py) is the serving fast path; this module runs the
same model through GraphHandler -> Graph IR -> GraphExecutor, with the KV
cache updated in place.

Build: one decode-step graph (token [B], pos [B], per-layer KV caches in,
logits + updated caches out) using MatMul / RMSNorm / RoPE /
AttentionKVCache / Sigmoid / Mul / Add / Gather / Reshape / Transpose;
quantized weights take MatMulWOQ with the input RMSNorm fused.

The graph's final RMSNorm applies its weight in f32 and rounds once
(lowering RMSNorm), where the hand-written model rounds to bf16 before
the weight product: in bf16 the two differ by that rounding, as in the
JAX package.

On the card: GraphExecutor captures one CUDA graph per input signature;
make_fused_greedy_decode captures `multi` greedy steps (argmax feedback,
pos + 1 on the device) in ONE CUDA graph, the counterpart of the JAX
package's lax.scan; GraphLlamaServingAdapter's decode step is captured by
ServingEngine's own CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from infinitensor_tpu_torch.core import dtype as dt
from infinitensor_tpu_torch.core.handler import GraphHandler
from infinitensor_tpu_torch.models.llama import LlamaConfig
from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear


@dataclasses.dataclass
class GraphLlamaDecoder:
    """Decode-step graph + the tensor-name map needed to drive it."""

    handler: GraphHandler
    cfg: LlamaConfig
    batch: int
    max_seq: int
    token_name: str
    pos_name: str
    logits_name: str
    k_in: list            # per-layer cache input tensor names
    v_in: list
    k_out: list           # per-layer cache output tensor names
    v_out: list
    ks_in: list = dataclasses.field(default_factory=list)   # int8-KV scales
    vs_in: list = dataclasses.field(default_factory=list)
    ks_out: list = dataclasses.field(default_factory=list)
    vs_out: list = dataclasses.field(default_factory=list)

    @property
    def graph(self):
        return self.handler.graph

    def state_map(self) -> dict:
        m = {}
        for i in range(self.cfg.n_layers):
            m[self.k_in[i]] = self.k_out[i]
            m[self.v_in[i]] = self.v_out[i]
        for i in range(len(self.ks_in)):
            m[self.ks_in[i]] = self.ks_out[i]
            m[self.vs_in[i]] = self.vs_out[i]
        return m


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy value a graph weight holds (bf16 through
    ml_dtypes)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def build_llama_decoder(params: dict, cfg: LlamaConfig, batch: int = 1,
                        max_seq: Optional[int] = None,
                        name: str = "llama_decoder",
                        kv_quant: bool = False,
                        external_weights: bool = False
                        ) -> GraphLlamaDecoder:
    """Build the one-token decode graph from a models/llama.py param dict.
    Accepts BOTH layouts:

    - float (wq/wk/wv/wo/w_gate/w_up/w_down tensors, f32 or bf16) —
      plain MatMul ops;
    - weight-only quantized (quantize_llama_params output: fused "wqkv" /
      "w_gateup" QuantizedLinear + "wo"/"w_down"/lm_head) — MatMulWOQ ops
      with the pre-attention/pre-MLP RMSNorms FUSED into the matmul
      kernel, exactly like the hand-written fast path (_linear_norm).

    GQA (n_kv_heads < n_heads) is supported in both: caches are
    [B, Hkv, S, D]. kv_quant=True stores the cache INT8 with per-(b, h, s)
    scales (AttentionKVCacheQ8). external_weights=True builds from shapes
    and dtypes only (weight placeholders); bind_llama_weights then binds
    the tensors, on the device, without a copy.
    """
    S = max_seq or cfg.max_seq
    B, H, Hkv, D, dim = (batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.dim)
    kvd = Hkv * D
    h = GraphHandler(name=name)
    act_dt = dt.DataType.from_torch(cfg.dtype or torch.float32)

    def w(arr, wname):
        if external_weights:
            return h.weight_placeholder(tuple(arr.shape), act_dt, name=wname)
        return h.weight(_host(arr.to(cfg.dtype or torch.float32)),
                        name=wname)

    def wq_tensors(q: QuantizedLinear, prefix):
        if external_weights:
            qw = h.weight_placeholder(tuple(q.qweight.shape), dt.INT8,
                                      name=f"{prefix}.qweight")
            sc = h.weight_placeholder(
                tuple(q.scales.shape), dt.DataType.from_torch(q.scales.dtype),
                name=f"{prefix}.scales")
            return qw, sc
        qw = h.weight(_host(q.qweight), name=f"{prefix}.qweight")
        sc = h.weight(_host(q.scales), name=f"{prefix}.scales")
        return qw, sc

    def woq(x, q: QuantizedLinear, prefix, norm_w=None):
        qw, sc = wq_tensors(q, prefix)
        return h.matmul_woq(x, qw, sc, bits=q.bits,
                            group_size=q.group_size, norm_weight=norm_w,
                            eps=cfg.norm_eps, out_logical=q.out_logical)

    embed = w(params["embed"], "embed")
    token = h.input((B,), dtype=dt.INT32, name="token")
    pos = h.input((B,), dtype=dt.INT32, name="pos")
    pos2 = h.reshape(pos, (B, 1))

    k_in, v_in, k_out, v_out = [], [], [], []
    ks_in, vs_in, ks_out, vs_out = [], [], [], []
    x = h.reshape(h.gather(embed, token, axis=0), (B, 1, dim))
    for i, layer in enumerate(params["layers"]):
        cache_dt = dt.INT8 if kv_quant else act_dt
        kc = h.input((B, Hkv, S, D), dtype=cache_dt, name=f"k_cache_{i}")
        vc = h.input((B, Hkv, S, D), dtype=cache_dt, name=f"v_cache_{i}")
        k_in.append(kc.name)
        v_in.append(vc.name)
        if kv_quant:
            ksc = h.input((B, Hkv, S), dtype=dt.FLOAT32,
                          name=f"k_scale_{i}")
            vsc = h.input((B, Hkv, S), dtype=dt.FLOAT32,
                          name=f"v_scale_{i}")
            ks_in.append(ksc.name)
            vs_in.append(vsc.name)

        attn_norm = w(layer["attn_norm"], f"l{i}.attn_norm")
        if "wqkv" in layer:                   # quantized fused layout
            qkv = woq(x, layer["wqkv"], f"l{i}.wqkv", norm_w=attn_norm)
            q, k, v = h.split(qkv, -1, [dim, kvd, kvd])
        elif isinstance(layer.get("wq"), QuantizedLinear):
            q = woq(x, layer["wq"], f"l{i}.wq", norm_w=attn_norm)
            k = woq(x, layer["wk"], f"l{i}.wk", norm_w=attn_norm)
            v = woq(x, layer["wv"], f"l{i}.wv", norm_w=attn_norm)
        else:
            hn = h.rms_norm(x, attn_norm, epsilon=cfg.norm_eps)
            q = h.matmul(hn, w(layer["wq"], f"l{i}.wq"))
            k = h.matmul(hn, w(layer["wk"], f"l{i}.wk"))
            v = h.matmul(hn, w(layer["wv"], f"l{i}.wv"))
        q = h.rope(pos2, q, dim_head=D, theta=cfg.rope_theta)
        k = h.rope(pos2, k, dim_head=D, theta=cfg.rope_theta)

        def heads(t, nh):
            return h.transpose(h.reshape(t, (B, 1, nh, D)), (0, 2, 1, 3))

        if kv_quant:
            att, kc2, vc2, ks2, vs2 = h.attention_kvcache_q8(
                kc, vc, ksc, vsc, heads(q, H), heads(k, Hkv),
                heads(v, Hkv), pos)
            ks_out.append(ks2.name)
            vs_out.append(vs2.name)
        else:
            att, kc2, vc2 = h.attention_kvcache(
                kc, vc, heads(q, H), heads(k, Hkv), heads(v, Hkv), pos)
        k_out.append(kc2.name)
        v_out.append(vc2.name)
        att = h.reshape(h.transpose(att, (0, 2, 1, 3)), (B, 1, dim))
        if isinstance(layer.get("wo"), QuantizedLinear):
            x = h.add(x, woq(att, layer["wo"], f"l{i}.wo"))
        else:
            x = h.add(x, h.matmul(att, w(layer["wo"], f"l{i}.wo")))

        mlp_norm = w(layer["mlp_norm"], f"l{i}.mlp_norm")
        inter = cfg.intermediate
        if "w_gateup" in layer:               # quantized fused layout
            gu = woq(x, layer["w_gateup"], f"l{i}.w_gateup",
                     norm_w=mlp_norm)
            gate, up = h.split(gu, -1, [inter, inter])
        elif isinstance(layer.get("w_gate"), QuantizedLinear):
            gate = woq(x, layer["w_gate"], f"l{i}.w_gate", norm_w=mlp_norm)
            up = woq(x, layer["w_up"], f"l{i}.w_up", norm_w=mlp_norm)
        else:
            h2 = h.rms_norm(x, mlp_norm, epsilon=cfg.norm_eps)
            gate = h.matmul(h2, w(layer["w_gate"], f"l{i}.w_gate"))
            up = h.matmul(h2, w(layer["w_up"], f"l{i}.w_up"))
        act = h.mul(h.mul(gate, h.sigmoid(gate)), up)      # SiLU(gate)*up
        if isinstance(layer.get("w_down"), QuantizedLinear):
            x = h.add(x, woq(act, layer["w_down"], f"l{i}.w_down"))
        else:
            x = h.add(x, h.matmul(act, w(layer["w_down"], f"l{i}.w_down")))

    xf = h.rms_norm(x, w(params["final_norm"], "final_norm"),
                    epsilon=cfg.norm_eps)
    xf2 = h.reshape(xf, (B, dim))
    if isinstance(params["lm_head"], QuantizedLinear):
        logits = woq(xf2, params["lm_head"], "lm_head")
    else:
        logits = h.matmul(xf2, w(params["lm_head"], "lm_head"))
    h.graph.infer_output_roles()
    return GraphLlamaDecoder(h, cfg, B, S, token.name, pos.name,
                             logits.name, k_in, v_in, k_out, v_out,
                             ks_in, vs_in, ks_out, vs_out)


def _executor(dec: GraphLlamaDecoder, executor, device):
    from infinitensor_tpu_torch.runtime.executor import GraphExecutor
    return executor or GraphExecutor(dec.graph, device=device)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def graph_greedy_decode(dec: GraphLlamaDecoder, first_token, n_steps: int,
                        start_pos: int, executor=None, device=None):
    """Autoregressive greedy decode through GraphExecutor.stepper (the
    caches are the stepper's, updated in place). Returns np.int32
    [B, n_steps] (first entry = first_token's successor ... mirrors
    models/llama.greedy_generate's decode phase)."""
    ex = _executor(dec, executor, device)
    step = ex.stepper(dec.state_map())
    B = dec.batch
    tok = np.full((B,), first_token, np.int32) if np.isscalar(first_token) \
        else np.asarray(first_token, np.int32)
    out_toks = []
    for j in range(n_steps):
        outs = step({dec.token_name: tok,
                     dec.pos_name: np.full((B,), start_pos + j, np.int32)})
        tok = _greedy(outs[dec.logits_name]).cpu().numpy()
        out_toks.append(tok)
    return np.stack(out_toks, axis=1)


# ---------------------------------------------------------------------------
# ServingEngine adapter: a graph-IR model as the engine's model family
# ---------------------------------------------------------------------------

def _weights_from_params(params) -> dict:
    """Graph weight-name dict from the llama param dict (float OR
    weight-only-quantized)."""
    w = {}

    def put(name, v):
        if isinstance(v, QuantizedLinear):
            w[f"{name}.qweight"] = v.qweight
            w[f"{name}.scales"] = v.scales
        else:
            w[name] = v
    put("embed", params["embed"])
    put("final_norm", params["final_norm"])
    put("lm_head", params["lm_head"])
    for i, layer in enumerate(params["layers"]):
        for k, v in layer.items():
            put(f"l{i}.{k}", v)
    return w


class GraphLlamaServingAdapter:
    """Adapts a graph-IR Llama decoder to ServingEngine's model-family
    interface (prefill_fn / decode_fn / init_cache_fn).

    A decode graph is built per (batch, max_seq) geometry at first use,
    and its step runs eagerly through GraphExecutor.forward on the
    engine's parameters and cache (the cache updated in place), so that
    ServingEngine captures it in its own CUDA graph. Prefill feeds the
    prompt through the same decode step one position at a time, as the
    reference's llama example does (llama_kvcache_inference.py:102-144)."""

    def __init__(self, params: dict, cfg: LlamaConfig,
                 kv_quant: bool = False):
        self.params = params
        self.cfg = cfg
        self.kv_quant = bool(kv_quant)
        self._built: dict = {}

    def _decoder(self, batch: int, max_seq: int, device):
        key = (batch, max_seq, str(device))
        if key not in self._built:
            from infinitensor_tpu_torch.runtime.executor import GraphExecutor
            dec = build_llama_decoder(self.params, self.cfg, batch,
                                      max_seq, kv_quant=self.kv_quant,
                                      external_weights=True)
            self._built[key] = (dec, GraphExecutor(
                dec.graph, device=device, use_cuda_graph=False))
        return self._built[key]

    def _forward(self, params, token, pos, cache):
        """One decode step: (logits [B, vocab], cache), the cache's
        tensors updated in place."""
        B = token.shape[0]
        S = cache["k"][0].shape[2]
        dec, ex = self._decoder(B, S, token.device)
        vals = {dec.token_name: token.to(torch.int32),
                dec.pos_name: pos.to(torch.int32)}
        for i in range(self.cfg.n_layers):
            vals[dec.k_in[i]] = cache["k"][i]
            vals[dec.v_in[i]] = cache["v"][i]
        if self.kv_quant:
            for i in range(self.cfg.n_layers):
                vals[dec.ks_in[i]] = cache["k_scale"][i]
                vals[dec.vs_in[i]] = cache["v_scale"][i]
        out = ex.forward(vals, _weights_from_params(params))
        names = {"k": dec.k_out, "v": dec.v_out}
        if self.kv_quant:
            names.update(k_scale=dec.ks_out, v_scale=dec.vs_out)
        for key, outs in names.items():
            for i, n in enumerate(outs):
                if out[n] is not cache[key][i]:
                    cache[key][i].copy_(out[n])
        return out[dec.logits_name], cache

    # engine-facing fns (same signatures as models/llama.py) -------------
    def decode_fn(self, params, cfg, token, pos, cache):
        return self._forward(params, token, pos, cache)

    def prefill_fn(self, params, cfg, tokens, cache):
        """tokens [B, S] -> (logits [B, S, vocab], cache): the decode step
        at positions 0 .. S-1."""
        B, S = tokens.shape
        logits = []
        for s in range(S):
            pos = torch.full((B,), s, dtype=torch.int32,
                             device=tokens.device)
            lg, cache = self._forward(params, tokens[:, s], pos, cache)
            logits.append(lg)
        return torch.stack(logits, dim=1), cache

    def init_cache_fn(self, cfg, batch, max_seq=None, dtype=None, *,
                      device=None):
        from infinitensor_tpu_torch.models.llama import init_kv_cache
        return init_kv_cache(cfg, batch, max_seq=max_seq,
                             dtype=None if self.kv_quant
                             else (dtype or cfg.dtype),
                             kv_quant=self.kv_quant, device=device)


def bind_llama_weights(dec: GraphLlamaDecoder, executor, params: dict
                       ) -> None:
    """Bind a models/llama.py param dict (float or quantized) onto a
    decoder built with external_weights=True. Tensors already on the
    executor's device are adopted without a copy."""
    for name, v in _weights_from_params(params).items():
        executor.set_weight(name, v)


# ---------------------------------------------------------------------------
# Fused multi-step decode: `multi` greedy steps in one CUDA graph
# ---------------------------------------------------------------------------

class FusedGreedyDecode:
    """`multi` greedy decode steps of the GRAPH-IR model as one program:
    argmax token feedback and pos + 1 on the device, the KV state threaded
    through in place. On the card all `multi` steps are captured in ONE
    CUDA graph at the first call (the counterpart of the JAX package's
    lax.scan, graph_llama.py:379-422; the reference amortizes its per-op
    dispatch the same way with CUDA-Graph capture/replay,
    src/cuda/cuda_runtime.cc:351-426); on the CPU they run as a loop.

    ``fn(weights, tok, pos0, state) -> (tokens [B, multi], state)``; reuse
    the RETURNED state each call (it is updated in place; another state
    dict is copied in first)."""

    def __init__(self, dec: GraphLlamaDecoder, ex, multi: int):
        self.dec, self.ex, self.multi = dec, ex, int(multi)
        self.state_map = dec.state_map()
        self.state = {n: ex.input_zeros(n) for n in self.state_map}
        B = dec.batch
        self.tok = torch.zeros(B, dtype=torch.int32, device=ex.device)
        self.pos = torch.zeros(B, dtype=torch.int32, device=ex.device)
        self.toks = torch.zeros(B, self.multi, dtype=torch.int32,
                                device=ex.device)
        self.graph = None
        self._weights = None

    def _steps(self, weights, n: int) -> None:
        dec = self.dec
        for j in range(n):
            vals = {dec.token_name: self.tok, dec.pos_name: self.pos}
            vals.update(self.state)
            out = self.ex.forward(vals, weights)
            for k, v in self.state_map.items():
                if out[v] is not self.state[k]:
                    self.state[k].copy_(out[v])
            nxt = _greedy(out[dec.logits_name])
            self.toks[:, j].copy_(nxt)
            self.tok.copy_(nxt)
            self.pos.add_(1)

    def __call__(self, weights, tok, pos0, state):
        for k, v in state.items():
            if v is not self.state[k]:
                self.state[k].copy_(v)
        self.tok.copy_(torch.as_tensor(tok).reshape(-1).to(torch.int32))
        self.pos.copy_(torch.as_tensor(pos0).reshape(-1).to(torch.int32))
        if self.ex.device.type != "cuda":
            self._steps(weights, self.multi)
            return self.toks.clone(), self.state
        if self.graph is None or self._weights is not weights:
            # warm up one step (it writes the cache rows at pos; the state
            # is put back), then capture the `multi` steps
            self.graph = self.ex.capture(
                lambda _: self._steps(weights, self.multi),
                warmup=lambda _: self._steps(weights, 1),
                keep=[*self.state.values(), self.tok, self.pos])
            self._weights = weights
        self.graph.replay({})
        return self.toks.clone(), self.state


def make_fused_greedy_decode(dec: GraphLlamaDecoder, executor=None,
                             multi: int = 128, device=None):
    """Returns (fn, weights, init_state): ``fn(weights, tok, pos0, state)
    -> (tokens [B, multi], state)`` runs `multi` greedy steps of the graph
    model (on the card: one CUDA graph; see FusedGreedyDecode); weights
    are the executor's bound weights, init_state zero caches."""
    ex = _executor(dec, executor, device)
    fn = FusedGreedyDecode(dec, ex, multi)
    return fn, ex.bound_weights(), fn.state
