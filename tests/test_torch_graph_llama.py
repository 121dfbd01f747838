"""The graph-built Llama of the port (models/graph_llama.py through
GraphExecutor) against the JAX package's, on the same parameters carried
across by models/convert.py, on the CPU.

Tolerances: greedy tokens are equal. f32 graphs compute the same f32
functions on both sides (summation order aside); the quantized graphs run
MatMulWOQ on f32 activations, which both packages take off the chip as
dequantize + f32 matmul, and their INT8 caches hold the same codes. The
bf16 GQA graph rounds at the same points on both sides (each op's output
in bf16, f32 accumulation inside). The graph against the port's
hand-written decode step: tokens equal in f32, and in bf16 equal or a
first difference that is a near-tie of the graph's own logits (their
final RMSNorm rounds once, the hand-written one twice, as in the JAX
package).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.models import graph_llama as jg
from infinitensor_tpu.models import llama as jl
from infinitensor_tpu.serving.engine import ServingEngine as JEngine

from infinitensor_tpu_torch.kernels import norms as tnorms
from infinitensor_tpu_torch.models import graph_llama as tg
from infinitensor_tpu_torch.models import llama as tl
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.serving.engine import ServingEngine

MHA = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
           intermediate=96, max_seq=32)
GQA = dict(vocab_size=128, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate=192, max_seq=32)
STEPS = 8


def _pair(shape, seed, dtype=jnp.float32, bits=None):
    """(cfg_j, params_j, cfg_t, params_t): JAX params made from a seed,
    quantized when bits is given, carried into the port."""
    cfg_j = jl.LlamaConfig(dtype=dtype, **shape)
    params_j = jl.init_llama_params(cfg_j, jax.random.PRNGKey(seed),
                                    dtype=dtype)
    if bits:
        params_j = jl.quantize_llama_params(params_j, bits=bits,
                                            group_size=128)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return cfg_j, params_j, tl.LlamaConfig(dtype=tdt, **shape), params_t


def _jax_graph_tokens(params_j, cfg_j, first, kv_quant=False):
    dec = jg.build_llama_decoder(params_j, cfg_j, batch=1,
                                 kv_quant=kv_quant)
    return list(jg.graph_greedy_decode(dec, first_token=first,
                                       n_steps=STEPS, start_pos=0)[0])


def _port_graph(params_t, cfg_t, kv_quant=False, **kw):
    return tg.build_llama_decoder(params_t, cfg_t, batch=1,
                                  kv_quant=kv_quant, **kw)


def _port_graph_tokens(params_t, cfg_t, first, kv_quant=False):
    dec = _port_graph(params_t, cfg_t, kv_quant)
    return list(tg.graph_greedy_decode(dec, first_token=first,
                                       n_steps=STEPS, start_pos=0,
                                       device="cpu")[0])


def _native_logits(params_t, cfg_t, first, kv_quant=False):
    """The port's hand-written decode, greedy: (tokens, logits per step)."""
    cache = tl.init_kv_cache(cfg_t, 1, kv_quant=kv_quant, device="cpu")
    tok = torch.full((1,), first, dtype=torch.int32)
    toks, logits = [], []
    for j in range(STEPS):
        lg, cache = tl.llama_decode_step(
            params_t, cfg_t, tok, torch.full((1,), j, dtype=torch.int32),
            cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
        toks.append(int(tok[0]))
        logits.append(lg[0].float())
    return toks, logits


def test_graph_decode_f32_matches_jax_and_native():
    cfg_j, params_j, cfg_t, params_t = _pair(MHA, 7)
    got = _port_graph_tokens(params_t, cfg_t, 5)
    assert got == _jax_graph_tokens(params_j, cfg_j, 5)
    assert got == _native_logits(params_t, cfg_t, 5)[0]


def test_graph_decode_bf16_gqa_matches_jax():
    cfg_j, params_j, cfg_t, params_t = _pair(GQA, 3, dtype=jnp.bfloat16)
    got = _port_graph_tokens(params_t, cfg_t, 5)
    assert got == _jax_graph_tokens(params_j, cfg_j, 5)
    # against the hand-written path: equal up to a near-tie of the graph's
    # logits at the first difference
    want, _ = _native_logits(params_t, cfg_t, 5)
    if got != want:
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        dec = _port_graph(params_t, cfg_t)
        step = GraphExecutor(dec.graph, device="cpu").stepper(
            dec.state_map())
        tok = np.array([5], np.int32)
        for i in range(j + 1):
            lg = step({dec.token_name: tok,
                       dec.pos_name: np.array([i], np.int32)}
                      )[dec.logits_name][0].float()
            tok = np.array([got[i]], np.int32)
        gap = float(lg[got[j]] - lg[want[j]])
        assert 0 <= gap <= 2.0 ** -7 * float(lg.abs().max()), (j, gap)


@pytest.mark.parametrize("bits", [8, 4])
def test_graph_decode_quantized_gqa_kv8_matches_jax(bits):
    """f32 activations into MatMulWOQ (quant_matmul on an f32 x, which
    raised before ROADMAP Queue 3 item 1 was repaired) + GQA + INT8 KV."""
    cfg_j, params_j, cfg_t, params_t = _pair(GQA, 11, bits=bits)
    dec = _port_graph(params_t, cfg_t, kv_quant=True)
    ops = {op.op_type for op in dec.graph.operators}
    assert "MatMulWOQ" in ops and "AttentionKVCacheQ8" in ops
    assert "MatMul" not in ops
    got = list(tg.graph_greedy_decode(dec, first_token=7, n_steps=STEPS,
                                      start_pos=0, device="cpu")[0])
    assert got == _jax_graph_tokens(params_j, cfg_j, 7, kv_quant=True)
    assert got == _native_logits(params_t, cfg_t, 7, kv_quant=True)[0]


def test_stepper_state_is_device_side_and_in_place():
    _, _, cfg_t, params_t = _pair(MHA, 7)
    dec = _port_graph(params_t, cfg_t)
    ex = GraphExecutor(dec.graph, device="cpu")
    step = ex.stepper(dec.state_map())
    k0 = step.state[dec.k_in[0]]
    step({dec.token_name: np.array([3], np.int32),
          dec.pos_name: np.array([0], np.int32)})
    assert step.state[dec.k_in[0]] is k0        # updated in place
    snap = step.fetch_state()
    k0 = snap[dec.k_in[0]]
    assert k0.shape == (1, cfg_t.n_heads, cfg_t.max_seq, cfg_t.head_dim)
    assert np.abs(k0[:, :, 0]).max() > 0        # row 0 was written
    assert np.abs(k0[:, :, 1:]).max() == 0      # nothing else touched


def test_stepper_rejects_bad_state_map():
    _, _, cfg_t, params_t = _pair(MHA, 7)
    dec = _port_graph(params_t, cfg_t)
    ex = GraphExecutor(dec.graph, device="cpu")
    with pytest.raises(ValueError, match="state_map"):
        ex.stepper({"nonexistent": dec.k_out[0]})
    with pytest.raises(ValueError, match="state_map"):
        ex.stepper({dec.k_in[0]: "nonexistent"})


def test_run_leaves_the_callers_cache_unchanged():
    """GraphExecutor.run on caller-owned cache tensors returns the
    appended caches and leaves the caller's tensors as they were; the
    returned logits equal the stepper's first step."""
    _, _, cfg_t, params_t = _pair(MHA, 7)
    dec = _port_graph(params_t, cfg_t)
    ex = GraphExecutor(dec.graph, device="cpu")
    cache = tl.init_kv_cache(cfg_t, 1, dtype=torch.float32, device="cpu")
    feeds = {dec.token_name: torch.tensor([3], dtype=torch.int32),
             dec.pos_name: torch.tensor([0], dtype=torch.int32)}
    for i in range(cfg_t.n_layers):
        feeds[dec.k_in[i]] = cache["k"][i]
        feeds[dec.v_in[i]] = cache["v"][i]
    out = ex.run(feeds)
    assert all(not c.any() for c in cache["k"] + cache["v"])
    assert out[dec.k_out[0]][:, :, 0].abs().max() > 0
    want = ex.stepper(dec.state_map())(
        {dec.token_name: np.array([3], np.int32),
         dec.pos_name: np.array([0], np.int32)})
    torch.testing.assert_close(out[dec.logits_name], want[dec.logits_name],
                               rtol=0, atol=0)


def test_fused_greedy_decode_matches_stepper():
    """make_fused_greedy_decode across chained calls gives the stepper's
    token stream (the JAX test's form: two calls of 4 steps)."""
    _, _, cfg_t, params_t = _pair(GQA, 21, bits=8)
    dec = _port_graph(params_t, cfg_t, kv_quant=True)
    want = tg.graph_greedy_decode(dec, first_token=4, n_steps=8,
                                  start_pos=0, device="cpu")
    fn, weights, state = tg.make_fused_greedy_decode(dec, multi=4,
                                                     device="cpu")
    t1, state = fn(weights, torch.tensor([4], dtype=torch.int32),
                   torch.tensor([0], dtype=torch.int32), state)
    t2, state = fn(weights, t1[:, -1], torch.tensor([4], dtype=torch.int32),
                   state)
    got = torch.cat([t1, t2], dim=1).numpy()
    assert list(got[0]) == list(want[0])


def test_external_weights_binding():
    """external_weights=True builds from shapes only; placeholders raise
    until bind_llama_weights binds the tensors (adopted, not copied)."""
    _, _, cfg_t, params_t = _pair(GQA, 31, bits=8)
    dec = _port_graph(params_t, cfg_t, kv_quant=True)
    want = tg.graph_greedy_decode(dec, first_token=6, n_steps=6,
                                  start_pos=0, device="cpu")
    dec2 = _port_graph(params_t, cfg_t, kv_quant=True, external_weights=True)
    ex = GraphExecutor(dec2.graph, device="cpu")
    with pytest.raises(ValueError, match="placeholder"):
        tg.graph_greedy_decode(dec2, first_token=6, n_steps=1, start_pos=0,
                               executor=ex)
    tg.bind_llama_weights(dec2, ex, params_t)
    assert ex.bound_weights()["l0.wqkv.qweight"] is \
        params_t["layers"][0]["wqkv"].qweight
    got = tg.graph_greedy_decode(dec2, first_token=6, n_steps=6,
                                 start_pos=0, executor=ex)
    assert list(got[0]) == list(want[0])


@pytest.mark.parametrize("bits", [None, 4])
def test_serving_adapter_matches_jax(bits):
    """ServingEngine over GraphLlamaServingAdapter (f32, or INT4 weights
    with the INT8 cache) emits the JAX adapter engine's tokens, and the
    port's native engine's."""
    shape = MHA if bits is None else GQA
    cfg_j, params_j, cfg_t, params_t = _pair(shape, 41, bits=bits)
    kv_quant = bits is not None
    prompts = [[3, 5, 7], [11, 13]]

    def drain(eng):
        rs = [eng.submit(p, max_new_tokens=5, uid=90 + i)
              for i, p in enumerate(prompts)]
        eng.run_to_completion()
        return [list(r.generated) for r in rs]

    ad_j = jg.GraphLlamaServingAdapter(params_j, cfg_j, kv_quant=kv_quant)
    want = drain(JEngine(params_j, cfg_j, max_slots=2, prefill_buckets=(8,),
                         prefill_fn=ad_j.prefill_fn,
                         decode_fn=ad_j.decode_fn,
                         init_cache_fn=ad_j.init_cache_fn))
    ad = tg.GraphLlamaServingAdapter(params_t, cfg_t, kv_quant=kv_quant)
    got = drain(ServingEngine(params_t, cfg_t, max_slots=2,
                              prefill_buckets=(8,), prefill_fn=ad.prefill_fn,
                              decode_fn=ad.decode_fn,
                              init_cache_fn=ad.init_cache_fn, device="cpu"))
    assert got == want
    native = drain(ServingEngine(params_t, cfg_t, max_slots=2,
                                 prefill_buckets=(8,), kv_quant=kv_quant,
                                 device="cpu"))
    assert got == native


def test_graph_final_norm_is_the_rmsnorm_op():
    """The graph's final RMSNorm is the RMSNorm op (f32 weight product,
    one rounding): the graph's logits equal the hand-written step's with
    norms.rmsnorm_plain in place of the model's norm (f32: equal)."""
    _, _, cfg_t, params_t = _pair(MHA, 5)
    dec = _port_graph(params_t, cfg_t)
    ops = [op for op in dec.graph.operators if op.op_type == "RMSNorm"]
    assert len(ops) == 2 * cfg_t.n_layers + 1
    x = torch.randn(1, 64, generator=torch.Generator().manual_seed(0))
    w = params_t["final_norm"]
    torch.testing.assert_close(tnorms.rmsnorm(x, w, 1e-5),
                               tl.rmsnorm(x, w, 1e-5), rtol=1e-6, atol=1e-6)
