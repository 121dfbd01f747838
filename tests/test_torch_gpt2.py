"""The port's GPT-2 line against the JAX package on the same seeded inputs:
quant_matmul_ln, quantize_gpt2_params, gpt2_prefill / gpt2_decode_step,
the loader against HuggingFace, and ServingEngine with the GPT-2 functions.

quant_matmul_ln: the port's plain version (CPU tensors) against the JAX
kernel _kernel_group_ln in interpret mode, within one bf16 ulp of max|out|
(4e-3 of it). A group of 64 is refused by both fused kernels; both
packages then take LayerNorm + the chunk kernel + bias (the port's
qmm_chunk_plain on these CPU tensors), within the same bound.

Model, f32 parameters: no kernel on either side; logits within 1e-4 of
max|logit|. Model, bf16 + int8 weights (dim 128, 2 heads of 64, 2 layers,
group 128) with the JAX side under pallas_interpret=True, which on the CPU
gives this variant map: decode runs the interpreted _kernel_group_ln
(w_qkv, w_up) and the interpreted flash-decode kernels (D = 64), while
w_o, w_down and lm_head take dequantize + matmul (wo_matmul dispatches on
is_tpu(), weight_only.py:273-287), as does every prefill matmul. The port
runs qmm_group_ln_plain for w_qkv and w_up, the plain "group" kernel for
w_down (din 512), and dequantize + matmul for w_o and lm_head (din 128 <
512). Logits within 3e-2 of max|logit| and equal argmax, or a near-tie
within the measured error. With INFINITPU_GPT2_FUSED_LN=0 both sides take
LayerNorm + dequantize + matmul for w_qkv and w_up.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.kernels import quant_matmul as qm
from infinitensor_tpu.models import gpt2 as jg
from infinitensor_tpu.quant.weight_only import QuantizedLinear as JQ
from infinitensor_tpu.quant.weight_only import quantize_weight
from infinitensor_tpu.serving import engine as jeng
from infinitensor_tpu.utils.config import config

from infinitensor_tpu_torch.kernels import quant_matmul as tqm
from infinitensor_tpu_torch.models import gpt2 as tg
from infinitensor_tpu_torch.models.convert import (
    cache_from_jax_numpy, params_from_jax_numpy)
from infinitensor_tpu_torch.models.loader import (
    load_gpt2_params, load_llama_params)
from infinitensor_tpu_torch.serving import ServingEngine

OUT_TOL = 4e-3
SHAPE = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, max_seq=64)


def _t(a):
    return params_from_jax_numpy(np.asarray(a), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol=OUT_TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


LN_CASES = {
    "5rows_int8_bias": dict(rows=5, bits=8, bias=True),
    "64rows_int8_nobias": dict(rows=64, bits=8, bias=False),
    "3rows_int4_bias": dict(rows=3, bits=4, bias=True),
    "5rows_int8_padded": dict(rows=5, bits=8, bias=True, dout=200, pad=128),
    "5rows_int8_group64": dict(rows=5, bits=8, bias=True, group=64),
    "300rows_int8_bias": dict(rows=300, bits=8, bias=True),
    "5rows_int8_f32_gamma": dict(rows=5, bits=8, bias=True, ndt="float32"),
    # 64 rows: GPT-2's 64-slot step, the tensor-core form's shape
    "64rows_int8_bias": dict(rows=64, bits=8, bias=True),
    "64rows_int4_bias": dict(rows=64, bits=4, bias=True),
    "64rows_int4_nobias": dict(rows=64, bits=4, bias=False),
    "64rows_int8_f32_gamma": dict(rows=64, bits=8, bias=True, ndt="float32"),
    "64rows_int4_f32_gamma_nobias": dict(rows=64, bits=4, bias=False,
                                         ndt="float32"),
}


@pytest.mark.parametrize("case", list(LN_CASES))
def test_quant_matmul_ln_plain_vs_pallas(case):
    c = dict(dict(dout=256, pad=0, group=128, ndt="bfloat16"),
             **LN_CASES[case])
    rng = np.random.default_rng(len(case))
    din, eps = 512, 1e-5
    w = rng.standard_normal((din, c["dout"])).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=c["bits"],
                        group_size=c["group"], pad_out=c["pad"])
    x = jnp.asarray(rng.standard_normal((c["rows"], din)) * 2 + 0.3,
                    jnp.bfloat16)
    g = jnp.asarray(rng.uniform(0.5, 1.5, (din,)), c["ndt"])
    b = jnp.asarray(rng.standard_normal((din,)) * 0.1, c["ndt"])
    bias = jnp.asarray(rng.standard_normal((c["dout"],)) * 0.1,
                       jnp.bfloat16) if c["bias"] else None
    want = qm.quant_matmul_ln(x, g, b, q, bias=bias, eps=eps, interpret=True)
    tq = params_from_jax_numpy(
        JQ(np.asarray(q.qweight), np.asarray(q.scales), q.bits,
           q.group_size, q.out_logical), "cpu")
    before = dict(tqm.launches)
    got = tqm.quant_matmul_ln(_t(x), _t(g), _t(b), tq,
                              bias=None if bias is None else _t(bias),
                              eps=eps)
    assert got.shape == (c["rows"], c["dout"]) and got.dtype == torch.bfloat16
    _close(got, want)
    # above 256 rows the composition takes the dequant route
    routed = tqm.launches["dequant_matmul"] - before.get("dequant_matmul", 0)
    assert routed == (1 if c["rows"] > 256 else 0)
    if c["group"] == 64:
        # LayerNorm + the chunk kernel + bias
        xn = tqm.layer_norm(_t(x), _t(g), _t(b), eps)
        assert tqm.route(xn, tq) == ("qmm_chunk", 0)
        _close(got, tqm.qmm_chunk_plain(xn, tq) + _t(bias), 0)
    elif not routed:
        # the fused form equals the composition within the same bound
        xn = tqm.layer_norm(_t(x), _t(g), _t(b), eps)
        comp = tqm.quant_matmul(xn, tq, variant="group")
        _close(got, comp if bias is None else comp + _t(bias), 2e-2)


def test_quant_matmul_ln_f32_takes_the_composition():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=8, group_size=128)
    x = jnp.asarray(rng.standard_normal((4, 512)), jnp.float32)
    g = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((512,)) * 0.1, jnp.float32)
    want = qm.quant_matmul_ln(x, g, b, q, interpret=True)
    tq = params_from_jax_numpy(
        JQ(np.asarray(q.qweight), np.asarray(q.scales), 8, 128, 0), "cpu")
    got = tqm.quant_matmul_ln(_t(x), _t(g), _t(b), tq)
    assert got.dtype == torch.float32
    _close(got, want, 2e-2)


# -- the model -------------------------------------------------------------

def _carry(tree):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def f32_model():
    cfg_j = jg.GPT2Config.tiny(dtype=jnp.float32)
    params_j = jg.init_gpt2_params(cfg_j, jax.random.PRNGKey(2),
                                   dtype=jnp.float32)
    return (cfg_j, params_j, tg.GPT2Config.tiny(dtype=torch.float32),
            _carry(params_j))


@pytest.fixture(scope="module")
def q_model():
    cfg_j = jg.GPT2Config(**SHAPE)
    dense = jg.init_gpt2_params(cfg_j, jax.random.PRNGKey(0))
    # biases and LayerNorm vectors away from their 0 / 1 defaults
    rng = np.random.default_rng(5)
    for layer in dense["layers"]:
        for k in layer:
            if k.startswith("b_") or k.endswith("_b"):
                layer[k] = jnp.asarray(
                    rng.standard_normal(layer[k].shape) * 0.05, jnp.bfloat16)
            elif k.endswith("_g"):
                layer[k] = jnp.asarray(
                    rng.uniform(0.8, 1.2, layer[k].shape), jnp.bfloat16)
    params_j = jg.quantize_gpt2_params(dense, bits=8, group_size=128)
    return cfg_j, params_j, tg.GPT2Config(**SHAPE), _carry(params_j), dense


def _close_logits(lt, lj, tol):
    """Within tol of max|logit|; argmax equal, or a near-tie: JAX's logits
    of the two picks lie within the measured error of each other."""
    lt, lj = _f32(lt), _f32(lj)
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    err = np.max(np.abs(lt - lj))
    assert err <= tol * np.max(np.abs(lj)), (err, np.max(np.abs(lj)))
    at, aj = lt.argmax(-1), lj.argmax(-1)
    gap = np.take_along_axis(lj, aj[..., None], -1) \
        - np.take_along_axis(lj, at[..., None], -1)
    assert np.all(gap <= err), np.max(gap)


def _close_caches(cache_t, cache_j, tol):
    assert set(cache_t) == set(cache_j)
    quant = "k_scale" in cache_t
    for layer in range(len(cache_t["k"])):
        for key in ("k", "v"):
            got, want = _f32(cache_t[key][layer]), _f32(cache_j[key][layer])
            if quant:
                st = _f32(cache_t[key + "_scale"][layer])
                sj = _f32(cache_j[key + "_scale"][layer])
                np.testing.assert_allclose(st, sj, rtol=max(tol, 1e-6),
                                           atol=1e-8)
                got, want = got * st[..., None], want * sj[..., None]
            err = np.max(np.abs(got - want))
            assert err <= tol * np.max(np.abs(want)), (layer, key, err)


def _prefill_then_steps(cfg_j, params_j, cfg_t, params_t, kv_quant, dtype_j,
                        dtype_t, tol, interpret):
    rng = np.random.default_rng(11)
    B, S = 2, 7
    tokens = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    cache_j = jg.init_gpt2_cache(cfg_j, B, dtype=dtype_j, kv_quant=kv_quant)
    cache_t = tg.init_gpt2_cache(cfg_t, B, dtype=dtype_t, kv_quant=kv_quant,
                                 device="cpu")
    with config.override(pallas_interpret=interpret):
        lj, cache_j = jg.gpt2_prefill(params_j, cfg_j, jnp.asarray(tokens),
                                      cache_j)
    lt, out = tg.gpt2_prefill(params_t, cfg_t, torch.from_numpy(tokens),
                              cache_t)
    assert out is cache_t and lt.dtype == torch.float32
    assert lt.shape == (B, S, cfg_t.vocab_size)
    _close_logits(lt, lj, tol)
    _close_caches(cache_t, cache_j, max(tol, 2e-2) if kv_quant else tol)
    # decode from the JAX cache on both sides, so each step is held alone
    for step in range(3):
        cache_t = cache_from_jax_numpy(jax.tree.map(np.asarray, cache_j),
                                       "cpu")
        tok = rng.integers(0, cfg_j.vocab_size, (B,)).astype(np.int32)
        pos = np.asarray([S + step, S + step], np.int32)
        with config.override(pallas_interpret=interpret):
            lj, cache_j = jg.gpt2_decode_step(
                params_j, cfg_j, jnp.asarray(tok), jnp.asarray(pos), cache_j)
        lt, out = tg.gpt2_decode_step(params_t, cfg_t, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cache_t)
        assert out is cache_t and lt.shape == (B, cfg_t.vocab_size)
        assert lt.dtype == torch.float32
        _close_logits(lt, lj, tol)
        _close_caches(cache_t, cache_j, max(tol, 2e-2) if kv_quant else tol)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_f32_prefill_and_decode_match_jax(f32_model, kv_quant):
    _prefill_then_steps(*f32_model, kv_quant, jnp.float32, torch.float32,
                        1e-4, False)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_int8_prefill_and_decode_match_jax(q_model, kv_quant, fused,
                                           monkeypatch):
    monkeypatch.setenv("INFINITPU_GPT2_FUSED_LN", fused)
    calls = []
    fused_fn = tg.quant_matmul_ln
    monkeypatch.setattr(tg, "quant_matmul_ln", lambda *a, **k: (
        calls.append(1), fused_fn(*a, **k))[1])
    _prefill_then_steps(*q_model[:4], kv_quant, None, None, 3e-2, True)
    # w_qkv and w_up of 2 layers in each of the 3 decode steps, or none
    assert len(calls) == (12 if fused == "1" else 0)


def test_decode_matches_prefill_f32(f32_model):
    """prefill(3) + three decode steps give the logits of prefill(6), as
    tests/test_gpt2.py holds the JAX package."""
    _, _, cfg, params = f32_model
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 200, (1, 6)).astype(np.int32))
    full, _ = tg.gpt2_prefill(params, cfg, tokens, tg.init_gpt2_cache(
        cfg, 1, dtype=torch.float32, device="cpu"))
    cache = tg.init_gpt2_cache(cfg, 1, dtype=torch.float32, device="cpu")
    l3, cache = tg.gpt2_prefill(params, cfg, tokens[:, :3].contiguous(),
                                cache)
    np.testing.assert_allclose(l3.numpy(), full[:, :3].numpy(), rtol=2e-4,
                               atol=2e-4)
    for t in range(3, 6):
        lg, cache = tg.gpt2_decode_step(
            params, cfg, tokens[:, t], torch.full((1,), t,
                                                  dtype=torch.int32), cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_gpt2_params_bit_equal(q_model, bits):
    cfg_j, _, _, _, dense = q_model
    want = jg.quantize_gpt2_params(dense, bits=bits, group_size=128)
    got = tg.quantize_gpt2_params(_carry(dense), bits=bits, group_size=128)
    assert set(got) == set(want)
    pairs = [(got["lm_head_q"], want["lm_head_q"])]
    for lt, lj in zip(got["layers"], want["layers"]):
        assert set(lt) == set(lj)
        pairs += [(lt[k], lj[k]) for k in ("w_qkv", "w_o", "w_up", "w_down")]
        for k in ("b_qkv", "ln1_g", "ln2_b"):
            np.testing.assert_array_equal(_f32(lt[k]), _f32(lj[k]))
    for qt, qj in pairs:
        assert (qt.bits, qt.group_size, qt.out_logical) == \
            (qj.bits, qj.group_size, qj.out_logical)
        np.testing.assert_array_equal(qt.qweight.numpy(),
                                      np.asarray(qj.qweight))
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      np.asarray(qj.scales))
    assert got["lm_head_q"].out_physical == 1024
    assert got["lm_head_q"].out_features == cfg_j.vocab_size
    nolm = tg.quantize_gpt2_params(_carry(dense), quant_lm_head=False)
    assert "lm_head_q" not in nolm


def test_init_gpt2_params_and_configs():
    cfg = tg.GPT2Config.tiny()
    gen = torch.Generator().manual_seed(0)
    p = tg.init_gpt2_params(cfg, gen, device="cpu")
    jp = jg.init_gpt2_params(jg.GPT2Config.tiny(), jax.random.PRNGKey(0))
    assert set(p) == set(jp) and set(p["layers"][0]) == set(jp["layers"][0])
    for k, v in p["layers"][0].items():
        assert tuple(v.shape) == tuple(jp["layers"][0][k].shape), k
        assert v.dtype == torch.bfloat16
    assert tuple(p["wpe"].shape) == (cfg.max_seq, cfg.dim)
    small, jsmall = tg.GPT2Config.gpt2_small(), jg.GPT2Config.gpt2_small()
    assert (small.dim, small.n_layers, small.n_heads, small.head_dim) == \
        (jsmall.dim, jsmall.n_layers, jsmall.n_heads, jsmall.head_dim)
    full = tg.GPT2Config(max_seq=384)
    assert (full.dim, full.n_layers, full.n_heads, full.head_dim,
            full.vocab_size) == (1024, 24, 16, 64, 50257)


def test_hf_parity_through_load_gpt2_params(tmp_path):
    """f32 logits of gpt2_prefill on a randomly initialised HuggingFace
    GPT2LMHeadModel loaded through load_gpt2_params (from the state_dict,
    a torch.save file and a safetensors directory), rtol/atol 1e-3 as
    tests/test_loaders.py holds the JAX package."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(vocab_size=96, n_positions=32,
                                     n_embd=32, n_layer=2, n_head=4,
                                     attn_implementation="eager")
    torch.manual_seed(1)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = tg.GPT2Config(vocab_size=96, dim=32, n_layers=2, n_heads=4,
                        max_seq=32, dtype=torch.float32)
    tokens = np.random.default_rng(0).integers(0, 96, (1, 8))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    torch.save(sd, tmp_path / "model.bin")
    sources = [sd, str(tmp_path / "model.bin"), tmp_path]
    try:
        from safetensors.torch import save_file
        (tmp_path / "st").mkdir()
        # lm_head shares wte's storage: the loader never reads it
        save_file({k: v.contiguous() for k, v in sd.items()
                   if k != "lm_head.weight"},
                  str(tmp_path / "st" / "model.safetensors"))
        sources.append(tmp_path / "st")
    except ImportError:
        pass
    for src in sources:
        params = load_gpt2_params(src, cfg, dtype=torch.float32,
                                  device="cpu")
        got, _ = tg.gpt2_prefill(
            params, cfg, torch.from_numpy(tokens.astype(np.int32)),
            tg.init_gpt2_cache(cfg, 1, dtype=torch.float32, device="cpu"))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    with pytest.raises(FileNotFoundError):
        (tmp_path / "empty").mkdir()
        load_gpt2_params(tmp_path / "empty", cfg, device="cpu")


def test_load_llama_params_matches_jax_loader():
    transformers = pytest.importorskip("transformers")
    from infinitensor_tpu.models.loader import load_llama_params as jload
    from infinitensor_tpu.models.llama import LlamaConfig as JCfg
    from infinitensor_tpu_torch.models.llama import LlamaConfig
    hf_cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, tie_word_embeddings=False)
    torch.manual_seed(1)
    sd = transformers.LlamaForCausalLM(hf_cfg).state_dict()
    kw = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              intermediate=64, max_seq=32)
    want = jload(sd, JCfg(**kw))
    got = load_llama_params(sd, LlamaConfig(**kw), device="cpu")
    assert set(got) == set(want)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_f32(got[k]), _f32(want[k]))
    for lt, lj in zip(got["layers"], want["layers"]):
        assert set(lt) == set(lj)
        for k in lt:
            assert lt[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_f32(lt[k]), _f32(lj[k]))
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    got = load_llama_params(tied, LlamaConfig(**kw), device="cpu")
    assert torch.equal(got["lm_head"], got["embed"].t())


# -- serving -----------------------------------------------------------------

def _serve(engine_cls, params, cfg, init_cache, reqs, **kw):
    eng = engine_cls(params, cfg, max_slots=3, prefill_buckets=(8, 24),
                     init_cache_fn=init_cache, **kw)
    rs = [eng.submit(list(p), max_new_tokens=m, uid=i)
          for i, (p, m) in enumerate(reqs)]
    eng.run_to_completion()
    assert all(r.done and len(r.generated) == m
               for r, (_, m) in zip(rs, reqs))
    return [list(r.generated) for r in rs]


SERVE_CASES = {
    "bf16_cache": dict(kv_quant=False, decode_chunk=2),
    "int8_cache": dict(kv_quant=True, decode_chunk=2),
    "lookahead": dict(kv_quant=False, decode_chunk=4, pipeline_depth=2,
                      lookahead=True),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_gpt2_serving_engine_tokens_match_jax(f32_model, case):
    """f32 parameters (as tests/test_gpt2.py serves them): no bf16
    near-ties, so the token lists are held equal outright."""
    cfg_j, params_j, cfg_t, params_t = f32_model
    kw = dict(SERVE_CASES[case])
    kv_quant = kw.pop("kv_quant")
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(1, cfg_j.vocab_size, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(3, 20, 7), rng.integers(4, 10, 7))]
    want = _serve(jeng.ServingEngine, params_j, cfg_j,
                  functools.partial(jg.init_gpt2_cache, kv_quant=kv_quant),
                  reqs, prefill_fn=jg.gpt2_prefill,
                  decode_fn=jg.gpt2_decode_step, **kw)
    got = _serve(ServingEngine, params_t, cfg_t,
                 functools.partial(tg.init_gpt2_cache, kv_quant=kv_quant),
                 reqs, prefill_fn=tg.gpt2_prefill,
                 decode_fn=tg.gpt2_decode_step, device="cpu", **kw)
    assert got == want


def test_gpt2_int8_serving_equals_batch1_loop(q_model):
    """The bf16 + int8-weight model through the engine: one request's
    tokens equal a batch-1 prefill + decode loop up to a first near-tie
    (bf16 logits one ulp apart flip in a batch)."""
    _, _, cfg, params, _ = q_model
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(1, cfg.vocab_size, int(n)).tolist(), 8)
            for n in (5, 12, 9, 17)]
    got = _serve(ServingEngine, params, cfg, tg.init_gpt2_cache, reqs,
                 prefill_fn=tg.gpt2_prefill, decode_fn=tg.gpt2_decode_step,
                 decode_chunk=4, device="cpu")
    for (prompt, m), g in zip(reqs, got):
        cache = tg.init_gpt2_cache(cfg, 1, device="cpu")
        logits, cache = tg.gpt2_prefill(
            params, cfg, torch.tensor([prompt], dtype=torch.int32), cache)
        last, want = logits[0, -1], []
        for j in range(m):
            tok = int(last.argmax())
            if tok != g[j]:
                ulp = 2.0 ** (math.floor(math.log2(float(last.abs().max())))
                              - 7)
                assert abs(float(last[tok] - last[g[j]])) <= ulp, (j, g, want)
                break
            want.append(tok)
            step, cache = tg.gpt2_decode_step(
                params, cfg, torch.tensor([tok], dtype=torch.int32),
                torch.tensor([len(prompt) + j], dtype=torch.int32), cache)
            last = step[0]


def test_spec_decode_refused_without_verify_fn(f32_model):
    _, _, cfg, params = f32_model
    with pytest.raises(ValueError, match="verify_fn"):
        ServingEngine(params, cfg, max_slots=2, spec_decode=4,
                      prefill_fn=tg.gpt2_prefill,
                      decode_fn=tg.gpt2_decode_step,
                      init_cache_fn=tg.init_gpt2_cache, device="cpu")


def test_serving_bench_tool_on_a_tiny_model():
    """The bench's serve() end to end on the CPU at a tiny size: every
    request done with its 64 tokens, the result's keys as the JAX tool's."""
    from infinitensor_tpu_torch.tools import serving_bench as sb
    cfg = tg.GPT2Config(vocab_size=128, dim=32, n_layers=1, n_heads=2,
                        max_seq=384)
    params = sb.build_params(cfg, "cpu")
    assert params["lm_head_q"].out_physical == 1024
    prompts = sb.workload(2, vocab_hi=128)[:5]
    assert len(sb.workload(64)) == 192
    assert all(16 <= len(p) < 250 for p in sb.workload(64))
    result, toks, eng = sb.serve(params, cfg, slots=2, chunk=16, pipeline=2,
                                 reps=1, prompts=prompts, device="cpu")
    assert result["all_done"] and result["device"] == "cpu"
    assert [len(t) for t in toks] == [64] * 5
    for key in ("metric", "value", "unit", "samples", "spread_pct",
                "requests", "decode_steps", "wall_s", "warmup_s",
                "decode_chunk", "pipeline_depth", "stats"):
        assert key in result
    assert eng.decode_chunk == 16 and eng.lookahead


def test_lookahead_engine_reused_after_a_drain(f32_model):
    """A lookahead engine drained twice (as the bench's warm-up and reps
    do) gives the fresh engine's tokens both times. The JAX engine keeps
    its device-side (token, pos) chain across drains, so its second
    drain's first wave decodes from the first drain's last state; the port
    drops the chain whenever host state is brought up to date."""
    cfg_j, params_j, cfg_t, params_t = f32_model
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, cfg_j.vocab_size, int(n)).tolist(), 9)
            for n in rng.integers(3, 20, 5)]

    def drains(eng, n):
        out = []
        for _ in range(n):
            rs = [eng.submit(list(p), max_new_tokens=m) for p, m in reqs]
            eng.run_to_completion()
            out.append([list(r.generated) for r in rs])
        return out

    kw = dict(max_slots=3, prefill_buckets=(8, 24), decode_chunk=4,
              pipeline_depth=2, lookahead=True)
    first, second = drains(ServingEngine(
        params_t, cfg_t, prefill_fn=tg.gpt2_prefill,
        decode_fn=tg.gpt2_decode_step, init_cache_fn=tg.init_gpt2_cache,
        device="cpu", **kw), 2)
    # the reference is a FRESH JAX engine's one drain, for both: a reused
    # JAX engine has the fault itself (ROADMAP Queue 3) and is no reference
    fresh, = drains(jeng.ServingEngine(
        params_j, cfg_j, prefill_fn=jg.gpt2_prefill,
        decode_fn=jg.gpt2_decode_step, init_cache_fn=jg.init_gpt2_cache,
        **kw), 1)
    assert first == fresh
    assert second == fresh
