"""A small INT4 Llama in the port against the JAX package on the same
weights: three INT8-cache decode steps, prefill into both caches, a
bf16-cache decode step, a verify step and greedy_generate.

The JAX side runs under pallas_interpret=True, which on the CPU gives this
variant map: the fused-norm group kernel (wqkv, w_gateup) and the INT8
flash-decode kernel run interpreted, while wo, w_down and lm_head take
dequantize + matmul (wo_matmul dispatches on is_tpu(), not use_pallas()).
The port runs the plain version of its "group" kernel for every matmul:
none of these shapes is in the variant table. So logits agree within
3e-2 of max|logit| (bf16 rounding of the dequantized weight on one side,
of f32 group sums on the other), and argmax is equal.

Layer 0's K/V rows come from the same fused-norm kernel on both sides,
so its cache holds the same codes (within +-1) and scales (within 1e-6
relative); later layers see inputs that went through the two matmul paths
and agree within +-2 codes and 2e-2 relative on the scales.

Prefill and verify run every projection unfused through _linear. On the
JAX side (pallas_interpret=True, so flash_attention is its interpreted
kernel where S is a multiple of its block, else mha_ref) that is
dequantize + matmul; in the port it is the plain "group" kernel up to 256
rows and the same dequantize + matmul above. Logits at every position
agree within 3e-2 of max|logit| with equal argmax or a near-tie within
that measured error (bf16 logits of random weights tie often); the K/V
rows, dequantized for the INT8 cache, within 2e-2 of their max and the
INT8 scales within 2e-2 relative (measured: 1.4e-2 and 1.1e-2 after two
layers; the int8 codes then differ by up to 3 where a row's scale moved
by 1 %); greedy tokens are equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.models import llama as jl
from infinitensor_tpu.utils.config import config

from infinitensor_tpu_torch.kernels import quant_matmul as tqm
from infinitensor_tpu_torch.models import llama as tl
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy

SHAPE = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
             intermediate=1024, max_seq=128)


@pytest.fixture(scope="module")
def model():
    cfg_j = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    params_j = jl.quantize_llama_params(
        jl.init_llama_params(cfg_j, jax.random.PRNGKey(0)), bits=4,
        group_size=128)
    cache_j = jl.init_kv_cache(cfg_j, 2, kv_quant=True)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    cfg_t = tl.LlamaConfig(**SHAPE)
    return cfg_j, params_j, cache_j, cfg_t, params_t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close_logits(lt, lj, ties=False):
    """Within 3e-2 of max|logit|, argmax equal. With ties, a position may
    pick another argmax where it is a near-tie: JAX's logits of the two
    picks lie within the measured error of each other (logits are bf16,
    1/64 apart near 3, and random weights give such ties)."""
    lt, lj = _f32(lt), _f32(lj)
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    err = np.max(np.abs(lt - lj))
    assert err <= 3e-2 * np.max(np.abs(lj)), err
    at, aj = lt.argmax(-1), lj.argmax(-1)
    if not ties:
        np.testing.assert_array_equal(at, aj)
        return
    gap = np.take_along_axis(lj, aj[..., None], -1) \
        - np.take_along_axis(lj, at[..., None], -1)
    assert np.all(gap <= err), np.max(gap)


def _close_caches(cache_t, cache_j):
    """Every layer's K/V rows (dequantized for an INT8 cache) within 2e-2
    of their max, INT8 scales within 2e-2 relative."""
    quant = "k_scale" in cache_t
    for layer in range(SHAPE["n_layers"]):
        for key in ("k", "v"):
            got, want = _f32(cache_t[key][layer]), _f32(cache_j[key][layer])
            if quant:
                st = _f32(cache_t[key + "_scale"][layer])
                sj = _f32(cache_j[key + "_scale"][layer])
                np.testing.assert_allclose(st, sj, rtol=2e-2, atol=0)
                got, want = got * st[..., None], want * sj[..., None]
            err = np.max(np.abs(got - want))
            assert err <= 2e-2 * np.max(np.abs(want)), (layer, key, err)


def _caches(cfg_j, cfg_t, batch, kv_quant, max_seq=None):
    return (jl.init_kv_cache(cfg_j, batch, max_seq, kv_quant=kv_quant),
            tl.init_kv_cache(cfg_t, batch, max_seq, kv_quant=kv_quant,
                             device="cpu"))


def _prompt(batch, S, seed=7):
    return np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], (batch, S)).astype(np.int32)


def test_decode_steps_match_jax(model):
    cfg_j, params_j, cache_j, cfg_t, params_t = model
    cache_t = tl.init_kv_cache(cfg_t, 2, device="cpu", kv_quant=True)
    tokens = [[3, 100], [17, 200], [42, 300]]
    for step, tok in enumerate(tokens):
        pos = [5 + step, 5 + step]
        with config.override(pallas_interpret=True):
            lj, cache_j = jl.llama_decode_step(
                params_j, cfg_j, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cache_j)
        lt, cache_t = tl.llama_decode_step(
            params_t, cfg_t, torch.tensor(tok, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), cache_t)
        lj, lt = _f32(lj), _f32(lt)
        assert lt.shape == lj.shape == (2, SHAPE["vocab_size"])
        assert np.isfinite(lt).all()
        _close_logits(lt, lj)
    for layer in range(SHAPE["n_layers"]):
        codes, rel = (1, 1e-6) if layer == 0 else (2, 2e-2)
        for key, skey in (("k", "k_scale"), ("v", "v_scale")):
            dq = np.abs(cache_t[key][layer].numpy().astype(np.int32)
                        - np.asarray(cache_j[key][layer]).astype(np.int32))
            assert dq.max() <= codes, (layer, key, dq.max())
            np.testing.assert_allclose(cache_t[skey][layer].numpy(),
                                       np.asarray(cache_j[skey][layer]),
                                       rtol=rel, atol=0)


def test_decode_multi_equals_step_loop(model):
    _, _, _, cfg_t, params_t = model
    tok0 = torch.tensor([3, 100], dtype=torch.int32)
    pos0 = torch.tensor([5, 9], dtype=torch.int32)
    cache = tl.init_kv_cache(cfg_t, 2, device="cpu", kv_quant=True)
    toks, last, pos, cache = tl.llama_decode_multi(params_t, cfg_t, tok0,
                                                   pos0, cache, 4)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    ref_cache = tl.init_kv_cache(cfg_t, 2, device="cpu", kv_quant=True)
    tok, p, want = tok0, pos0, []
    for _ in range(4):
        logits, ref_cache = tl.llama_decode_step(params_t, cfg_t, tok, p,
                                                 ref_cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        want.append(tok)
        p = p + 1
    torch.testing.assert_close(toks, torch.stack(want, 1), rtol=0, atol=0)
    torch.testing.assert_close(last, tok, rtol=0, atol=0)
    torch.testing.assert_close(pos, pos0 + 4, rtol=0, atol=0)
    for a, b in zip(cache["k"], ref_cache["k"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_matches_jax(model, kv_quant):
    cfg_j, params_j, _, cfg_t, params_t = model
    cache_j, cache_t = _caches(cfg_j, cfg_t, 2, kv_quant)
    prompt = _prompt(2, 40)
    with config.override(pallas_interpret=True):
        lj, cache_j = jl.llama_prefill(params_j, cfg_j, jnp.asarray(prompt),
                                       cache_j)
    lt, out = tl.llama_prefill(params_t, cfg_t, torch.from_numpy(prompt),
                               cache_t)
    assert out is cache_t and lt.shape == (2, 40, SHAPE["vocab_size"])
    _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)


def test_bf16_cache_decode_step_matches_jax(model):
    cfg_j, params_j, _, cfg_t, params_t = model
    cache_j, cache_t = _caches(cfg_j, cfg_t, 2, False)
    for step, tok in enumerate([[3, 100], [17, 200]]):
        pos = [5 + step, 9 + step]
        with config.override(pallas_interpret=True):
            lj, cache_j = jl.llama_decode_step(
                params_j, cfg_j, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cache_j)
        lt, cache_t = tl.llama_decode_step(
            params_t, cfg_t, torch.tensor(tok, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), cache_t)
        _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_verify_step_matches_jax(model, kv_quant):
    cfg_j, params_j, _, cfg_t, params_t = model
    cache_j, cache_t = _caches(cfg_j, cfg_t, 2, kv_quant)
    prompt = _prompt(2, 16)
    pos = np.asarray([16, 16], np.int32)
    with config.override(pallas_interpret=True):
        _, cache_j = jl.llama_prefill(params_j, cfg_j, jnp.asarray(prompt),
                                      cache_j)
        lj, cache_j = jl.llama_verify_step(
            params_j, cfg_j, jnp.asarray(prompt[:, :4]), jnp.asarray(pos),
            cache_j)
    tl.llama_prefill(params_t, cfg_t, torch.from_numpy(prompt), cache_t)
    lt, cache_t = tl.llama_verify_step(
        params_t, cfg_t, torch.from_numpy(prompt[:, :4]),
        torch.from_numpy(pos), cache_t)
    assert lt.shape == (2, 4, SHAPE["vocab_size"])
    _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)


def test_greedy_generate_matches_jax(model):
    cfg_j, params_j, _, cfg_t, params_t = model
    prompt = _prompt(2, 12)
    with config.override(pallas_interpret=True):
        want, cache_j = jl.greedy_generate(params_j, cfg_j,
                                           jnp.asarray(prompt), 5)
    got, cache_t = tl.greedy_generate(params_t, cfg_t,
                                      torch.from_numpy(prompt), 5)
    assert got.shape == (2, 5) and got.dtype == torch.int32
    assert cache_t["k"][0].dtype == torch.bfloat16 and "k_scale" not in \
        cache_t
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close_caches(cache_t, cache_j)
    # prefill + (n_steps - 1) decode steps from pos S, as a loop
    ref, _ = tl.greedy_generate(params_t, cfg_t, torch.from_numpy(prompt), 1)
    assert torch.equal(ref[:, 0], got[:, 0])


def test_long_prompt_prefill_takes_dequant_route(model):
    """1300 tokens: every matmul has more than 256 rows, so the port takes
    the dequant route, as the JAX package takes quant_matmul_ref (and
    mha_ref for attention: 1300 is not a multiple of its block)."""
    cfg_j, params_j, _, cfg_t, params_t = model
    S = 1300
    cache_j, cache_t = _caches(cfg_j, cfg_t, 1, False, max_seq=S + 4)
    prompt = _prompt(1, S, seed=8)
    with config.override(pallas_interpret=True):
        lj, cache_j = jl.llama_prefill(params_j, cfg_j, jnp.asarray(prompt),
                                       cache_j)
    before = tqm.launches["dequant_matmul"]
    lt, _ = tl.llama_prefill(params_t, cfg_t, torch.from_numpy(prompt),
                             cache_t)
    # wqkv, wo, w_gateup, w_down per layer, and the lm_head
    assert tqm.launches["dequant_matmul"] - before == \
        4 * SHAPE["n_layers"] + 1
    _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)


def test_dense_unfused_prefill_and_step_match_jax():
    """Dense bf16 parameters with separate wq/wk/wv and w_gate/w_up (the
    layout init_llama_params gives): _qkv and _mlp take the unfused
    branch; prefill, then one bf16-cache decode step."""
    cfg_j = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    params_j = jl.init_llama_params(cfg_j, jax.random.PRNGKey(1))
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    cfg_t = tl.LlamaConfig(**SHAPE)
    cache_j, cache_t = _caches(cfg_j, cfg_t, 2, False)
    prompt = _prompt(2, 24, seed=9)
    tok, pos = np.asarray([5, 6], np.int32), np.asarray([24, 24], np.int32)
    with config.override(pallas_interpret=True):
        lj, cache_j = jl.llama_prefill(params_j, cfg_j, jnp.asarray(prompt),
                                       cache_j)
        sj, cache_j = jl.llama_decode_step(params_j, cfg_j, jnp.asarray(tok),
                                           jnp.asarray(pos), cache_j)
    lt, cache_t = tl.llama_prefill(params_t, cfg_t, torch.from_numpy(prompt),
                                   cache_t)
    st, cache_t = tl.llama_decode_step(params_t, cfg_t, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cache_t)
    _close_logits(lt, lj, ties=True)
    _close_logits(st, sj, ties=True)
    _close_caches(cache_t, cache_j)


def test_hf_transformers_parity():
    """f32 logits of the port's llama_prefill against a randomly
    initialised HuggingFace LlamaForCausalLM (eager attention, CPU) with
    the same weights, within rtol/atol 1e-3 as tests/test_llama.py holds
    the JAX package: both are f32 throughout, so only summation order
    differs."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        attn_implementation="eager", tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = tl.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, intermediate=128, max_seq=64,
                         norm_eps=1e-5, dtype=torch.float32)
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {k: sd[p + n + ".weight"].T.contiguous()
                 for k, n in names.items()}
        layer["attn_norm"] = sd[p + "input_layernorm.weight"]
        layer["mlp_norm"] = sd[p + "post_attention_layernorm.weight"]
        layers.append(layer)
    params = {"embed": sd["model.embed_tokens.weight"],
              "final_norm": sd["model.norm.weight"],
              "lm_head": sd["lm_head.weight"].T.contiguous(),
              "layers": layers}
    tokens = np.random.default_rng(0).integers(0, 128, (2, 10))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    cache = tl.init_kv_cache(cfg, 2, dtype=torch.float32, device="cpu")
    got, _ = tl.llama_prefill(params, cfg,
                              torch.from_numpy(tokens.astype(np.int32)),
                              cache)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


# -- quantize_llama_params(fuse, paired) and the paired decode ---------------

def _three_steps(params_j, params_t, cfg_j, cfg_t):
    cache_j = jl.init_kv_cache(cfg_j, 2, kv_quant=True)
    cache_t = tl.init_kv_cache(cfg_t, 2, kv_quant=True, device="cpu")
    for step, tok in enumerate([[3, 100], [17, 200], [42, 300]]):
        pos = [5 + step, 9 + step]
        with config.override(pallas_interpret=True):
            lj, cache_j = jl.llama_decode_step(
                params_j, cfg_j, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cache_j)
        lt, cache_t = tl.llama_decode_step(
            params_t, cfg_t, torch.tensor(tok, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), cache_t)
        _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)


QUANT_CASES = {
    "paired": dict(bits=4, paired=True),
    "unfused": dict(bits=4, fuse=False),
    "int8_paired_ignored": dict(bits=8, paired=True, steps=False),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_llama_params_variants_match_jax(case):
    """Three INT8-cache decode steps with the weights of
    quantize_llama_params(fuse=..., paired=...), quantized by the port
    from the same dense parameters: bytes and scales bit-equal to the JAX
    package's, then logits as in test_decode_steps_match_jax. Under
    pallas_interpret=True the JAX side runs the interpreted slab kernels
    (_kernel_group_norm_slab) for the paired wqkv and w_gateup; the port
    runs qmm_slab_plain for every paired matmul."""
    kw = dict(QUANT_CASES[case])
    steps = kw.pop("steps", True)
    cfg_j = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    dense = jl.init_llama_params(cfg_j, jax.random.PRNGKey(3))
    params_j = jl.quantize_llama_params(dense, group_size=128, **kw)
    dense_t = params_from_jax_numpy(jax.tree.map(np.asarray, dense), "cpu")
    params_t = tl.quantize_llama_params(dense_t, group_size=128, **kw)
    layer_t, layer_j = params_t["layers"][0], params_j["layers"][0]
    assert set(layer_t) == set(layer_j)
    assert ("wqkv" in layer_t) == kw.get("fuse", True)
    pairs = [(params_t["lm_head"], params_j["lm_head"])] + [
        (layer_t[k], layer_j[k]) for k in layer_t if k.startswith("w")]
    for qt, qj in pairs:
        assert qt.paired == bool(qj.paired) == (case.startswith("paired"))
        np.testing.assert_array_equal(qt.qweight.numpy(),
                                      np.asarray(qj.qweight))
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      np.asarray(qj.scales))
    if steps:
        before = dict(tqm.launches)
        _three_steps(params_j, params_t, cfg_j, tl.LlamaConfig(**SHAPE))
        assert dict(tqm.launches) == before     # no dequant route at 2 rows


def test_paired_prefill_and_generate_match_jax():
    """A paired-weight model (quantize_llama_params(paired=True), by the
    JAX package, bytes handed to the port) through llama_prefill (a
    40-token prompt of batch 2 into a bf16 cache: every matmul at 80 rows,
    which the card sends to qmm_slab_mma) and greedy_generate (a 12-token
    prompt, 4 tokens: decode steps at 2 rows, which the card sends to
    qmm_slab_norm_mma and qmm_slab_mma). The port runs qmm_slab_plain
    for every paired matmul, the JAX side its interpreted slab kernels
    (_kernel_group_norm_slab) for the fused wqkv and w_gateup and
    dequantize + matmul for the rest: logits within 3e-2 of max|logit|
    with equal argmax or a near-tie, caches as in test_prefill_matches_jax,
    greedy tokens equal."""
    cfg_j = jl.LlamaConfig(dtype=jnp.bfloat16, **SHAPE)
    params_j = jl.quantize_llama_params(
        jl.init_llama_params(cfg_j, jax.random.PRNGKey(5)), bits=4,
        group_size=128, paired=True)
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    cfg_t = tl.LlamaConfig(**SHAPE)
    assert params_t["lm_head"].paired and params_t["layers"][0]["wo"].paired
    cache_j, cache_t = _caches(cfg_j, cfg_t, 2, False)
    prompt = _prompt(2, 40, seed=11)
    with config.override(pallas_interpret=True):
        lj, cache_j = jl.llama_prefill(params_j, cfg_j, jnp.asarray(prompt),
                                       cache_j)
    before = dict(tqm.launches)
    lt, _ = tl.llama_prefill(params_t, cfg_t, torch.from_numpy(prompt),
                             cache_t)
    assert dict(tqm.launches) == before     # the slab route, not dequant
    _close_logits(lt, lj, ties=True)
    _close_caches(cache_t, cache_j)
    prompt = _prompt(2, 12, seed=12)
    with config.override(pallas_interpret=True):
        want, cache_j = jl.greedy_generate(params_j, cfg_j,
                                           jnp.asarray(prompt), 4)
    got, cache_t = tl.greedy_generate(params_t, cfg_t,
                                      torch.from_numpy(prompt), 4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close_caches(cache_t, cache_j)


def test_llama2_70b_config_matches_jax():
    got, want = tl.LlamaConfig.llama2_70b(), jl.LlamaConfig.llama2_70b()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "intermediate", "head_dim", "max_seq"):
        assert getattr(got, f) == getattr(want, f), f
    assert tl.LlamaConfig.llama2_70b(max_seq=64).max_seq == 64


# -- entry(): the JAX package's own entry configuration (group 64) ----------

def test_entry_config_decode_step_matches_jax():
    """The decode step of __graft_entry__.entry() (dim 512, 4 layers, INT4
    at group 64, INT8 KV, batch 2, pos 5) with its parameters carried
    across by models/convert.py. Variant map: JAX under
    pallas_interpret=True runs rmsnorm + its interpreted chunk kernel for
    wqkv and w_gateup (quant_matmul_norm's fallback: the group is no
    multiple of 128) and dequantize + matmul for wo, w_down and the lm_head
    (wo_matmul dispatches on is_tpu()); the port runs qmm_chunk_plain for
    wqkv, w_gateup, wo and the lm_head and the dequant route for w_down
    (its group snaps to 32, which does not divide its 688 packed rows, as
    in the JAX package). Logits within 3e-2 of max|logit| (one
    bf16 rounding of the scaled weight apart: f32 scale products on one
    side, bf16 ones on the other), argmax equal."""
    import __graft_entry__ as graft
    from infinitensor_tpu_torch import entry as tentry

    fn, (params_j, token, pos, cache_j) = graft.entry()
    with config.override(pallas_interpret=True):
        lj, _ = fn(params_j, token, pos, cache_j)
    cfg_j, cfg_t = graft._small_cfg(), tentry.small_config()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "intermediate", "max_seq", "head_dim"):
        assert getattr(cfg_t, f) == getattr(cfg_j, f), f
    params_t = params_from_jax_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
    layer = params_t["layers"][0]
    x = torch.zeros(1, cfg_t.dim, dtype=torch.bfloat16)
    for q in (layer["wqkv"], layer["wo"], layer["w_gateup"],
              params_t["lm_head"]):
        assert q.group_size == 64 and tqm.route(x, q)[0] == "qmm_chunk"
    xd = torch.zeros(1, cfg_t.intermediate, dtype=torch.bfloat16)
    assert tqm.route(xd, layer["w_down"])[0] == "dequant_matmul"
    cache_t = tl.init_kv_cache(cfg_t, 2, kv_quant=True, device="cpu")
    lt, _ = tl.llama_decode_step(params_t, cfg_t, torch.tensor(
        np.asarray(token)), torch.tensor(np.asarray(pos)), cache_t)
    assert lt.shape == (2, 2048)
    _close_logits(lt, lj)

    # the port's own entry(): same configuration, its own seeded weights
    fn_t, args = tentry.entry("cpu")
    assert fn_t is tl.llama_decode_step
    params, cfg, token_t, pos_t, cache = args
    assert cfg == cfg_t and token_t.tolist() == [0, 0]
    assert pos_t.tolist() == [5, 5] and cache["k"][0].dtype == torch.int8
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        got, want = params["layers"][0][key], layer[key]
        assert got.qweight.shape == want.qweight.shape
        assert (got.group_size, got.scales.shape) == (want.group_size,
                                                      want.scales.shape)
    logits, _ = fn_t(*args)
    assert logits.shape == (2, 2048) and torch.isfinite(logits.float()).all()


def test_w4a8_model_matches_jax_under_the_env_var(model, monkeypatch,
                                                  tmp_path):
    """INFINITPU_QMM_VARIANT=w4a8 with an empty tuning table, three
    INT8-cache decode steps. Variant map: JAX under pallas_interpret=True
    runs its interpreted _kernel_group_norm_w4a8 for wqkv and w_gateup and
    its interpreted W4A8 kernel for wo, w_down and the lm_head (wo_matmul
    takes quant_matmul on every shape under the env var); the port runs
    qmm_norm_w4a8_plain and qmm_w4a8_plain. Logits within 3e-2 of
    max|logit|, argmax equal up to a near-tie within the measured error."""
    cfg_j, params_j, _, cfg_t, params_t = model
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    monkeypatch.setenv("INFINITPU_QMM_TUNE", str(empty))
    monkeypatch.setenv("INFINITPU_QMM_VARIANT", "w4a8")
    x = torch.zeros(1, SHAPE["dim"], dtype=torch.bfloat16)
    for key in ("wo", "wqkv"):
        assert tqm.route(x, params_t["layers"][0][key])[0] == "qmm_w4a8"
    _three_steps(params_j, params_t, cfg_j, cfg_t)
