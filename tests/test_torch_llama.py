"""Three decode steps of a small INT4 + INT8-KV Llama in the port against
the JAX package's llama_decode_step, on the same weights.

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
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.models import llama as jl
from infinitensor_tpu.utils.config import config

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


def test_decode_steps_match_jax(model):
    cfg_j, params_j, cache_j, cfg_t, params_t = model
    cache_t = tl.init_kv_cache(cfg_t, 2, device="cpu")
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
        err = np.max(np.abs(lt - lj))
        assert err <= 3e-2 * np.max(np.abs(lj)), (step, err)
        np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
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
    cache = tl.init_kv_cache(cfg_t, 2, device="cpu")
    toks, last, pos, cache = tl.llama_decode_multi(params_t, cfg_t, tok0,
                                                   pos0, cache, 4)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    ref_cache = tl.init_kv_cache(cfg_t, 2, device="cpu")
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
