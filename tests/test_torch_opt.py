"""The port's OPT model and MoE FFN against the JAX package on the CPU.

OPT (models/opt.py): OPTConfig.tiny() (dim 64, 4 heads of 16, 2 layers)
with the same parameters on both sides (the JAX init carried over with
params_from_jax_numpy). No kernel runs on either side at this width: the
matmuls take dequantize + matmul (wo_matmul below 512 input features), the
decode attention the plain reference. A prompt of 8 tokens at batch 2,
then 4 decode steps. Tolerances, of max|logit|: f32 1e-4; bf16 (float and
INT8 weights) 2e-2, where each side rounds the bf16 residual stream op by
op and a sum in another order moves an element by one bf16 ulp; the
argmax equal, or a near-tie within that bound.

MoE (models/moe.py): moe_ffn_ref and _routing_weights within 1e-5 of
max|out| (f32), including a router with two identical expert columns,
whose tied probabilities the threshold keeps both.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.models import moe as jmoe
from infinitensor_tpu.models import opt as jopt
from infinitensor_tpu.models.loader import load_opt_params as jload_opt

from infinitensor_tpu_torch.models import moe as tmoe
from infinitensor_tpu_torch.models import opt as topt
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.models.loader import load_opt_params

B, S, STEPS = 2, 8, 4
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8_g32": 2e-2, "int8_gnone": 2e-2}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    ref = float(np.max(np.abs(want)))
    assert err <= tol * ref, (err, ref)
    return err, ref


def _same_top1(got, want, tol):
    """Equal argmax per row, or a near-tie: the port's pick within
    tol * max|logit| of the JAX row's best."""
    got, want = _np(got).reshape(-1, got.shape[-1]), \
        _np(want).reshape(-1, want.shape[-1])
    ref = float(np.max(np.abs(want)))
    for g, w in zip(got, want):
        i = int(np.argmax(g))
        assert i == int(np.argmax(w)) or w.max() - w[i] <= tol * ref


def _jax_side(form):
    dtype = jnp.float32 if form == "f32" else jnp.bfloat16
    cfg = jopt.OPTConfig.tiny(dtype=dtype)
    params = jopt.init_opt_params(cfg, jax.random.PRNGKey(3), dtype=dtype)
    if form == "int8_g32":
        params = jopt.quantize_opt_params(params, bits=8, group_size=32)
    elif form == "int8_gnone":
        params = jopt.quantize_opt_params(params, bits=8, group_size=None)
    return cfg, params


def _port(jcfg, jparams):
    tdt = torch.float32 if jcfg.dtype == jnp.float32 else torch.bfloat16
    cfg = topt.OPTConfig.tiny(dtype=tdt)
    return cfg, params_from_jax_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("form", list(TOL))
def test_opt_prefill_and_decode_against_jax(form):
    jcfg, jparams = _jax_side(form)
    cfg, params = _port(jcfg, jparams)
    rng = np.random.default_rng(len(form))
    tokens = rng.integers(0, cfg.vocab_size, (B, S + STEPS))
    jcache = jopt.init_opt_cache(jcfg, B)
    want, jcache = jopt.opt_prefill(jparams, jcfg,
                                    jnp.asarray(tokens[:, :S], jnp.int32),
                                    jcache)
    cache = topt.init_opt_cache(cfg, B, device="cpu")
    got, cache = topt.opt_prefill(
        params, cfg, torch.from_numpy(tokens[:, :S]).int(), cache)
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    _close(got, want, TOL[form])
    _same_top1(got, want, TOL[form])
    for t in range(S, S + STEPS):
        # ragged positions: row 1 one step behind row 0
        pos = np.array([t, t - 1], np.int32)
        want, jcache = jopt.opt_decode_step(
            jparams, jcfg, jnp.asarray(tokens[:, t], jnp.int32),
            jnp.asarray(pos), jcache)
        got, cache = topt.opt_decode_step(
            params, cfg, torch.from_numpy(tokens[:, t]).int(),
            torch.from_numpy(pos), cache)
        _close(got, want, TOL[form])
        _same_top1(got, want, TOL[form])


def test_prefill_decode_agree():
    """Decode logits at t equal prefill logits at t (the JAX test's check,
    tests/test_opt.py::test_prefill_decode_agree, on the port alone)."""
    cfg = topt.OPTConfig.tiny(dtype=torch.float32)
    params = topt.init_opt_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))).int()
    full, _ = topt.opt_prefill(params, cfg, tokens,
                               topt.init_opt_cache(cfg, B, device="cpu"))
    cache = topt.init_opt_cache(cfg, B, device="cpu")
    l3, cache = topt.opt_prefill(params, cfg, tokens[:, :3], cache)
    _close(l3, full[:, :3], 1e-5)
    for t in range(3, S):
        lg, cache = topt.opt_decode_step(
            params, cfg, tokens[:, t], torch.full((B,), t, dtype=torch.int32),
            cache)
        _close(lg, full[:, t], 1e-4)


def test_prefill_zeroes_the_rows_past_the_prompt():
    """The cache after a prefill is zero past row S even where an earlier,
    longer prompt wrote rows there (the JAX prefill returns a fresh zero
    cache past S)."""
    cfg = topt.OPTConfig.tiny(dtype=torch.float32)
    params = topt.init_opt_params(
        cfg, torch.Generator().manual_seed(4), device="cpu")
    cache = topt.init_opt_cache(cfg, 1, device="cpu")
    long = torch.arange(20, dtype=torch.int32)[None]
    topt.opt_prefill(params, cfg, long, cache)
    assert all(float(k[:, :, 5:20].abs().max()) > 0 for k in cache["k"])
    _, cache = topt.opt_prefill(params, cfg, long[:, :5], cache)
    for key in ("k", "v"):
        for buf in cache[key]:
            assert float(buf[:, :, 5:].abs().max()) == 0.0
    fresh = topt.init_opt_cache(cfg, 1, device="cpu")
    _, fresh = topt.opt_prefill(params, cfg, long[:, :5], fresh)
    for a, b in zip(cache["k"] + cache["v"], fresh["k"] + fresh["v"]):
        assert torch.equal(a, b)


def test_quantized_opt_keeps_the_argmax():
    """INT8 weights at group 32 keep the float model's next token (the
    JAX test's check, tests/test_opt.py::test_quantized_opt)."""
    cfg = topt.OPTConfig.tiny(dtype=torch.float32)
    params = topt.init_opt_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")
    qp = topt.quantize_opt_params(params, bits=8, group_size=32)
    assert all(isinstance(lay[k], type(qp["layers"][0]["w_o"]))
               for lay in qp["layers"] for k in topt._QKEYS)
    tokens = torch.arange(8, dtype=torch.int32)[None]
    ref, _ = topt.opt_prefill(params, cfg, tokens,
                              topt.init_opt_cache(cfg, 1, device="cpu"))
    got, _ = topt.opt_prefill(qp, cfg, tokens,
                              topt.init_opt_cache(cfg, 1, device="cpu"))
    assert int(ref[0, -1].argmax()) == int(got[0, -1].argmax())


def test_load_opt_params_from_hf():
    """A randomly initialised HF OPTForCausalLM: the port's loader gives
    the JAX loader's tensors bit for bit, and the port's prefill HF's
    logits within 1e-3 (tests/test_opt.py::test_hf_parity's bound)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.OPTConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, ffn_dim=128, max_position_embeddings=64,
        do_layer_norm_before=True, attn_implementation="eager",
        word_embed_proj_dim=64)
    torch.manual_seed(0)
    hf = transformers.OPTForCausalLM(hf_cfg).eval()
    sd = hf.state_dict()
    cfg = topt.OPTConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                         ffn_dim=128, max_seq=64, dtype=torch.float32)
    params = load_opt_params(sd, cfg, device="cpu")
    jcfg = jopt.OPTConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                          ffn_dim=128, max_seq=64, dtype=jnp.float32)
    jparams = jload_opt(sd, jcfg, dtype=jnp.float32)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == 4 + 12 * cfg.n_layers
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    tokens = np.random.default_rng(0).integers(0, 128, (2, 10))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    got, _ = topt.opt_prefill(params, cfg, torch.from_numpy(tokens).int(),
                              topt.init_opt_cache(cfg, 2, device="cpu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def _moe_params(tie):
    p = jmoe.init_moe_params(jax.random.PRNGKey(7), 32, 48, 6)
    if tie:     # experts 2 and 4 route identically: every row ties
        r = np.asarray(p["router"]).copy()
        r[:, 4] = r[:, 2]
        p = dict(p, router=jnp.asarray(r))
    return p


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_moe_ffn_ref_against_jax(tie, top_k):
    jp = _moe_params(tie)
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(top_k).standard_normal((10, 32)).astype(
        np.float32)
    jw = jmoe._routing_weights(jp, jnp.asarray(x), top_k)
    tw = tmoe._routing_weights(tp, torch.from_numpy(x), top_k)
    _close(tw, jw, 1e-6)
    assert np.array_equal(_np(tw) > 0, np.asarray(jw) > 0)
    if tie and top_k == 2:
        # the tied pair is kept together wherever it reaches the top 2
        kept = _np(tw) > 0
        assert np.array_equal(kept[:, 2], kept[:, 4])
        assert (kept.sum(1) == 3).any()
    _close(tmoe.moe_ffn_ref(tp, torch.from_numpy(x), top_k),
           jmoe.moe_ffn_ref(jp, jnp.asarray(x), top_k), 1e-5)


def test_moe_ffn_ep_waits_for_the_parallelism_item():
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4,
                              device="cpu")
    assert tp["w_in"].shape == (4, 8, 16) and tp["w_out"].shape == (4, 16, 8)
    with pytest.raises(NotImplementedError, match="item 14"):
        tmoe.moe_ffn_ep(tp, torch.zeros(3, 8))
