"""The port's BERT (models/bert.py, models/loader.py load_bert_params)
against the JAX package on the CPU.

bert_encode: BertConfig.tiny() (dim 64, 4 heads, 2 layers), f32, the same
parameters on both sides; hidden states within 1e-5 of max|h| (both in
f32, sums in another order), with and without an attention mask and token
types. load_bert_params: the JAX loader's tensors bit for bit from a
randomly initialised HF BertModel, and the port's encoder HF's hidden
states within 2e-3 (tests/test_bert.py::test_hf_parity's bound).

The graphs (build_bert_layer_graph, build_bert_graph) are built through
both GraphHandlers from the same numpy weights and run by both executors:
FP32 within 1e-5 of max|out|; dynamic INT8 (DynamicQuantizeLinear ->
MatMulInteger -> scales) within 1e-5 as well, since both sides round x /
scale to even in f32 and multiply exact int32 sums, so the codes agree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.models import bert as jbert
from infinitensor_tpu.models.loader import load_bert_params as jload_bert

from infinitensor_tpu_torch.models import bert as tbert
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.models.loader import load_bert_params
from infinitensor_tpu_torch.runtime.runtime import cpu_runtime

TOL = 1e-5
B, S = 2, 8


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    ref = float(np.abs(want).max())
    assert err <= tol * ref, (err, ref)


@pytest.fixture(scope="module")
def both():
    jcfg = jbert.BertConfig.tiny()
    jparams = jbert.init_bert_params(jcfg, jax.random.PRNGKey(0))
    return (jcfg, jparams, tbert.BertConfig.tiny(),
            params_from_jax_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("types", [False, True])
def test_bert_encode_against_jax(both, mask, types):
    jcfg, jparams, cfg, params = both
    rng = np.random.default_rng(int(mask) * 2 + int(types))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 5:] = 0
    tt = rng.integers(0, 2, (B, S)).astype(np.int32)
    want = jbert.bert_encode(
        jparams, jcfg, jnp.asarray(tokens),
        attn_mask=jnp.asarray(am) if mask else None,
        token_types=jnp.asarray(tt) if types else None)
    got = tbert.bert_encode(
        params, cfg, torch.from_numpy(tokens),
        attn_mask=torch.from_numpy(am) if mask else None,
        token_types=torch.from_numpy(tt) if types else None)
    assert got.dtype == torch.float32
    _close(got, want)


def test_load_bert_params_from_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_act="gelu", attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    sd = hf.state_dict()
    cfg = tbert.BertConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                           intermediate=128, max_seq=64)
    params = load_bert_params(sd, cfg, device="cpu")
    jparams = jload_bert(sd, jbert.BertConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, intermediate=128,
        max_seq=64))
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == 5 + 16 * cfg.n_layers
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    tokens = np.random.default_rng(0).integers(0, 128, (2, 12))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).last_hidden_state.numpy()
    got = tbert.bert_encode(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)


def _run_both(jh, th, feeds):
    want = list(jh.run(feeds, return_numpy=True).values())
    got = list(th.run(feeds, return_numpy=True).values())
    assert len(want) == len(got) == 1
    return got[0], want[0]


@pytest.mark.parametrize("dynamic_quant", [False, True])
def test_layer_graph_against_jax(both, dynamic_quant):
    jcfg, jparams, cfg, params = both
    jh = jbert.build_bert_layer_graph(jcfg, jparams["layers"][0], B, S,
                                      dynamic_quant=dynamic_quant)
    th = tbert.build_bert_layer_graph(cfg, params["layers"][0], B, S,
                                      dynamic_quant=dynamic_quant)
    th.runtime = cpu_runtime()
    assert [op.op_type for op in jh.graph.operators] == \
        [op.op_type for op in th.graph.operators]
    ops = {op.op_type for op in th.graph.operators}
    assert ("MatMulInteger" in ops) == dynamic_quant
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.dim)).astype(np.float32) * 0.5
    got, want = _run_both(jh, th, {"x": x})
    _close(got, want)


@pytest.mark.parametrize("dynamic_quant", [False, True])
def test_full_graph_against_jax_and_encode(both, dynamic_quant):
    jcfg, jparams, cfg, params = both
    jh = jbert.build_bert_graph(jcfg, jparams, B, S,
                                dynamic_quant=dynamic_quant)
    th = tbert.build_bert_graph(cfg, params, B, S,
                                dynamic_quant=dynamic_quant)
    th.runtime = cpu_runtime()
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    got, want = _run_both(jh, th, {"tokens": tokens})
    _close(got, want)
    enc = tbert.bert_encode(params, cfg, torch.from_numpy(tokens)).numpy()
    if dynamic_quant:   # the BASELINE config-2 gate (tools/bert_parity.py)
        assert np.abs(got - enc).mean() / np.sqrt((enc ** 2).mean()) < 0.05
    else:
        _close(got, enc, 1e-5)


def test_init_bert_params_shapes():
    cfg = tbert.BertConfig.tiny()
    p = tbert.init_bert_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert p["tok"].shape == (256, 64) and p["pos"].shape == (64, 64)
    assert p["layers"][1]["w_up"].shape == (64, 128)
    assert all(v.dtype == torch.float32 for v in p["layers"][0].values())


def test_scalar_weight_keeps_rank_zero():
    """A 0-d weight (the graphs' per-tensor scales) enters the executor as
    a 0-d tensor, so Mul of two scalars is a scalar, as the IR says (it
    entered as shape (1,) before)."""
    from infinitensor_tpu_torch.core.handler import GraphHandler
    h = GraphHandler(cpu_runtime())
    x = h.input((), name="x")
    h.mul(x, h.weight(np.float32(0.5).reshape(())))
    out = list(h.run({"x": np.float32(3.0)}, return_numpy=True).values())[0]
    assert out.shape == () and float(out) == 1.5
