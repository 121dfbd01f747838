"""The port's graph optimizer (optimizer/rewrite.py, graph_match.py,
mutator.py, merge.py, search.py) on the CPU, against the JAX package's
on the same graphs, built from the same numpy arrays in both.

* optimize_graph at levels 1 and 2 gives the JAX package's op-type
  sequence, and outputs within 1e-5 of max|out| (f32) of the JAX graph's.
* Each mutator rule gives the JAX rule's op types; the band rule's graph
  (bz 2, S 128, D 64, w 16) matches the JAX executor's run of the JAX
  rule's graph within 1e-5 of max|out| in f32, and in bf16 (where the
  port's edge mask is bf16, the JAX rule's f32) both stay within 4e-2 of
  max|f64 dense attention|, the band bound of chip_smoke.py phase 13.
* search_merge gives the same number of variants with the same op types.
* SearchEngine.run with both packages' engines loaded from one PerfEngine
  file (so neither times anything) picks the same graph op for op, with
  outputs within 1e-5 of the JAX winner's; an unseeded CPU search returns
  a graph equal in output to its input.
* GraphHandler.optimize and OnnxStub.optimize / tune run; MemBound
  computes through nnet/evaluator.py (tests/test_torch_nnet_graph.py
  holds it and NMutator's search against the JAX package's).
"""

import os
import sys

import numpy as np
import pytest
import torch

from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.optimizer import merge as jmerge
from infinitensor_tpu.optimizer import rewrite as jrewrite
from infinitensor_tpu.optimizer.mutator import RuleBasedMutator as JMutator
from infinitensor_tpu.optimizer.search import SearchEngine as JSearch
from infinitensor_tpu.runtime import executor as jexecutor
from infinitensor_tpu.runtime.perf import PerfEngine as JPerf

from infinitensor_tpu_torch.core import dtype as tdt
from infinitensor_tpu_torch.core.handler import GraphHandler as THandler
from infinitensor_tpu_torch.onnx.exporter import export_onnx
from infinitensor_tpu_torch.onnx.importer import OnnxStub
from infinitensor_tpu_torch.optimizer import merge as tmerge
from infinitensor_tpu_torch.optimizer import optimize_graph
from infinitensor_tpu_torch.optimizer.graph_match import SubGraphRewriter
from infinitensor_tpu_torch.optimizer.mutator import RuleBasedMutator
from infinitensor_tpu_torch.optimizer.search import SearchEngine
from infinitensor_tpu_torch.runtime import executor as texecutor
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.perf import PerfEngine
from infinitensor_tpu_torch.runtime.runtime import cpu_runtime
from infinitensor_tpu_torch.utils.errors import Refused

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

TOL = 1e-5
BAND = dict(bz=2, S=128, D=64, w=16)


# -- the graphs, built by either package's GraphHandler ----------------------

def qkv_graph(GH, layers=2, batch=4, dim=64):
    """tools/rewrite_speedup.py build_graph (per layer q, k, v = x @ W,
    relu(q + k + v) @ transpose(Wo), identity) as chip_smoke.py phase 19
    builds it, by either package's GraphHandler."""
    return chip_smoke.qkv_graph(np, GH, lambda: None, layers, batch, dim)


def conv_bias_graph(GH):
    rng = np.random.default_rng(1)
    h = GH(name="conv_bias")
    x = h.input((1, 3, 8, 8), name="x")
    w = h.weight(rng.standard_normal((4, 3, 3, 3), dtype=np.float32))
    c = h.conv(x, w, pads=(1, 1))
    bias = h.weight(rng.standard_normal((1, 4, 1, 1), dtype=np.float32))
    h.add(c, bias)
    h.graph.infer_output_roles()
    return h.graph


def conv_act_graph(GH):
    rng = np.random.default_rng(2)
    h = GH(name="conv_act")
    x = h.input((1, 3, 8, 8), name="x")
    w = h.weight(rng.standard_normal((4, 3, 3, 3), dtype=np.float32))
    h.relu(h.conv(x, w, pads=(1, 1)))
    h.graph.infer_output_roles()
    return h.graph


def conv_bias_act_graph(GH):
    rng = np.random.default_rng(3)
    h = GH(name="conv_bias_act")
    x = h.input((1, 3, 8, 8), name="x")
    w = h.weight(rng.standard_normal((4, 3, 3, 3), dtype=np.float32))
    c = h.conv(x, w, pads=(1, 1))
    bias = h.weight(rng.standard_normal((4,), dtype=np.float32))
    h.relu(h.add(c, h.reshape(bias, (1, 4, 1, 1))))
    h.graph.infer_output_roles()
    return h.graph


def transpose_graph(GH):
    rng = np.random.default_rng(4)
    h = GH(name="transpose")
    x = h.input((4, 6), name="x")
    w = h.weight(rng.standard_normal((4, 5), dtype=np.float32))
    h.matmul(h.transpose(x, perm=[1, 0]), w)
    h.graph.infer_output_roles()
    return h.graph


def conv_relu_matmul_graph(GH):
    """tests/test_optimizer.py test_search_engine_preserves_numerics."""
    rng = np.random.default_rng(5)
    h = GH(name="search")
    x = h.input((1, 8, 6, 6), name="x")
    w1 = h.weight(rng.standard_normal((8, 8, 1, 1), dtype=np.float32))
    r = h.relu(h.conv(x, w1))
    w2 = h.weight(rng.standard_normal((288, 10), dtype=np.float32))
    h.matmul(h.flatten(r, axis=1), w2)
    h.graph.infer_output_roles()
    return h.graph


def conv3x3_graph(GH):
    rng = np.random.default_rng(6)
    h = GH(name="im2col")
    x = h.input((1, 4, 6, 6), name="x")
    w = h.weight(rng.standard_normal((8, 4, 3, 3), dtype=np.float32))
    h.conv(x, w, pads=(1, 1))
    h.graph.infer_output_roles()
    return h.graph


def siblings_graph(GH):
    rng = np.random.default_rng(7)
    h = GH(name="siblings")
    x = h.input((4, 8), name="x")
    for n in (6, 10):
        h.matmul(x, h.weight(rng.standard_normal((8, n), dtype=np.float32)))
    h.graph.infer_output_roles()
    return h.graph


def band_graph(GH, dtype="float32"):
    """Standard-op Longformer band attention (tests/test_optimizer.py
    test_band_attention_to_g2bmm_rewrite), in f32 or bf16 (inputs and
    mask)."""
    bz, S, D, w = BAND["bz"], BAND["S"], BAND["D"], BAND["w"]
    i, j = np.indices((S, S))
    mask = np.where(np.abs(i - j) <= w, np.float32(0), np.float32(-1e9))
    h = GH(name="band_attn")
    q, k, v = (h.input((bz, S, D), dtype=dtype, name=n) for n in "qkv")
    if dtype == "bfloat16":
        import ml_dtypes
        mask = mask.astype(ml_dtypes.bfloat16)
    m = h.weight(mask, name="band_mask")
    scores = h.matmul(q, h.transpose(k, perm=[0, 2, 1]))
    h.matmul(h.softmax(h.add(scores, m), axis=-1), v)
    h.graph.infer_output_roles()
    return h.graph


GRAPHS = {"qkv": qkv_graph, "conv_bias": conv_bias_graph,
          "conv_act": conv_act_graph, "conv_bias_act": conv_bias_act_graph,
          "transpose": transpose_graph,
          "conv_relu_matmul": conv_relu_matmul_graph}


# -- helpers -----------------------------------------------------------------

def _feeds(g, seed=1):
    rng = np.random.default_rng(seed)
    return {t.name: rng.standard_normal(t.shape).astype(np.float32)
            for t in g.inputs()}


def _jax_run(g, feeds):
    out = jexecutor.GraphExecutor(g).run(feeds, return_numpy=True)
    return [np.asarray(out[t.name], np.float64) for t in g.outputs()]


def _port_run(g, feeds):
    out = GraphExecutor(g, device="cpu").run(feeds, return_numpy=True)
    return [np.asarray(out[t.name], np.float64) for t in g.outputs()]


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        top = np.max(np.abs(b))
        assert np.max(np.abs(a - b)) <= tol * top, (np.max(np.abs(a - b)),
                                                    top)


def _types(g):
    return [op.op_type for op in g.operators]


def _attrs(a):
    return sorted((k, repr(v)) for k, v in a.items())


def _op_for_op(g):
    return [(op.op_type, _attrs(op.attrs),
             [None if t is None else (t.shape, t.dtype.name)
              for t in op.inputs],
             [(t.shape, t.dtype.name) for t in op.outputs])
            for op in g.operators]


# ---------------------------------------------------------------------------
# rewrites
# ---------------------------------------------------------------------------

def test_qkv_graph_is_the_tool_graph():
    """Phase 19's qkv workload is the tool's graph, op for op."""
    from tools.rewrite_speedup import build_graph
    assert _op_for_op(qkv_graph(JHandler)) == _op_for_op(
        build_graph(layers=2, batch=4, dim=64))


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_optimize_graph_matches_jax(case, level):
    jg, tg = GRAPHS[case](JHandler), GRAPHS[case](THandler)
    feeds = _feeds(jg)
    before = _jax_run(jg, feeds)
    jrewrite.optimize_graph(jg, level=level)
    assert optimize_graph(tg, level=level) is tg
    assert _op_for_op(tg) == _op_for_op(jg)
    want = _jax_run(jg, feeds)
    _close(_port_run(tg, feeds), want)
    _close(want, before)


def test_fold_constants_bf16_matches_jax():
    """A Concat of two bf16 weights folds to one bf16 weight through the
    CPU lowering, bit for bit the JAX package's fold."""
    import ml_dtypes
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal((8, n)).astype(ml_dtypes.bfloat16)
            for n in (3, 5))
    graphs = []
    for GH in (JHandler, THandler):
        h = GH(name="fold")
        x = h.input((4, 8), dtype="bfloat16", name="x")
        w = h.concat([h.weight(a, name="a"), h.weight(b, name="b")], axis=1)
        h.matmul(x, w)
        h.graph.infer_output_roles()
        graphs.append(h.graph)
    jg, tg = graphs
    jrewrite.optimize_graph(jg, level=2)
    optimize_graph(tg, level=2)
    assert _types(tg) == _types(jg) == ["MatMul"]
    jw, tw = (g.operators[0].inputs[1] for g in (jg, tg))
    assert tw.numpy().dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(tw.numpy().view(np.uint16),
                                  np.asarray(jw.numpy()).view(np.uint16))


def test_subgraph_rewriter():
    """tests/test_optimizer.py test_subgraph_match_and_replace on the
    port: Relu -> Neg replaced by Neg -> Clip(max 0)."""
    from infinitensor_tpu_torch.core.operator import Operator
    from infinitensor_tpu_torch.core.tensor import TensorObj
    h = THandler(runtime=cpu_runtime())
    h.neg(h.relu(h.input((3, 3), name="x")))
    h.graph.infer_output_roles()
    ph = THandler()
    px = ph.input((3, 3))
    pn = ph.neg(ph.relu(px))
    rw = SubGraphRewriter(h.graph)
    matches = rw.find_matches(ph.graph)
    assert len(matches) == 1

    def build(g, xin):
        negd = TensorObj((3, 3), tdt.FLOAT32)
        g.add_tensor(negd)
        g.add_op(Operator("Neg", [xin], [negd], {}))
        out = TensorObj((3, 3), tdt.FLOAT32)
        g.add_tensor(out)
        g.add_op(Operator("Clip", [negd], [out], {"max": 0.0}))
        return out

    x = np.random.default_rng(9).standard_normal((3, 3), dtype=np.float32)
    before = h.run({"x": x}, return_numpy=True)
    rw.replace(matches[0], ph.graph, build, [px], [pn])
    assert _types(h.graph) == ["Neg", "Clip"]
    after = h.run({"x": x}, return_numpy=True)
    np.testing.assert_allclose(list(after.values())[0],
                               list(before.values())[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# mutator rules
# ---------------------------------------------------------------------------

RULE_GRAPHS = {"conv1x1_to_matmul": conv_relu_matmul_graph,
               "conv_to_im2col_matmul": conv3x3_graph,
               "merge_parallel_matmuls": siblings_graph,
               "fold_transpose": transpose_graph,
               "band_attention_to_g2bmm": band_graph}


@pytest.mark.parametrize("rule", RuleBasedMutator.RULES)
def test_mutator_rule_matches_jax(rule):
    assert RuleBasedMutator.RULES == JMutator.RULES
    make = RULE_GRAPHS[rule]
    jg, tg = make(JHandler), make(THandler)
    assert getattr(JMutator(), rule)(jg)
    assert getattr(RuleBasedMutator(), rule)(tg)
    jg.topo_sort()
    tg.topo_sort()
    assert _op_for_op(tg) == _op_for_op(jg)
    feeds = _feeds(jg)
    _close(_port_run(tg, feeds), _jax_run(jg, feeds))
    # run() tries every rule on a clone, as the JAX mutator does
    assert [_types(g) for g in RuleBasedMutator().run(make(THandler))] == \
        [_types(g) for g in JMutator().run(make(JHandler))]


def _dense_f64(feeds):
    q, k, v = (np.asarray(feeds[n], np.float64) for n in "qkv")
    S, w = BAND["S"], BAND["w"]
    i, j = np.indices((S, S))
    sc = np.where(np.abs(i - j) <= w, q @ k.transpose(0, 2, 1), -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def test_band_rule_bf16_keeps_the_ir_dtype():
    """The band rule on a bf16 block: the edge mask is bf16, every op's
    lowering gives its IR dtype (so GBMM gets a bf16 pair, the ring
    form's), and both packages' band graphs stay within 4e-2 of
    max|f64 dense|."""
    import ml_dtypes
    from infinitensor_tpu_torch.ops.lowering import LowerCtx, lower_op
    jg, tg = band_graph(JHandler, "bfloat16"), band_graph(THandler,
                                                          "bfloat16")
    assert JMutator().band_attention_to_g2bmm(jg)
    assert RuleBasedMutator().band_attention_to_g2bmm(tg)
    jg.topo_sort()
    tg.topo_sort()
    # the K transpose stays behind, unused, as in the JAX rule
    assert _types(tg) == _types(jg) == ["G2BMM", "Add", "Softmax", "GBMM",
                                        "Transpose"]
    mask = tg.operators[1].inputs[1]
    assert mask.dtype == tdt.BFLOAT16 and \
        mask.numpy().dtype == ml_dtypes.bfloat16
    feeds = {n: v.astype(ml_dtypes.bfloat16)
             for n, v in _feeds(tg, seed=2).items()}
    ex = GraphExecutor(tg, device="cpu")
    env = {t.guid: texecutor.to_device(feeds[t.name], t, ex.device)
           for t in tg.inputs()}
    env.update({t.guid: texecutor.to_device(t.numpy(), t, ex.device)
                for t in tg.weights()})
    for op in tg.operators:
        outs = lower_op(op, [env[t.guid] for t in op.inputs], LowerCtx())
        for t, v in zip(op.outputs, outs):
            assert v.dtype == torch.bfloat16, (op.op_type, v.dtype)
            env[t.guid] = v
    ref = _dense_f64(feeds)
    top = np.max(np.abs(ref))
    for got in (_port_run(tg, feeds)[0], _jax_run(jg, feeds)[0]):
        assert np.max(np.abs(got - ref)) <= 4e-2 * top


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def test_search_merge_matches_jax():
    for make in (qkv_graph, siblings_graph):
        jg, tg = make(JHandler), make(THandler)
        jrewrite.optimize_graph(jg, level=2)
        optimize_graph(tg, level=2)
        jv, tv = jmerge.search_merge(jg), tmerge.search_merge(tg)
        assert len(tv) == len(jv) > 0
        assert [_op_for_op(g) for g in tv] == [_op_for_op(g) for g in jv]
        assert [(k, len(n)) for k, n in tmerge.find_merge_groups(tg)] == \
            [(k, len(n)) for k, n in jmerge.find_merge_groups(jg)]
    # qkv, 2 layers: all groups, each alone, 3 + 3 sub-groupings
    assert len(tmerge.search_merge(optimize_graph(qkv_graph(THandler),
                                                  level=2))) == 9


SEARCH_GRAPHS = {"qkv": lambda GH: jrewrite.optimize_graph(
                     qkv_graph(GH), level=2) if GH is JHandler
                 else optimize_graph(qkv_graph(GH), level=2),
                 "conv_relu_matmul": conv_relu_matmul_graph,
                 "band": band_graph}


@pytest.mark.parametrize("case", sorted(SEARCH_GRAPHS))
def test_search_engine_matches_jax_from_one_perf_file(case, tmp_path,
                                                      monkeypatch):
    make = SEARCH_GRAPHS[case]
    # the JAX search times every candidate op once and saves the engine
    # (into a new singleton: the JAX engine takes an empty PerfEngine
    # argument, which is falsy, for None)
    monkeypatch.setattr(JPerf, "_instance", None)
    filled = JPerf.instance()
    JSearch().run(make(JHandler))
    path = str(tmp_path / "perf.json")
    filled.save(path)
    jpe, tpe = JPerf(), PerfEngine()
    jpe.load(path)
    tpe.load(path)
    n = len(tpe)
    timed = []
    monkeypatch.setattr(jexecutor.GraphExecutor, "profile",
                        lambda self, *a, **k: timed.append("jax"))
    monkeypatch.setattr(texecutor.GraphExecutor, "profile",
                        lambda self, *a, **k: timed.append("port"))
    jg, tg = make(JHandler), make(THandler)
    jwin = JSearch(perf=jpe).run(jg)
    search = SearchEngine(perf=tpe, device="cpu")
    twin = search.run(tg)
    assert timed == [] and len(tpe) == n == len(jpe)
    assert _op_for_op(twin) == _op_for_op(jwin)
    feeds = _feeds(jg)
    _close(_port_run(twin, feeds), _jax_run(jwin, feeds))
    assert search.history and all(
        h["cost_ms"] < float("inf") for h in search.history)


@pytest.mark.parametrize("case", ["qkv", "band"])
def test_unseeded_cpu_search_preserves_outputs(case):
    g = SEARCH_GRAPHS[case](THandler)
    feeds = _feeds(g)
    want = _port_run(g, feeds)
    pe = PerfEngine()
    got = SearchEngine(perf=pe, device="cpu").run(g)
    assert len(pe) > 0
    _close(_port_run(got, feeds), want)


def test_search_lets_a_kernel_failure_through(monkeypatch):
    """A candidate whose profiling raises RuntimeError (a kernel that
    fails to build or launch) or ValueError (a wrapper's shape check)
    stops the search; one the lowering refuses (Refused) scores inf and
    the others win."""
    for error in (RuntimeError, ValueError):
        def fail(self, *a, error=error, **k):
            raise error("band_ring launch failed")

        monkeypatch.setattr(texecutor.GraphExecutor, "profile", fail)
        with pytest.raises(error, match="launch failed"):
            SearchEngine(perf=PerfEngine(), device="cpu").run(
                band_graph(THandler))

    def refuse(self, *a, **k):
        raise Refused("no lowering")

    monkeypatch.setattr(texecutor.GraphExecutor, "profile", refuse)
    g = band_graph(THandler)
    search = SearchEngine(perf=PerfEngine(), device="cpu")
    assert _types(search.run(g)) == _types(g)
    assert all(h["cost_ms"] == float("inf") for h in search.history)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_handler_and_stub_optimize_and_tune():
    jg = qkv_graph(JHandler)
    h = THandler(runtime=cpu_runtime())
    h.graph = qkv_graph(THandler)
    feeds = _feeds(jg)
    want = _jax_run(jg, feeds)
    h.optimize(level=2)
    jrewrite.optimize_graph(jg, level=2)
    assert _types(h.graph) == _types(jg)
    _close([np.asarray(v, np.float64) for v in
            h.run(feeds, return_numpy=True).values()], want)
    stub = OnnxStub(export_onnx(band_graph(THandler), "band").serialize(),
                    cpu_runtime())
    stub.optimize()
    stub.tune()
    g = stub.handler.graph
    assert all(PerfEngine.instance().get(op.workload_key()) is not None
               for op in g.operators)
    _close([np.asarray(v, np.float64) for v in
            stub.run(_feeds(g), return_numpy=True).values()],
           _port_run(band_graph(THandler), _feeds(g)))


def test_lowering_refusals_are_refused():
    """The op types and attributes the lowering does not offer raise
    Refused, the one error the search scores inf."""
    from infinitensor_tpu_torch.core.operator import Operator
    from infinitensor_tpu_torch.core.tensor import TensorObj
    from infinitensor_tpu_torch.ops.lowering import lower_op
    x = torch.ones(2, 2)
    for op_type, attrs in (("NoSuchOp", {}), ("AllReduceSum", {}),
                           ("Pad", {"pads": [0, 1, 0, 1], "mode": "wrap"})):
        op = Operator(op_type, [TensorObj((2, 2), tdt.FLOAT32)],
                      [TensorObj((2, 2), tdt.FLOAT32)], attrs)
        with pytest.raises(Refused):
            lower_op(op, [x])


def test_membound_still_raises():
    """MemBound, which raised until nnet/* was ported, now computes: the
    op this test built, with an expression attached (out = relu(2 x^T)),
    runs through the handler and gives the numpy value."""
    from infinitensor_tpu_torch.core.operator import Operator
    from infinitensor_tpu_torch.core.tensor import TensorObj
    from infinitensor_tpu_torch.nnet.expr import (
        Comprehension, Func, TensorRef, fresh_var)
    i, j = fresh_var("i"), fresh_var("j")
    X = TensorRef("X", (2, 3))
    expr = Comprehension([(i, 3), (j, 2)], [], Func("relu", X[j, i] * 2.0))
    h = THandler(runtime=cpu_runtime())
    x = h.input((2, 3), name="x")
    out = TensorObj((3, 2), tdt.FLOAT32)
    h.graph.add_tensor(out)
    h.graph.add_op(Operator("MemBound", [x], [out], {"expr": expr}))
    h.graph.infer_output_roles()
    x_np = np.random.default_rng(0).standard_normal((2, 3)).astype(
        np.float32)
    got = list(h.run({"x": x_np}, return_numpy=True).values())[0]
    np.testing.assert_array_equal(got, np.maximum(2.0 * x_np.T, 0.0))
