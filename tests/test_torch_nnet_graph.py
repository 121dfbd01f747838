"""The port's nnet/* graph half (nmutator.py, the MemBound lowering, the
search with NMutator) on the CPU, against the JAX package's on the same
graphs, built from the same numpy arrays in both.

* A MemBound op (a matmul, a conv with its relu merged in, an unpadded
  access out of range at both ends, a conv evaluated in chunks) runs
  through the port's GraphExecutor within 1e-5 of max|JAX| (f32) of the
  JAX executor's run of the same graph.
* NMutator().run gives the JAX package's mutants op for op (types,
  attributes, shapes) on a 1x1, a padded 3x3 and a strided, dilated conv,
  and each mutant's output is within 1e-5 of max|JAX| of the JAX mutant's
  and within 1e-4 of max|base| (the derivator's oracle bound) of the
  conv graph's.
* SearchEngine(mutator=NMutator()) with both packages' engines loaded
  from one PerfEngine file (so neither times anything) picks the JAX
  package's graph op for op; an unseeded CPU search scores its MemBound
  candidates like any op and returns a graph equal in output to its
  input.

MemBound keys hold their comprehension's repr, whose var names come from
a module-global counter (a reference quirk both packages keep): every
build and search starts from reset counters (test_torch_nnet.py).
"""

import numpy as np
import pytest

from infinitensor_tpu.core import dtype as jdt
from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.nnet import derivation as jderiv
from infinitensor_tpu.nnet import evaluator as jeval
from infinitensor_tpu.nnet import expr as jexpr
from infinitensor_tpu.nnet.nmutator import NMutator as JNMutator
from infinitensor_tpu.optimizer.search import SearchEngine as JSearch
from infinitensor_tpu.runtime import executor as jexecutor
from infinitensor_tpu.runtime.perf import PerfEngine as JPerf

from infinitensor_tpu_torch.core import dtype as tdt
from infinitensor_tpu_torch.core.handler import GraphHandler as THandler
from infinitensor_tpu_torch.nnet import derivation as tderiv
from infinitensor_tpu_torch.nnet import evaluator as teval
from infinitensor_tpu_torch.nnet import expr as texpr
from infinitensor_tpu_torch.nnet.nmutator import NMutator
from infinitensor_tpu_torch.optimizer.search import SearchEngine
from infinitensor_tpu_torch.runtime import executor as texecutor
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.perf import PerfEngine

from test_torch_nnet import jax_eval_program, reset_counters

TOL = 1e-5
ORACLE = 1e-4

JAX = dict(GH=JHandler, deriv=jderiv, dt=jdt, expr=jexpr)
PORT = dict(GH=THandler, deriv=tderiv, dt=tdt, expr=texpr)


@pytest.fixture(autouse=True)
def jitted_jax_oracle(monkeypatch):
    """The JAX derivator's oracle jitted, as test_torch_nnet.py runs it."""
    monkeypatch.setattr(jeval, "evaluate_program", jax_eval_program)


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


def _op_for_op(g):
    return [(op.op_type, sorted((k, repr(v)) for k, v in op.attrs.items()),
             [None if t is None else (t.shape, t.dtype.name)
              for t in op.inputs],
             [(t.shape, t.dtype.name) for t in op.outputs])
            for op in g.operators]


# -- MemBound through both executors ----------------------------------------

def _w(h, shape, name):
    return h.weight(np.random.default_rng(2).standard_normal(
        shape).astype(np.float32), name=name)


def _mb_matmul(m, h, x):
    """tests/test_optimizer.py's MemBound matmul on named inputs."""
    return [x, _w(h, (6, 5), "B")], m["deriv"].matmul_expr(
        4, 6, 5, a_name="x", b_name="B")


def _mb_conv(m, h, x, fn=None):
    comp = m["deriv"].conv_expr(1, 2, 7, 9, 3, 3, 3, pad=2, stride=2,
                                dilation=2)
    if fn:
        comp = m["deriv"].merge_elementwise(comp, comp, fn)
    return [x, _w(h, (3, 2, 3, 3), "W")], comp


def _mb_out_of_range(m, h, x):
    """Unpadded reads past both ends and at negative indices (JAX wraps
    a negative index once, then clamps)."""
    E = m["expr"]
    i, j = E.fresh_var("i"), E.fresh_var("j")
    X = E.TensorRef("X", (5, 4))
    return [x], E.Comprehension([(i, 9), (j, 7)], [],
                                X[i * 2 - 8, j - 3] + X[-1, j + 9] * X[i, -6])


MEMBOUND = {"matmul": ((4, 6), _mb_matmul),
            "conv": ((1, 2, 7, 9), _mb_conv),
            "conv_relu_in_sum": ((1, 2, 7, 9),
                                 lambda m, h, x: _mb_conv(m, h, x, "relu")),
            "out_of_range": ((5, 4), _mb_out_of_range)}


def _membound_graph(m, name):
    x_shape, make = MEMBOUND[name]
    reset_counters()
    h = m["GH"]()
    x = h.input(x_shape, name="x")
    ins, comp = make(m, h, x)
    h._add("MemBound", ins, {"expr": comp,
                             "out_specs": [(comp.shape, m["dt"].FLOAT32)]})
    h.graph.infer_output_roles()
    return h.graph


@pytest.mark.parametrize("name", sorted(MEMBOUND))
def test_membound_matches_jax_executor(name):
    jg, tg = _membound_graph(JAX, name), _membound_graph(PORT, name)
    assert _op_for_op(tg) == _op_for_op(jg)
    feeds = _feeds(jg)
    _close(_port_run(tg, feeds), _jax_run(jg, feeds))


def test_membound_in_chunks_matches_jax_executor(monkeypatch):
    """The same conv with the element budget cut to 64: evaluated in
    chunks along its loop vars, it gives the JAX executor's values."""
    jg, tg = _membound_graph(JAX, "conv"), _membound_graph(PORT, "conv")
    feeds = _feeds(jg)
    want = _jax_run(jg, feeds)
    calls = []
    block = teval._block
    monkeypatch.setattr(teval, "ELEMENT_BUDGET", 64)
    monkeypatch.setattr(teval, "_block",
                        lambda *a: calls.append(a[3]) or block(*a))
    _close(_port_run(tg, feeds), want)
    # one chunk an (n, f, oh), ow in steps of 64 // 18 (the sum grid)
    assert len(calls) == 1 * 3 * 4 * 2


# -- NMutator ----------------------------------------------------------------

def conv_graph(GH, x_shape, w_shape, relu=False, **attrs):
    rng = np.random.default_rng(3)
    h = GH()
    x = h.input(x_shape, name="x")
    w = h.weight(rng.standard_normal(w_shape).astype(np.float32))
    c = h.conv(x, w, **attrs)
    if relu:
        h.relu(c)
    h.graph.infer_output_roles()
    return h.graph


CONVS = {"conv1x1": ((2, 6, 5, 5), (8, 6, 1, 1), {}),
         "conv3x3_p1": ((1, 3, 6, 6), (4, 3, 3, 3), dict(pads=(1, 1))),
         "conv_s2_d2": ((1, 3, 10, 10), (4, 3, 3, 3),
                        dict(pads=(1, 1), strides=(2, 2), dilations=(2, 2)))}


def _mutants(GH, mutator, case):
    x_shape, w_shape, attrs = CONVS[case]
    g = conv_graph(GH, x_shape, w_shape, **attrs)
    reset_counters()
    return g, mutator.run(g)


@pytest.mark.parametrize("case", sorted(CONVS))
def test_nmutator_mutants_match_jax(case):
    jg, jmuts = _mutants(JHandler, JNMutator(), case)
    tg, tmuts = _mutants(THandler, NMutator(device="cpu"), case)
    assert [_op_for_op(m) for m in tmuts] == [_op_for_op(m) for m in jmuts]
    # the im2col form of tests/test_derivation_search.py:119-140
    assert any({"MatMul", "MemBound"} <= {op.op_type for op in m.operators}
               for m in tmuts)
    feeds = _feeds(jg)
    base = _jax_run(jg, feeds)
    for jm, tm in zip(jmuts, tmuts):
        got = _port_run(tm, feeds)
        _close(got, _jax_run(jm, feeds))
        _close(got, base, tol=ORACLE)


# -- the search --------------------------------------------------------------

SEARCHED = {"conv1x1_relu": ((1, 4, 4, 4), (4, 4, 1, 1), {}),
            "conv3x3_s2_relu": ((1, 3, 9, 9), (4, 3, 3, 3),
                                dict(pads=(1, 1), strides=(2, 2)))}


def _searched(GH, case):
    x_shape, w_shape, attrs = SEARCHED[case]
    return conv_graph(GH, x_shape, w_shape, relu=True, **attrs)


@pytest.mark.parametrize("case", sorted(SEARCHED))
def test_search_with_nmutator_matches_jax_from_one_perf_file(
        case, tmp_path, monkeypatch):
    # the JAX search times every candidate op once and saves the engine
    monkeypatch.setattr(JPerf, "_instance", None)
    filled = JPerf.instance()
    reset_counters()
    JSearch(mutator=JNMutator()).run(_searched(JHandler, case))
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
    jg, tg = _searched(JHandler, case), _searched(THandler, case)
    reset_counters()
    jwin = JSearch(mutator=JNMutator(), perf=jpe).run(jg)
    reset_counters()
    search = SearchEngine(mutator=NMutator(device="cpu"), perf=tpe,
                          device="cpu")
    twin = search.run(tg)
    assert timed == [] and len(tpe) == n == len(jpe)
    assert _op_for_op(twin) == _op_for_op(jwin)
    assert any("MemBound" in h["ops"] for h in search.history)
    feeds = _feeds(jg)
    _close(_port_run(twin, feeds), _jax_run(jwin, feeds))


def test_unseeded_cpu_search_scores_membound():
    """A search that times on the CPU scores every MemBound candidate with
    a finite cost and returns a graph equal in output to its input."""
    g = _searched(THandler, "conv3x3_s2_relu")
    feeds = _feeds(g)
    want = _port_run(g, feeds)
    search = SearchEngine(mutator=NMutator(device="cpu"), perf=PerfEngine(),
                          device="cpu")
    got = search.run(g)
    mb = [h for h in search.history if "MemBound" in h["ops"]]
    assert mb and all(h["cost_ms"] < float("inf") for h in mb)
    _close(_port_run(got, feeds), want, tol=ORACLE)
