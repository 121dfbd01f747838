"""The port's graph IR (core/*, ops/shape_rules.py, ops/lowering.py,
runtime/executor.py) against the JAX package's, on the CPU: the same
graph built through both GraphHandlers from the same seeded numpy
inputs, run through both GraphExecutors.

Tolerances: shapes and dtypes equal; f32 values within 1e-5 relative to
max|JAX| plus 1e-6 (both sides compute in f32, in another summation
order); 2e-3 for the convolution / resize / norm-of-window cases whose
sums are longer; exact for integer, bool and shape outputs. The kernels'
plain versions (rmsnorm, g2bmm, gbmm) against the JAX Pallas kernels run
in interpret mode: f32 within 1e-5, bf16 within one bf16 ulp at max|ref|
(4e-3 of it).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.core import dtype as jdt
from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.kernels import band as jband
from infinitensor_tpu.kernels import norms as jnorms
from infinitensor_tpu.ops import lowering as jlow
from infinitensor_tpu.runtime.executor import GraphExecutor as JExecutor
from infinitensor_tpu.utils.config import config as jconfig

from infinitensor_tpu_torch.core import dtype as tdt
from infinitensor_tpu_torch.core.handler import GraphHandler as THandler
from infinitensor_tpu_torch.kernels import band as tband
from infinitensor_tpu_torch.kernels import norms as tnorms
from infinitensor_tpu_torch.ops import lowering as tlow
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.runtime import Runtime, cpu_runtime
from infinitensor_tpu_torch.utils.config import config as tconfig

from torch_graph_cases import CASES, LOOSE_CASES, _in, _op, _w

F32 = 1e-5
LOOSE = 2e-3


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _both(build, seed=0, tol=F32):
    """Build through both handlers, run both executors on the same feeds,
    compare every graph tensor's shape and dtype and every output."""
    hj, ht = JHandler(), THandler()
    feeds_j = build(hj, np.random.default_rng(seed))
    feeds_t = build(ht, np.random.default_rng(seed))
    for h in (hj, ht):
        h.graph.infer_output_roles()
    assert [(t.shape, t.dtype.name) for t in hj.graph.tensors] == \
        [(t.shape, t.dtype.name) for t in ht.graph.tensors]
    want = JExecutor(hj.graph).run(feeds_j, return_numpy=True)
    got = GraphExecutor(ht.graph, device="cpu").run(feeds_t,
                                                    return_numpy=True)
    outs_j = [t.name for t in hj.graph.outputs()]
    outs_t = [t.name for t in ht.graph.outputs()]
    assert len(outs_j) == len(outs_t) > 0
    for nj, nt in zip(outs_j, outs_t):
        w, g = np.asarray(want[nj]), np.asarray(got[nt])
        assert g.shape == w.shape, (nt, g.shape, w.shape)
        assert g.dtype == w.dtype, (nt, g.dtype, w.dtype)
        if w.dtype.kind in "fc" or w.dtype.name == "bfloat16":
            w, g = _np(w).astype(np.float64), _np(g).astype(np.float64)
            fin = np.isfinite(w)
            assert (np.isfinite(g) == fin).all()
            scale = np.abs(w[fin]).max() if fin.any() else 0.0
            assert np.abs(g[fin] - w[fin]).max(initial=0.0) <= \
                tol * scale + 1e-6, nt
        else:
            np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_matches_jax(name):
    _both(CASES[name], tol=LOOSE if name in LOOSE_CASES else F32)


# -- shape rules: a sample of tests/test_shape_rules.py, built through ------
# -- both handlers (no run), every tensor's shape and dtype equal ----------

def _s(h, shape, dtype=None):
    return h.input(shape) if dtype is None else h.tensor(shape, dtype)


SHAPE_CASES = {
    "conv": lambda h, d: h.conv(_s(h, (1, 3, 224, 224)), h.weight(np.zeros(
        (64, 3, 7, 7), np.float32)), pads=(3, 3), strides=(2, 2)),
    "conv_grouped_dilated": lambda h, d: h.conv(
        _s(h, (1, 32, 56, 56)), h.weight(np.zeros((32, 1, 3, 3), np.float32)),
        pads=(2, 2), dilations=(2, 2), group=32),
    "conv_transpose": lambda h, d: h.conv_transpose(
        _s(h, (1, 16, 8, 8)), h.weight(np.zeros((16, 8, 2, 2), np.float32)),
        strides=(2, 2)),
    "matmul_broadcast": lambda h, d: h.matmul(_s(h, (3, 1, 5, 7)),
                                              _s(h, (4, 7, 2))),
    "pool_ceil": lambda h, d: h.max_pool(_s(h, (1, 1, 7, 7)), kernel=(2, 2),
                                         strides=(2, 2), ceil_mode=1),
    "compare_dtype": lambda h, d: h._add("Less", [_s(h, (2, 2)),
                                                  _s(h, (2, 2))], {}),
    "reshape_flatten_squeeze": lambda h, d: [
        h.reshape(_s(h, (2, 3, 4)), (-1, 4)), h.reshape(_s(h, (2, 3, 4)),
                                                        (0, -1)),
        h.flatten(_s(h, (2, 3, 4, 5)), axis=0),
        h.squeeze(_s(h, (1, 3, 1, 4))),
        h.unsqueeze(_s(h, (3, 4)), axes=[0, 3])],
    "concat_split": lambda h, d: h.split(
        h.concat([_s(h, (2, 3)), _s(h, (2, 5))], axis=1), axis=1,
        num_or_sizes=2),
    "slice_pad": lambda h, d: [
        h.slice(_s(h, (10, 20)), starts=[1, -5], ends=[9, 20], axes=[0, 1],
                steps=[2, 1]),
        h.pad(_s(h, (1, 3, 4, 4)), pads=[0, 0, 1, 1, 0, 0, 1, 1])],
    "gather_reduce": lambda h, d: [
        h.gather(_s(h, (5, 7)), _s(h, (3, 2), d.INT64), axis=1),
        h.reduce_sum(_s(h, (2, 3, 4)), axes=[1], keepdims=0),
        h.reduce_mean(_s(h, (2, 3, 4)))],
    "expand_where": lambda h, d: h.where(
        _s(h, (2, 3, 6), d.BOOL), h.expand(_s(h, (3, 1)), (2, 1, 6)),
        _s(h, (2, 3, 6))),
    "attention_rope_band": lambda h, d: [
        h.attention_kvcache(*(_s(h, s) for s in ((1, 8, 128, 64),) * 2
                              + ((1, 8, 1, 64),) * 3),
                            _s(h, (1,), d.INT32)),
        h.rope(_s(h, (1, 5), d.INT32), _s(h, (1, 5, 512)), dim_head=64),
        h.gbmm(h.g2bmm(_s(h, (8, 100, 64)), _s(h, (8, 100, 64)), width=10),
               _s(h, (8, 100, 64)))],
    "comm_ops": lambda h, d: [
        h.all_reduce_sum(_s(h, (4, 4))), h.all_gather(_s(h, (4, 4)), 4),
        h.recv(source=0, destination=1, shape=(2, 2), dtype=d.FLOAT32)],
    "quant_cast_d2s": lambda h, d: [
        h.dequantize_linear(h.quantize_linear(
            _s(h, (2, 8)), h.weight(np.float32(0.1).reshape(())),
            h.weight(np.zeros((), np.int8))),
            h.weight(np.float32(0.1).reshape(()))),
        h.cast(_s(h, (2, 2)), d.INT8),
        h.depth_to_space(_s(h, (1, 8, 2, 3)), 2)],
}


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_shape_rules_match_jax(name):
    hj, ht = JHandler(), THandler()
    SHAPE_CASES[name](hj, jdt)
    SHAPE_CASES[name](ht, tdt)
    assert [(t.shape, t.dtype.name) for t in ht.graph.tensors] == \
        [(t.shape, t.dtype.name) for t in hj.graph.tensors]
    assert len(ht.graph.operators) == len(hj.graph.operators)


def test_output_spec_mismatch_raises():
    h = THandler()
    x = h.input((2, 4))
    with pytest.raises(ValueError):
        h.relu(x, output=h.tensor((3, 3)))


# -- band ops: the gather and shift-scan paths, and the kernels' plain ------
# -- versions against the interpreted Pallas kernels -------------------------

def _band_graph(h, rng, m, k, w, d, dtype=np.float32):
    a, an = _in(h, rng, (2, m, k), "a", dtype)
    b, bn = _in(h, rng, (2, m, k), "b", dtype)
    band = h.g2bmm(a, b, width=w, dilation=d)
    h.gbmm(h.softmax(band, axis=-1), b, dilation=d)
    return {"a": an, "b": bn}


@pytest.mark.parametrize("path", ["gather", "scan"])
@pytest.mark.parametrize("d", [1, 2])
def test_band_lowering_paths_match_jax(path, d, monkeypatch):
    """G2BMM -> Softmax -> GBMM through both lowerings' gather path, and
    through the shift-scan path (the gather limit set to 0 on both sides),
    at dilation 1 and 2 (the dilated band never takes the kernels)."""
    if path == "scan":
        monkeypatch.setattr(jlow, "_BAND_GATHER_LIMIT", 0)
        monkeypatch.setattr(tlow, "_BAND_GATHER_LIMIT", 0)
    _both(lambda h, rng: _band_graph(h, rng, 24, 16, 3, d))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_band_plain_vs_interpreted_kernels(dtype):
    """g2bmm_band / gbmm_band (the plain versions, on the CPU) against
    the JAX Pallas kernels in interpret mode, in the form of the JAX
    package's test_band_kernels_interpret (w 6, m 64, k 128)."""
    rng = np.random.default_rng(3)
    w, m, k = 6, 64, 128
    a = jnp.asarray(rng.standard_normal((2, m, k)), dtype)
    b = jnp.asarray(rng.standard_normal((2, m, k)), dtype)
    wts = jnp.asarray(rng.standard_normal((2, m, 2 * w + 1)), dtype)
    with jconfig.override(pallas_interpret=True):
        want_s = jband.g2bmm_band(a, b, w, 1, interpret=True)
        want_o = jband.gbmm_band(wts, b, w, 1, interpret=True)
    t = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(  # noqa
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got_s = tband.g2bmm_band(t(a), t(b), w)
    got_o = tband.gbmm_band(t(wts), t(b), w)
    tol = F32 if dtype == jnp.float32 else 4e-3
    for got, want in ((got_s, want_s), (got_o, want_o)):
        want = np.asarray(want, np.float32)
        assert got.dtype == t(a).dtype and got.shape == want.shape
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), err
    tdt = t(a).dtype
    for op in ("g2bmm", "gbmm"):
        assert tband.band_kernels_usable(op, tdt, tdt, 2, m, k, w, 1)
        assert not tband.band_kernels_usable(op, tdt, tdt, 2, m, k, w, 2)
        # the dropped TPU predicates: k % 128, w <= 128, row blocks
        assert tband.band_kernels_usable(op, tdt, tdt, 2, 100, 64, 200, 1)
    assert not jband.band_kernels_usable(100, 64, 200, 1)


@pytest.mark.parametrize("rows", [8, 256, 1024])
def test_rmsnorm_plain_vs_interpreted_kernel(rows):
    rng = np.random.default_rng(rows)
    x = jnp.asarray(rng.standard_normal((rows, 512)) * 3.0, jnp.bfloat16)
    w = jnp.asarray(rng.uniform(0.5, 1.5, (512,)), jnp.float32)
    want = np.asarray(jnorms.rmsnorm(x, w, eps=1e-6, interpret=True),
                      np.float32)
    got = tnorms.rmsnorm(torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16), torch.from_numpy(np.asarray(w)))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 512)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 4e-3 * np.abs(want).max(), err
    np.testing.assert_array_equal(
        got.float().numpy(),
        tnorms.rmsnorm_plain(torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16), torch.from_numpy(np.asarray(w))).float().numpy())


def test_rmsnorm_any_row_count_and_f32():
    """Every row count takes the same function (the JAX gate below 8
    rows and off its 256-row block is a TPU rule)."""
    rng = np.random.default_rng(5)
    for rows in (1, 3, 13):
        x = rng.standard_normal((rows, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        got = tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
        want = np.asarray(jnorms.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w),
                                             1e-5))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="weight"):
        tnorms.rmsnorm(torch.zeros(2, 8), torch.zeros(7))


# -- the executor -----------------------------------------------------------

def _relu_graph():
    h = THandler(runtime=cpu_runtime())
    x = h.input((2, 4), name="x")
    h.relu(x)
    return h, x


def test_executable_cache_reuse():
    h, x = _relu_graph()
    ex = h.executor()
    a = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    out = ex.run({x.name: a}, return_numpy=True)
    np.testing.assert_array_equal(list(out.values())[0], np.maximum(a, 0))
    assert len(ex._cache) == 1
    ex.run({x.name: a + 1})
    assert len(ex._cache) == 1  # same signature -> same program


def test_executable_cache_lru_eviction():
    """Bounded LRU (reference CUDA-Graph capture cache semantics,
    include/cuda/cuda_runtime.h:66-128: LRU, capacity 16 by default)."""
    h, x = _relu_graph()
    ex = h.executor()
    assert ex.cache_capacity == 16
    ex.cache_capacity = 3

    def feed(n):
        return ex._materialize({x.name: np.zeros((2, n), np.float32)})

    sigs = []
    for i in range(5):
        ex._compiled(feed(4 + i))
        sigs.append(ex._signature(feed(4 + i)))
    assert len(ex._cache) == 3
    assert list(ex._cache) == sigs[2:]
    ex._compiled(feed(6))                    # hit sigs[2]: now most recent
    ex._compiled(feed(99))                   # new -> evicts sigs[3]
    assert sigs[2] in ex._cache and sigs[3] not in ex._cache


def test_cache_capacity_knob_and_mutation_clears():
    with tconfig.override(executable_cache_capacity=2):
        h, x = _relu_graph()
        ex = h.executor()
    assert ex.cache_capacity == 2
    ex.run({x.name: np.ones((2, 4), np.float32)})
    assert len(ex._cache) == 1
    h.change_shape(x, (3, 4))
    h.shape_infer()
    out = ex.run({x.name: -np.ones((3, 4), np.float32)}, return_numpy=True)
    assert list(out.values())[0].shape == (3, 4)
    assert len(ex._cache) == 1               # cleared, then the new one
    assert tconfig.snapshot()["executable_cache_capacity"]["env"] == \
        "INFINITPU_EXEC_CACHE"


def test_config_holds_the_knobs_the_port_reads():
    """The port's registry holds what its code reads (the executor's LRU
    capacity, the memory planner's two knobs, the log level), from the
    JAX package's env vars."""
    snap = tconfig.snapshot()
    assert set(snap) == {"executable_cache_capacity", "log_level",
                         "naive_allocator", "validate_memory"}
    for name, knob in snap.items():
        assert knob["env"] == jconfig.snapshot()[name]["env"]
    with tconfig.override(executable_cache_capacity=3):
        h = THandler()
        h.relu(h.input((2,), name="x"))
        h.graph.infer_output_roles()
        assert GraphExecutor(h.graph, device="cpu").cache_capacity == 3


def test_boundary_dtypes_follow_jax():
    """float64 / int64 feeds and constants enter as float32 / int32, as
    the JAX executor's _to_jax does."""
    for H, dtm in ((JHandler, jdt), (THandler, tdt)):
        h = H()
        x = h.input((3,), dtype=dtm.INT64, name="x")
        y = h.input((3,), dtype=dtm.FLOAT64, name="y")
        h.add(h.cast(x, dtm.FLOAT64), y)
    h.graph.infer_output_roles()
    got = GraphExecutor(h.graph, device="cpu").run(
        {"x": np.arange(3), "y": np.ones(3)}, return_numpy=True)
    (v,) = got.values()
    assert v.dtype == np.float32
    np.testing.assert_array_equal(v, [1, 2, 3])


def test_missing_input_and_placeholder_raise():
    h = THandler(runtime=cpu_runtime())
    x = h.input((2, 3), name="x")
    w = h.weight_placeholder((3, 2), tdt.FLOAT32, name="w")
    h.matmul(x, w)
    ex = h.executor()
    with pytest.raises(ValueError, match="missing graph input"):
        ex.run({})
    with pytest.raises(ValueError, match="placeholder"):
        ex.run({"x": np.ones((2, 3), np.float32)})
    ex.set_weight("w", torch.ones(3, 2))
    out = ex.run({"x": np.ones((2, 3), np.float32)}, return_numpy=True)
    np.testing.assert_array_equal(list(out.values())[0], np.full((2, 2), 3.0))
    with pytest.raises(KeyError):
        ex.set_weight("nope", torch.ones(1))


def test_time_ms_and_profile_on_the_cpu():
    h = THandler(runtime=cpu_runtime())
    x = h.input((32, 32), name="x")
    y = h.matmul(x, h.weight(np.eye(32, dtype=np.float32)))
    h.relu(y)
    ex = h.executor()
    assert ex.time_ms(iters=3) > 0.0
    rows = ex.profile()
    assert [r[1] for r in rows] == ["MatMul", "Relu"]
    assert all(r[2] > 0 for r in rows)
    assert h.get_perf_time() > 0.0


def test_runtime_handle():
    rt = cpu_runtime()
    assert rt.device.type == "cpu" and rt.is_cpu()
    h = THandler()
    x = h.input((2, 2), name="x")
    h.neg(x)
    h.graph.infer_output_roles()
    out = rt.run(h.graph, {"x": np.ones((2, 2), np.float32)},
                 return_numpy=True)
    np.testing.assert_array_equal(list(out.values())[0], -np.ones((2, 2)))
    with pytest.raises(NotImplementedError, match="item 14"):
        rt.init_comm("x", 2, 0)
    with pytest.raises(ValueError):
        Runtime("tpu").device


def test_unported_ops_raise_with_their_roadmap_item():
    for build, item in ((lambda h, x: h.all_reduce_sum(x), "item 14"),
                        (lambda h, x: h.broadcast(x), "item 14"),
                        (lambda h, x: h.send(x, 0, 1), "item 14")):
        h = THandler(runtime=cpu_runtime())
        x = h.input((2, 2), name="x")
        build(h, x)
        with pytest.raises(NotImplementedError, match=item):
            h.run({"x": np.ones((2, 2), np.float32)})
    # the optimizer is ported: optimize() rewrites the graph
    h = THandler(runtime=cpu_runtime())
    h.relu(h.identity(h.input((2, 2), name="x")))
    h.graph.infer_output_roles()
    h.optimize()
    assert [op.op_type for op in h.graph.operators] == ["Relu"]


def test_lowering_registry_matches_jax():
    assert set(tlow.LOWERINGS) == set(jlow.LOWERINGS)


@pytest.mark.parametrize("op_type", ["RandomNormal", "RandomUniform",
                                     "RandomNormalLike", "RandomUniformLike",
                                     "Bernoulli"])
def test_random_ops_shape_dtype_moments(op_type):
    """Random bits differ from JAX's threefry bits: hold shape, dtype,
    moments, and the same draw on every call (a static key in JAX)."""
    h = THandler(runtime=cpu_runtime())
    x = h.input((64, 64), name="x")
    attrs = {"seed": 7, "shape": [64, 64], "dtype": 1}
    if op_type.startswith("RandomNormal"):
        attrs.update(mean=1.0, scale=2.0)
    if op_type.startswith("RandomUniform"):
        attrs.update(low=-1.0, high=3.0)
    ins = [] if op_type in ("RandomNormal", "RandomUniform") else [x]
    _op(h, op_type, ins, attrs)
    feed = {"x": np.full((64, 64), 0.25, np.float32)}
    (a,) = h.run(feed, return_numpy=True).values()
    (b,) = h.run(feed, return_numpy=True).values()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (64, 64) and a.dtype == np.float32
    mean, std = float(a.mean()), float(a.std())
    want = {"RandomNormal": (1.0, 2.0), "RandomNormalLike": (1.0, 2.0),
            "RandomUniform": (1.0, 4 / math.sqrt(12)),
            "RandomUniformLike": (1.0, 4 / math.sqrt(12)),
            "Bernoulli": (0.25, math.sqrt(0.25 * 0.75))}[op_type]
    assert abs(mean - want[0]) < 0.1 and abs(std - want[1]) < 0.1


def test_dtype_table():
    assert tdt.BFLOAT16.torch() == torch.bfloat16
    assert tdt.INT64.torch() == torch.int64
    assert tdt.DataType.from_torch(torch.float16) == tdt.FLOAT16
    for d in (tdt.INT4, tdt.UINT4):
        with pytest.raises(TypeError):
            d.torch()


def test_native_topo_sort_on_a_large_graph():
    """Graphs of 64 ops or more sort through the native scheduler binding
    (native/graph_core.py; Python fallback where the library is missing),
    in an order the executor can run."""
    from infinitensor_tpu_torch.native import graph_core
    h = THandler(runtime=cpu_runtime())
    x = h.input((4,), name="x")
    y = x
    for _ in range(70):
        y = h.add(y, h.weight(np.ones(4, np.float32)))
    h.graph.operators.reverse()
    h.graph._sorted = False
    assert h.topo_sort()
    if graph_core.native_available():
        assert graph_core.topo_sort(h.graph) is not None
    (out,) = h.run({"x": np.zeros(4, np.float32)},
                   return_numpy=True).values()
    np.testing.assert_array_equal(out, np.full(4, 70.0))
