"""The port's ONNX frontend (onnx/wire.py, proto.py, exporter.py,
importer.py; native/onnx_wire.py; utils/convert.py, data.py, dataio.py)
on the CPU, alone and against the JAX package's.

* The codec and importer checks of tests/test_onnx.py and
  tests/test_native_onnx.py, run on the port's copies (the graphs on the
  port's CPU executor): round trips within 1e-4, hand-built models, the
  native initializer scan against the pure-Python parse (same messages,
  same arrays), the scan's descriptors equal to the JAX package's.
* export_onnx writes the JAX package's bytes for every case of the graph
  corpus (tests/torch_graph_cases.py), once both graphs carry the same
  names (automatic names come from a per-process counter).
* Bytes exported by either package, imported by the other and run:
  within tests/test_torch_graph.py's bounds (1e-5 of max|out| plus 1e-6;
  2e-3 for its loose cases) of the other package's import of the same
  bytes, and of the direct graph where the JAX package's own round trip
  reproduces it.
* utils: the bf16 / f16 converters, DataGenerator and the tensor dump
  files equal the JAX package's bit for bit.
* OnnxStub.tune profiles every op into PerfEngine.instance().
"""

import numpy as np
import pytest
import torch

from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.native import onnx_wire as jwire
from infinitensor_tpu.onnx import proto as jproto
from infinitensor_tpu.onnx.exporter import export_onnx as jexport
from infinitensor_tpu.onnx.importer import OnnxStub as JStub
from infinitensor_tpu.utils import convert as jconvert
from infinitensor_tpu.utils import data as jdata
from infinitensor_tpu.utils import dataio as jdataio

from infinitensor_tpu_torch.core.handler import GraphHandler
from infinitensor_tpu_torch.native import onnx_wire
from infinitensor_tpu_torch.onnx import proto
from infinitensor_tpu_torch.onnx.exporter import export_onnx
from infinitensor_tpu_torch.onnx.importer import OnnxStub
from infinitensor_tpu_torch.runtime.runtime import cpu_runtime
from infinitensor_tpu_torch.utils import convert, data, dataio

from torch_graph_cases import CASES, LOOSE_CASES

F32, LOOSE = 1e-5, 2e-3


def _h():
    return GraphHandler(cpu_runtime())


def _stub(model, **kw):
    return OnnxStub(model, cpu_runtime(), **kw)


# ---------------------------------------------------------------------------
# proto codec (tests/test_onnx.py)
# ---------------------------------------------------------------------------

def test_varint_roundtrip():
    from infinitensor_tpu_torch.onnx import wire
    for v in [0, 1, 127, 128, 300, 2**31, 2**60, -1, -64]:
        buf = wire.encode_varint(v)
        dec, pos = wire.decode_varint(buf, 0)
        assert wire.to_signed64(dec) == v
        assert pos == len(buf)


def test_tensorproto_numpy_roundtrip(rng):
    for arr in [
        rng.standard_normal((3, 4)).astype(np.float32),
        rng.integers(-5, 5, (2, 2)).astype(np.int64),
        rng.integers(0, 2, (4,)).astype(np.bool_),
        np.float16(rng.standard_normal((2, 3))),
    ]:
        tp = proto.TensorProto.from_numpy(arr, "t")
        assert tp.serialize() == jproto.TensorProto.from_numpy(
            arr, "t").serialize()
        tp2 = proto.TensorProto.parse(tp.serialize())
        np.testing.assert_array_equal(tp2.to_numpy(), arr)


def test_model_roundtrip_bytes(rng):
    h = _h()
    x = h.input((2, 4), name="x")
    w = h.weight(rng.standard_normal((4, 8), dtype=np.float32), name="w")
    h.relu(h.matmul(x, w))
    h.graph.infer_output_roles()
    m = export_onnx(h.graph, "tiny")
    m2 = proto.load_model(m.serialize())
    assert m2.graph.name == "tiny"
    assert [n.op_type for n in m2.graph.node] == ["MatMul", "Relu"]
    assert m2.graph.initializer[0].name == "w"


def _reimport_and_compare(h, feeds, rtol=1e-4):
    """Export -> parse -> import -> run; compare against direct execution."""
    h.graph.infer_output_roles()
    ref = h.run(feeds, return_numpy=True)
    stub = _stub(export_onnx(h.graph).serialize())
    got = stub.run(feeds, return_numpy=True)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=1e-4)
    return stub


def _mlp(h, rng):
    x = h.input((2, 16), name="x")
    y = h.add(h.matmul(x, h.weight(rng.standard_normal((16, 32),
                                                       dtype=np.float32))),
              h.weight(rng.standard_normal((32,), dtype=np.float32)))
    h.softmax(h.matmul(h.gelu(y), h.weight(rng.standard_normal(
        (32, 8), dtype=np.float32))), axis=-1)
    return {"x": rng.standard_normal((2, 16), dtype=np.float32)}


def _convnet(h, rng):
    x = h.input((1, 3, 16, 16), name="x")
    c1 = h.conv(x, h.weight(rng.standard_normal((8, 3, 3, 3),
                                                dtype=np.float32)),
                pads=(1, 1), strides=(2, 2))
    p = h.max_pool(h.relu(c1), kernel=(2, 2), strides=(2, 2))
    h.matmul(h.flatten(p, axis=1),
             h.weight(rng.standard_normal((8 * 16, 10), dtype=np.float32)))
    return {"x": rng.standard_normal((1, 3, 16, 16), dtype=np.float32)}


def _shape_ops(h, rng):
    x = h.input((2, 3, 8), name="x")
    s = h.slice(h.transpose(x, perm=[0, 2, 1]), starts=[0], ends=[4],
                axes=[1])
    sq = h.unsqueeze(s, axes=[0])
    h.reduce_mean(h.concat([sq, sq], axis=0), axes=[3], keepdims=0)
    return {"x": rng.standard_normal((2, 3, 8), dtype=np.float32)}


def _llm_ops(h, rng):
    B, H, S, D = 1, 2, 16, 8
    ts = [h.input(s, name=n) for n, s in (
        ("kc", (B, H, S, D)), ("vc", (B, H, S, D)), ("q", (B, H, 1, D)),
        ("k", (B, H, 1, D)), ("v", (B, H, 1, D)))]
    h.attention_kvcache(*ts, h.weight(np.array([3], np.int32), name="pos"))
    return {t.name: rng.standard_normal(t.shape, dtype=np.float32)
            for t in ts}


def _rmsnorm_rope(h, rng):
    x = h.input((1, 4, 128), name="x")
    pos = h.weight(np.arange(4, dtype=np.int32).reshape(1, 4), name="p")
    r = h.rope(pos, x, dim_head=64)
    h.rms_norm(r, h.weight(rng.standard_normal(128, dtype=np.float32)))
    return {"x": rng.standard_normal((1, 4, 128), dtype=np.float32)}


ROUND_TRIPS = {"mlp": _mlp, "convnet": _convnet, "shape_ops": _shape_ops,
               "llm_ops": _llm_ops, "rmsnorm_rope": _rmsnorm_rope}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_roundtrip(name, rng):
    h = _h()
    _reimport_and_compare(h, ROUND_TRIPS[name](h, rng))


def _mk_model(nodes, inputs, outputs, inits=None, opset=17):
    g = proto.GraphProto(name="t", node=nodes, input=inputs, output=outputs,
                         initializer=inits or [])
    m = proto.ModelProto(graph=g)
    m.opset_import = [proto.OperatorSetId(domain="", version=opset)]
    return m


def test_import_gemm_bias(rng):
    a_np = rng.standard_normal((3, 4), dtype=np.float32)
    w_np = rng.standard_normal((5, 4), dtype=np.float32)
    b_np = rng.standard_normal((5,), dtype=np.float32)
    m = _mk_model(
        nodes=[proto.NodeProto(
            input=["a", "w", "b"], output=["y"], op_type="Gemm",
            attribute=[proto.AttributeProto.make("transB", 1),
                       proto.AttributeProto.make("alpha", 1.0)])],
        inputs=[proto.ValueInfoProto.make("a", 1, (3, 4))],
        outputs=[proto.ValueInfoProto.make("y", 1, (3, 5))],
        inits=[proto.TensorProto.from_numpy(w_np, "w"),
               proto.TensorProto.from_numpy(b_np, "b")])
    out = _stub(m.serialize()).run({"a": a_np}, return_numpy=True)["y"]
    np.testing.assert_allclose(out, a_np @ w_np.T + b_np, rtol=1e-4,
                               atol=1e-5)


def test_import_constant_folding_shape_chain(rng):
    x_np = rng.standard_normal((2, 6, 4), dtype=np.float32)
    nodes = [
        proto.NodeProto(input=["x"], output=["shp"], op_type="Shape"),
        proto.NodeProto(input=["shp", "i0"], output=["d0"], op_type="Gather",
                        attribute=[proto.AttributeProto.make("axis", 0)]),
        proto.NodeProto(input=["d0"], output=["d0u"], op_type="Unsqueeze",
                        attribute=[proto.AttributeProto.make("axes", [0])]),
        proto.NodeProto(input=["d0u", "minus1"], output=["tgt"],
                        op_type="Concat",
                        attribute=[proto.AttributeProto.make("axis", 0)]),
        proto.NodeProto(input=["x", "tgt"], output=["y"], op_type="Reshape"),
    ]
    m = _mk_model(
        nodes, inputs=[proto.ValueInfoProto.make("x", 1, (2, 6, 4))],
        outputs=[proto.ValueInfoProto.make("y", 1, (2, 24))],
        inits=[proto.TensorProto.from_numpy(np.asarray(0, np.int64), "i0"),
               proto.TensorProto.from_numpy(np.asarray([-1], np.int64),
                                            "minus1")])
    stub = _stub(m.serialize())
    assert [op.op_type for op in stub.handler.graph.operators] == ["Reshape"]
    out = stub.run({"x": x_np}, return_numpy=True)["y"]
    np.testing.assert_array_equal(out, x_np.reshape(2, 24))


def test_import_clip_opset11_inputs(rng):
    x_np = rng.standard_normal((4,), dtype=np.float32)
    m = _mk_model(
        nodes=[proto.NodeProto(input=["x", "lo", "hi"], output=["y"],
                               op_type="Clip")],
        inputs=[proto.ValueInfoProto.make("x", 1, (4,))],
        outputs=[proto.ValueInfoProto.make("y", 1, (4,))],
        inits=[proto.TensorProto.from_numpy(np.asarray(-0.5, np.float32),
                                            "lo"),
               proto.TensorProto.from_numpy(np.asarray(0.5, np.float32),
                                            "hi")])
    out = _stub(m.serialize()).run({"x": x_np}, return_numpy=True)["y"]
    np.testing.assert_allclose(out, np.clip(x_np, -0.5, 0.5))


def test_import_dynamic_batch_default_dim():
    m = _mk_model(
        nodes=[proto.NodeProto(input=["x"], output=["y"], op_type="Relu")],
        inputs=[proto.ValueInfoProto(
            name="x", tensor_type=proto.TypeProtoTensor(
                1, proto.TensorShapeProto(dim=[
                    proto.Dimension(dim_param="batch"),
                    proto.Dimension(dim_value=4)])))],
        outputs=[proto.ValueInfoProto.make("y", 1, (1, 4))])
    stub = _stub(m.serialize(), fixed_dims={"x": 8})
    assert stub.inputs["x"].shape == (8, 4)
    stub.set_input({"x": (2, 4)})
    out = stub.run({"x": np.ones((2, 4), np.float32)}, return_numpy=True)
    assert out["y"].shape == (2, 4)


def test_import_unsupported_op_raises():
    m = _mk_model(
        nodes=[proto.NodeProto(input=["x"], output=["y"],
                               op_type="StringNormalizer")],
        inputs=[proto.ValueInfoProto.make("x", 1, (1,))],
        outputs=[proto.ValueInfoProto.make("y", 1, (1,))])
    with pytest.raises(NotImplementedError, match="StringNormalizer"):
        _stub(m.serialize())


def test_import_cycle_diagnostics():
    m = _mk_model(
        nodes=[proto.NodeProto(input=["b"], output=["a"], op_type="Relu",
                               name="n1"),
               proto.NodeProto(input=["a"], output=["b"], op_type="Relu",
                               name="n2")],
        inputs=[], outputs=[proto.ValueInfoProto.make("b", 1, (1,))])
    with pytest.raises(ValueError, match="stuck nodes"):
        _stub(m.serialize())


def test_stub_surface():
    """tune records a time for every op in PerfEngine.instance();
    clone_KV / free_heap act on the port's slot cache in place; to_onnx
    exports the stub's graph."""
    from infinitensor_tpu_torch.runtime.perf import PerfEngine
    h = _h()
    feeds = _mlp(h, np.random.default_rng(0))
    h.graph.infer_output_roles()
    stub = _stub(export_onnx(h.graph).serialize())
    stub.tune()
    for op in stub.handler.graph.operators:
        assert PerfEngine.instance().get(op.workload_key()) >= 0.0
    cache = {"k": [torch.arange(12.0).reshape(3, 4)],
             "v": [torch.ones(3, 4)]}
    stub.clone_KV(cache, 0, 2)
    assert torch.equal(cache["k"][0][2], cache["k"][0][0])
    stub.free_heap(cache, 1)
    assert float(cache["k"][0][1].abs().max()) == 0.0
    got = _stub(stub.to_onnx().serialize()).run(feeds, return_numpy=True)
    want = stub.run(feeds, return_numpy=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# native scan vs the Python parse (tests/test_native_onnx.py)
# ---------------------------------------------------------------------------

def _model_with_inits(inits):
    g = proto.GraphProto(name="g", initializer=inits)
    g.input = [proto.ValueInfoProto.make("x", 1, (2, 3))]
    g.output = [proto.ValueInfoProto.make("y", 1, (2, 3))]
    g.node = [proto.NodeProto(input=["x"], output=["y"], op_type="Relu")]
    return proto.ModelProto(graph=g)


def _payload_variants():
    return [
        proto.TensorProto.from_numpy(
            np.arange(24, dtype=np.float32).reshape(2, 3, 4), "raw_f32"),
        proto.TensorProto.from_numpy(
            np.arange(6, dtype=np.int8).reshape(2, 3), "raw_i8"),
        proto.TensorProto.from_numpy(np.arange(4, dtype=np.float16),
                                     "raw_f16"),
        proto.TensorProto(dims=[3], data_type=1, name="f32_list",
                          float_data=[1.0, -2.5, 3.25]),
        proto.TensorProto(dims=[4], data_type=7, name="i64_list",
                          int64_data=[-1, 2, -300, 4000]),
        proto.TensorProto(dims=[2], data_type=11, name="f64_list",
                          double_data=[1.5, -0.25]),
        proto.TensorProto(dims=[3], data_type=6, name="i32_list",
                          int32_data=[-7, 8, 9]),
        proto.TensorProto(dims=[0], data_type=1, name="empty"),
    ]


def test_native_scan_matches_the_jax_packages():
    """The port's binding loads the library of the repo's native/ source
    and indexes every initializer as the JAX package's binding does."""
    assert onnx_wire.native_available()
    assert onnx_wire._SRC == jwire._SRC
    data = _model_with_inits(_payload_variants()).serialize()
    scan, jscan = onnx_wire.scan_model(data), jwire.scan_model(data)
    assert (scan.graph_off, scan.graph_len) == (jscan.graph_off,
                                                jscan.graph_len)
    assert [vars(d) for d in scan.initializers] == \
        [vars(d) for d in jscan.initializers]
    by_name = {d.name: d for d in scan.initializers}
    assert [d.name for d in scan.initializers] == \
        [t.name for t in _payload_variants()]
    assert by_name["raw_f32"].data_kind == onnx_wire.KIND_RAW
    assert tuple(by_name["raw_f32"].dims) == (2, 3, 4)
    assert by_name["f32_list"].data_kind == onnx_wire.KIND_FLOAT
    assert by_name["i64_list"].data_kind == onnx_wire.KIND_INT64


def test_lazy_load_matches_python_parse():
    data = _model_with_inits(_payload_variants()).serialize()
    fast = proto.load_model(data)
    slow = proto.ModelProto.parse(data)
    assert isinstance(fast.graph.initializer[0], proto.LazyTensorProto)
    assert fast.ir_version == slow.ir_version
    assert fast.opset_version() == slow.opset_version()
    assert [n.op_type for n in fast.graph.node] == \
        [n.op_type for n in slow.graph.node]
    for lt, st in zip(fast.graph.initializer, slow.graph.initializer):
        assert (lt.name, lt.dims, lt.data_type) == \
            (st.name, st.dims, st.data_type)
        np.testing.assert_array_equal(np.asarray(lt.to_numpy()),
                                      np.asarray(st.to_numpy()))
    # the lazy model serializes to the bytes it was read from
    assert fast.serialize() == data


def test_lazy_raw_is_zero_copy():
    arr = np.arange(1024, dtype=np.float32)
    data = _model_with_inits([proto.TensorProto.from_numpy(arr, "w")]
                             ).serialize()
    out = proto.load_model(data).graph.initializer[0].to_numpy()
    assert not out.flags.writeable  # view into the model buffer
    np.testing.assert_array_equal(out, arr)


def test_importer_runs_on_lazy_model(tmp_path):
    w = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    g = proto.GraphProto(name="mm", initializer=[
        proto.TensorProto.from_numpy(w, "w")])
    g.input = [proto.ValueInfoProto.make("x", 1, (2, 8))]
    g.output = [proto.ValueInfoProto.make("y", 1, (2, 4))]
    g.node = [proto.NodeProto(input=["x", "w"], output=["y"],
                              op_type="MatMul")]
    path = tmp_path / "m.onnx"
    proto.save_model(proto.ModelProto(graph=g), str(path))
    stub = _stub(str(path))
    assert isinstance(stub.model.graph.initializer[0], proto.LazyTensorProto)
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)
    out = stub.run({"x": x}, return_numpy=True)
    np.testing.assert_allclose(out["y"], x @ w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the graph corpus: the same bytes, and each package's bytes run by the other
# ---------------------------------------------------------------------------

def _canonical(h):
    """Names that do not depend on the process's counters: automatic
    tensor names by position, every op name by position."""
    for i, t in enumerate(h.graph.tensors):
        if t.name == f"t{t.guid}":
            t.name = f"v{i}"
    for i, op in enumerate(h.graph.operators):
        op.name = f"{op.op_type}_n{i}"
    h.graph.infer_output_roles()
    return h


def _built(name, handler):
    h = handler()
    feeds = CASES[name](h, np.random.default_rng(0))
    return _canonical(h), feeds


@pytest.mark.parametrize("name", sorted(CASES))
def test_export_writes_the_jax_packages_bytes(name):
    hj, _ = _built(name, JHandler)
    ht, _ = _built(name, GraphHandler)
    assert export_onnx(ht.graph, name).serialize() == \
        jexport(hj.graph, name).serialize()


def _compare(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            fin = np.isfinite(w)
            assert (np.isfinite(g) == fin).all()
            scale = np.abs(w[fin]).max(initial=0.0)
            assert np.abs(g[fin].astype(np.float64) - w[fin]).max(
                initial=0.0) <= tol * scale + 1e-6, k
        else:
            np.testing.assert_array_equal(g, w)


def _outcome(fn):
    """fn()'s outputs, or the exception it raised."""
    try:
        return fn()
    except Exception as e:      # the reference's own refusal, compared
        return e


@pytest.mark.parametrize("name", sorted(CASES))
def test_cross_import(name):
    """JAX-exported bytes imported and run by the port, and port-exported
    bytes by the JAX package, each against the other package's import of
    the same bytes; and against the exporting package's direct graph
    wherever the JAX package's own round trip reproduces it. It does not
    for matmul (its importer drops a transposed MatMul's transA / transB:
    both packages refuse the bytes with the same error), gather_reduce
    (the same) and straggler (its importer drops Det's mode attribute:
    both packages compute the same other value)."""
    tol = LOOSE if name in LOOSE_CASES else F32
    hj, feeds = _built(name, JHandler)
    ht, _ = _built(name, GraphHandler)
    ht.runtime = cpu_runtime()
    jbytes = jexport(hj.graph, name).serialize()
    tbytes = export_onnx(ht.graph, name).serialize()
    j_of_j = _outcome(lambda: JStub(jbytes).run(feeds, return_numpy=True))
    t_of_j = _outcome(lambda: _stub(jbytes).run(feeds, return_numpy=True))
    j_of_t = _outcome(lambda: JStub(tbytes).run(feeds, return_numpy=True))
    t_of_t = _outcome(lambda: _stub(tbytes).run(feeds, return_numpy=True))
    if isinstance(j_of_j, Exception):
        assert name in ("matmul", "gather_reduce")
        for got in (t_of_j, j_of_t, t_of_t):
            assert type(got) is type(j_of_j) and str(got) == str(j_of_j)
        return
    _compare(t_of_j, j_of_j, tol)
    _compare(j_of_t, t_of_t, tol)
    if name != "straggler":
        _compare(j_of_j, hj.run(feeds, return_numpy=True), tol)
        _compare(t_of_t, ht.run(feeds, return_numpy=True), tol)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_convert_matches_the_jax_packages():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32) \
        * 100
    x[:4] = [0.0, -0.0, np.inf, 1e-40]
    for f in ("float_to_fp16", "float_to_bf16"):
        bits = getattr(convert, f)(x)
        assert np.array_equal(bits, getattr(jconvert, f)(x))
    b16 = convert.float_to_bf16(x)
    assert np.array_equal(convert.bf16_to_float(b16),
                          jconvert.bf16_to_float(b16))
    h16 = convert.float_to_fp16(x)
    assert np.array_equal(convert.fp16_to_float(h16),
                          jconvert.fp16_to_float(h16), equal_nan=True)


def test_convert_without_ml_dtypes(monkeypatch):
    """The bit-surgery path (ml_dtypes absent) rounds to nearest even as
    ml_dtypes does."""
    x = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    want = convert.float_to_bf16(x)
    monkeypatch.setattr(convert, "_BF16", None)
    assert np.array_equal(convert.float_to_bf16(x), want)
    assert np.array_equal(convert.bf16_to_float(want),
                          jconvert.bf16_to_float(want))


def test_data_generator_and_metrics_match():
    g, jg = data.DataGenerator(7), jdata.DataGenerator(7)
    for shape, dtype in (((3, 4), np.float32), ((5,), np.int8),
                         ((2, 2), np.int32)):
        assert np.array_equal(g.random(shape, dtype), jg.random(shape, dtype))
    assert np.array_equal(g.incremental((2, 3)), jg.incremental((2, 3)))
    assert np.array_equal(g.one_hot((2, 3), 4), jg.one_hot((2, 3), 4))
    a, b = g.random((10,)), g.random((10,))
    for f in ("abs_error", "rel_error", "cosine_similarity",
              "token_mismatch_rate"):
        assert getattr(data, f)(a, b) == getattr(jdata, f)(a, b)


def test_dataio_files_match(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {"a": rng.standard_normal((3, 4)).astype(np.float32),
               "b": rng.integers(-9, 9, (5,)).astype(np.int64)}
    dataio.save_tensors(tensors, str(tmp_path / "t.bin"))
    jdataio.save_tensors(tensors, str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    back = dataio.load_tensors(str(tmp_path / "j.bin"))
    assert all(np.array_equal(back[k], tensors[k]) for k in tensors)
    dataio.save_tensor(tensors["a"], str(tmp_path / "one.bin"), "a")
    assert np.array_equal(jdataio.load_tensor(str(tmp_path / "one.bin")),
                          tensors["a"])
    h = _h()
    x = h.input((2, 3), name="x")
    w = h.weight(rng.standard_normal((3, 3)).astype(np.float32), name="w")
    h.matmul(x, w)
    dataio.save_graph_weights(h.graph, str(tmp_path / "w.bin"))
    w.set_data(np.zeros((3, 3), np.float32))
    assert dataio.load_graph_weights(h.graph, str(tmp_path / "w.bin")) == 1
    assert np.abs(w.numpy()).max() > 0


# ---------------------------------------------------------------------------
# the port's ONNX examples, on the CPU at a small size
# ---------------------------------------------------------------------------

def _example(name):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_resnet_onnx_inference(capsys):
    diff = _example("torch_resnet_onnx_inference.py").main(
        ["--image", "32", "--cpu"])
    assert diff <= 1e-4
    assert "top-5 classes" in capsys.readouterr().out


def test_example_onnx_inference(tmp_path, capsys):
    h = _h()
    _convnet(h, np.random.default_rng(0))
    h.graph.infer_output_roles()
    proto.save_model(export_onnx(h.graph, "convnet"),
                     str(tmp_path / "m.onnx"))
    x = np.random.default_rng(1).standard_normal((1, 3, 16, 16)).astype(
        np.float32)
    np.savez(tmp_path / "in.npz", x=x)
    out = _example("torch_onnx_inference.py").main(
        [str(tmp_path / "m.onnx"), "--inputs", str(tmp_path / "in.npz"),
         "--runs", "2", "--cpu", "--export", str(tmp_path / "re.onnx")])
    want = h.run({"x": x}, return_numpy=True)
    for k in want:
        np.testing.assert_allclose(out[k], want[k], rtol=1e-5, atol=1e-6)
    again = _stub(str(tmp_path / "re.onnx")).run({"x": x},
                                                  return_numpy=True)
    assert all(np.array_equal(again[k], out[k]) for k in out)
    assert "(from file)" in capsys.readouterr().out
