"""The port's runtime tools (runtime/perf.py, tuner.py, profiling.py,
operator_timer.py, workspace.py, cache.py; native/planner.py;
utils/watchdog.py) on the CPU, alone and against the JAX package's.

* A PerfEngine file written by either package loads in the other, under
  the same workload keys.
* tune: picks, caches (a second call times nothing), skips a config the
  launch refuses (Refused) and keeps it with its error, lets any other
  error through (a launch's RuntimeError, a shape check's ValueError),
  persists. The three tuned_* sweeps against the JAX package's
  on the same seeded inputs (the JAX kernels interpreted): within one
  bf16 ulp at max|ref| (both sides round f32 sums, taken in another
  order, to bf16).
* plan_graph_memory equal to the JAX package's dict on the same graph
  (offsets in tensor order), in both modes, with the same config knobs.
* babysit on the JAX package's watchdog cases.
"""

import json
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from infinitensor_tpu.core.handler import GraphHandler as JHandler
from infinitensor_tpu.native import planner as jplanner
from infinitensor_tpu.runtime import tuner as jtuner
from infinitensor_tpu.runtime.perf import PerfEngine as JPerf
from infinitensor_tpu.utils.config import config as jconfig

from infinitensor_tpu_torch.core.handler import GraphHandler as THandler
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.native import planner as tplanner
from infinitensor_tpu_torch.runtime import (
    cache, operator_timer, profiling, tuner)
from infinitensor_tpu_torch.runtime.perf import PerfEngine
from infinitensor_tpu_torch.runtime.runtime import cpu_runtime
from infinitensor_tpu_torch.runtime.workspace import Workspace
from infinitensor_tpu_torch.utils.config import config as tconfig
from infinitensor_tpu_torch.utils.errors import Refused
from infinitensor_tpu_torch.utils.watchdog import babysit



def _t(a):
    return params_from_jax_numpy(np.asarray(a), "cpu")


def _close(got, want):
    """Within one bf16 ulp at max|want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    top = np.max(np.abs(want))
    assert err <= 2.0 ** (np.floor(np.log2(top)) - 7), (err, top)


def _mlp(GH, **kw):
    """x [4, 16] -> relu(x @ w1) @ w2 + b -> softmax, in either package,
    every tensor named."""
    rng = np.random.default_rng(3)
    h = GH(name="mlp", **kw)
    x = h.input((4, 16), name="x")
    w1 = h.weight(rng.standard_normal((16, 32), dtype=np.float32), name="w1")
    w2 = h.weight(rng.standard_normal((32, 8), dtype=np.float32), name="w2")
    b = h.weight(rng.standard_normal((8,), dtype=np.float32), name="b")
    h.softmax(h.add(h.matmul(h.relu(h.matmul(x, w1)), w2), b), axis=-1)
    h.graph.infer_output_roles()
    return h


# ---------------------------------------------------------------------------
# PerfEngine
# ---------------------------------------------------------------------------

def test_perf_engine_files_load_across_packages(tmp_path):
    jg, tg = _mlp(JHandler).graph, _mlp(THandler).graph
    jkeys = [op.workload_key() for op in jg.operators]
    tkeys = [op.workload_key() for op in tg.operators]
    j, t = JPerf(), PerfEngine()
    for i, k in enumerate(jkeys):
        j.set(k, 0.5 + i)
    j.set(["kernel_tune", "x", "cpu", [[[4], "float32"]]],
          {"config": {"_splits": 2}, "time_ms": 0.25})
    j.save(tmp_path / "jax.json")
    t.load(tmp_path / "jax.json")
    assert [t.get(k) for k in tkeys] == [0.5 + i for i in range(len(tkeys))]
    assert t.get(["kernel_tune", "x", "cpu", [[[4], "float32"]]])[
        "config"] == {"_splits": 2}
    t.set(tkeys[0], 7)
    t.save(tmp_path / "torch.json")
    j2 = JPerf()
    j2.load(tmp_path / "torch.json")
    assert j2.get(jkeys[0]) == 7.0 and len(j2) == len(t)
    assert (tmp_path / "torch.json").read_bytes() == json.dumps(
        t._records, indent=1).encode()
    # the cost model sums the cached times without running anything
    assert t.graph_time_ms(tg) == pytest.approx(
        7 + sum(0.5 + i for i in range(1, len(tkeys))))


# ---------------------------------------------------------------------------
# tune
# ---------------------------------------------------------------------------

def test_tune_picks_and_caches():
    pe, calls = PerfEngine(), []

    def make_fn(cfg):
        def fn(x):
            calls.append(cfg["k"])
            return x * cfg["k"]
        return fn

    x = torch.ones(8, 8)
    cfg = tuner.tune("toy", make_fn, [{"k": 1}, {"k": 2}], (x,),
                     perf_engine=pe, warmup=0, iters=1)
    assert cfg["k"] in (1, 2)
    n = len(calls)
    cfg2 = tuner.tune("toy", make_fn, [{"k": 1}, {"k": 2}], (x,),
                      perf_engine=pe, warmup=0, iters=1)
    assert cfg2 == cfg and len(calls) == n
    rec = tuner.record("toy", (x,), pe)
    assert [c["config"] for c in rec["candidates"]] == [{"k": 1}, {"k": 2}]
    assert rec["skipped"] == [] and rec["time_ms"] == min(
        c["ms"] for c in rec["candidates"])


def test_tune_skips_refused_config_and_records_it():
    def make_fn(cfg):
        if cfg["bad"]:
            raise Refused("invalid config")
        return lambda x: x + 1

    pe = PerfEngine()
    x = torch.ones(4)
    cfg = tuner.tune("partial", make_fn, [{"bad": True}, {"bad": False}],
                     (x,), perf_engine=pe, warmup=0, iters=1)
    assert cfg == {"bad": False}
    rec = tuner.record("partial", (x,), pe)
    assert rec["skipped"] == [{"config": {"bad": True},
                               "error": "Refused('invalid config')"}]
    with pytest.raises(RuntimeError, match="every tuning config failed"):
        tuner.tune("none", make_fn, [{"bad": True}], (x,),
                   perf_engine=PerfEngine())


def test_tune_lets_a_launch_failure_through():
    """A RuntimeError (a kernel that fails to build or launch) is not a
    refused config: it propagates."""
    def make_fn(cfg):
        def fn(x):
            raise RuntimeError("kernel launch failed")
        return fn

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tuner.tune("broken", make_fn, [{"k": 1}], (torch.ones(2),),
                   perf_engine=PerfEngine(), warmup=0, iters=1)


@pytest.mark.parametrize("error", [ValueError, NotImplementedError])
def test_tune_lets_a_shape_check_through(error):
    """Only Refused skips a config: a wrapper's shape check (ValueError)
    or a plain NotImplementedError propagates, and nothing is cached."""
    def make_fn(cfg):
        def fn(x):
            raise error("bad shape")
        return fn

    pe = PerfEngine()
    with pytest.raises(error, match="bad shape"):
        tuner.tune("checked", make_fn, [{"k": 1}, {"k": 2}],
                   (torch.ones(2),), perf_engine=pe, warmup=0, iters=1)
    assert tuner.record("checked", (torch.ones(2),), pe) is None


def test_tree_map_copies_a_quantized_linear():
    """tree_map, which the cold timer uses to copy operands, rebuilds
    tuples, dicts and dataclasses (a QuantizedLinear) with new leaves."""
    from infinitensor_tpu_torch.quant.weight_only import quantize_weight
    from infinitensor_tpu_torch.runtime.profiling import tree_leaves, tree_map
    w = quantize_weight(torch.randn(256, 64, generator=torch.Generator()
                                    .manual_seed(0)), bits=4,
                        group_size=128)
    args = (torch.ones(2, 256), w, {"pos": torch.zeros(1)}, None)
    got = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                   else t, args)
    assert type(got) is tuple and type(got[1]) is type(w)
    assert got[3] is None and got[1].bits == w.bits
    for a, b in zip(tree_leaves(args), tree_leaves(got)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        else:
            assert a == b


def test_tune_persists_via_perf_engine(tmp_path):
    pe = PerfEngine()
    x = torch.ones(4)
    tuner.tune("persisted", lambda c: (lambda v: v * c["k"]), [{"k": 3}],
               (x,), perf_engine=pe, warmup=0, iters=1)
    pe.save(str(tmp_path / "perf.json"))
    pe2 = PerfEngine()
    pe2.load(str(tmp_path / "perf.json"))
    cfg = tuner.tune("persisted", lambda c: 1 / 0, [{"k": 3}], (x,),
                     perf_engine=pe2)   # make_fn never called on a hit
    assert cfg == {"k": 3}


def test_sweep_configs():
    assert tuner.decode_split_configs(1664) == [
        {"_splits": s} for s in (1, 2, 4, 8, 16)]
    assert tuner.decode_split_configs(2048) == [
        {"_splits": s} for s in (1, 2, 4, 8, 16, 32)]
    assert tuner.decode_split_configs(100) == [{"_splits": 1}]
    from infinitensor_tpu_torch.quant.weight_only import quantize_weight
    q = quantize_weight(torch.randn(4096, 256), bits=4, group_size=128)
    x1 = torch.randn(1, 4096).to(torch.bfloat16)
    assert tuner.quant_matmul_configs(x1, q) == [
        {"_splits": s} for s in (1, 2, 4, 8)]
    # more rows, or an f32 x on the CPU (the dequant route): the route's
    # own form only
    assert tuner.quant_matmul_configs(x1.repeat(2, 1), q) == [{}]
    assert tuner.quant_matmul_configs(x1.float(), q) == [{}]
    q2 = quantize_weight(torch.randn(256, 64), bits=4, group_size=128)
    assert tuner.quant_matmul_configs(x1[:, :256], q2) == [
        {"_splits": 1}]


def _q8_cache(rng, B, Hkv, S, D):
    kc = jnp.asarray(rng.integers(-127, 128, (B, Hkv, S, D)), jnp.int8)
    vc = jnp.asarray(rng.integers(-127, 128, (B, Hkv, S, D)), jnp.int8)
    ks = jnp.asarray(rng.uniform(0.005, 0.02, (B, Hkv, S)), jnp.float32)
    vs = jnp.asarray(rng.uniform(0.005, 0.02, (B, Hkv, S)), jnp.float32)
    return kc, vc, ks, vs


@pytest.mark.parametrize("q8", [False, True])
def test_tuned_flash_decode_matches_jax(q8):
    rng = np.random.default_rng(11 + q8)
    B, H, Hkv, S, D = 2, 8, 2, 256, 128
    q = jnp.asarray(rng.standard_normal((B, H, 1, D)), jnp.bfloat16)
    pos = jnp.asarray([100, S - 1], jnp.int32)
    if q8:
        args = (q,) + _q8_cache(rng, B, Hkv, S, D) + (pos,)
        jfn, tfn = jtuner.tuned_flash_decode_q8, tuner.tuned_flash_decode_q8
    else:
        args = (q,) + tuple(
            jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
            for _ in range(2)) + (pos,)
        jfn, tfn = jtuner.tuned_flash_decode, tuner.tuned_flash_decode
    with jconfig.override(pallas_interpret=True):
        want = jfn(*args, perf_engine=JPerf())
    pe = PerfEngine()
    got = tfn(*(_t(a) for a in args), perf_engine=pe)
    _close(got, want)
    name = "flash_decode_q8" if q8 else "flash_decode"
    rec = tuner.record(name, tuple(_t(a) for a in args), pe)
    assert [c["config"] for c in rec["candidates"]] == \
        tuner.decode_split_configs(S)


def test_tuned_quant_matmul_matches_jax():
    from infinitensor_tpu.kernels.quant_matmul import quant_matmul_ref
    from infinitensor_tpu.quant.weight_only import QuantizedLinear as JQ
    from infinitensor_tpu.quant.weight_only import quantize_weight
    rng = np.random.default_rng(0)
    w = rng.standard_normal((1024, 256)).astype(np.float32)
    q = quantize_weight(jnp.asarray(w), bits=4, group_size=128)
    tq = params_from_jax_numpy(
        JQ(np.asarray(q.qweight), np.asarray(q.scales), q.bits,
           q.group_size, q.out_logical), "cpu")
    for rows in (1, 4):
        x = jnp.asarray(rng.standard_normal((rows, 1024)), jnp.bfloat16)
        want = jtuner.tuned_quant_matmul(x, q, perf_engine=JPerf())
        pe = PerfEngine()
        got = tuner.tuned_quant_matmul(_t(x), tq, perf_engine=pe)
        _close(got, want)
        _close(got, quant_matmul_ref(x, q))
        rec = tuner.record("quant_matmul", (_t(x), tq), pe)
        # 512 packed rows in groups of 128: a split of at most 4
        want_cfgs = [{"_splits": s} for s in (1, 2, 4)] if rows == 1 \
            else [{}]
        assert [c["config"] for c in rec["candidates"]] == want_cfgs


# ---------------------------------------------------------------------------
# profiling, operator_timer
# ---------------------------------------------------------------------------

def test_timeit_and_host_fetch_on_the_cpu():
    x = torch.randn(64, 64)
    ms = profiling.timeit(lambda a: a @ a, x, warmup=1, rounds=3)
    assert ms > 0.0
    profiling.host_fetch({"a": [x], "b": None})
    profiling.host_fetch(())


def test_profile_table_and_compiled_cost():
    h = _mlp(THandler, runtime=cpu_runtime())
    table = profiling.profile_table(h.executor())
    lines = table.splitlines()
    assert lines[0].split() == ["op", "type", "ms", "%"]
    assert len(lines) == 2 + len(h.graph.operators)
    assert lines[-1].startswith("TOTAL")
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    cost = profiling.compiled_cost(lambda a, b: torch.relu(a @ b), a, b)
    jax_keys = {"flops", "bytes_accessed", "transcendentals",
                "output_bytes", "temp_bytes", "argument_bytes"}
    assert set(cost) == jax_keys
    assert cost["flops"] == 2 * 8 * 16 * 4
    assert cost["argument_bytes"] == 4 * (8 * 16 + 16 * 4)
    assert cost["output_bytes"] == 4 * 8 * 4
    assert cost["temp_bytes"] is None


def test_xprof_trace_writes_a_chrome_trace(tmp_path):
    with profiling.xprof_trace(str(tmp_path / "tr")) as d:
        torch.randn(16, 16).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr") and "traceEvents" in trace


def test_operator_timer_on_the_cpu():
    ms = [operator_timer.get_perf_conv(1, 4, 8, 8, 8, 3, 3, pad=1,
                                       device="cpu"),
          operator_timer.get_perf_matmul(1, 16, 16, 16, device="cpu"),
          operator_timer.get_perf_matmul(2, 8, 8, 8, device="cpu"),
          operator_timer.get_perf_quant_matmul(2, 256, 128, bits=4,
                                               device="cpu"),
          operator_timer.get_perf_decode_attention(1, 2, 128, 64,
                                                   device="cpu")]
    assert all(m > 0.0 for m in ms)


def test_memory_report_is_the_plan():
    g = _mlp(THandler).graph
    rep = profiling.memory_report(g)
    assert rep == tplanner.plan_graph_memory(g)
    assert rep["weight_bytes"] == 4 * (16 * 32 + 32 * 8 + 8)


# ---------------------------------------------------------------------------
# workspace, cache
# ---------------------------------------------------------------------------

def test_workspace():
    ws = Workspace(64)
    a = ws.take(16)
    b = ws.take_as((2, 3), np.float32)
    assert a.nbytes == 16 and b.shape == (2, 3) and ws.allocated == 40
    b[:] = 1.0
    assert ws.size == 64
    with pytest.raises(MemoryError):
        ws.take(25)
    ws.reset()
    assert ws.allocated == 0 and ws.take(64).nbytes == 64
    with pytest.raises(ValueError):
        Workspace(0)


def test_enable_compilation_cache_sets_the_build_root(tmp_path,
                                                      monkeypatch):
    from infinitensor_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    path = str(tmp_path / "kernels")
    assert cache.enable_compilation_cache(path) == path
    assert _build.BUILD_ROOT == (tmp_path / "kernels").resolve()
    assert _build.build_dir().parent == _build.BUILD_ROOT
    monkeypatch.setattr(_build.library, "cache_info",
                        lambda: type("I", (), {"currsize": 1})())
    with pytest.raises(RuntimeError, match="before the first"):
        cache.enable_compilation_cache(path)


# ---------------------------------------------------------------------------
# native planner and its config knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("naive", [False, True])
def test_plan_graph_memory_matches_jax(naive):
    jg, tg = _mlp(JHandler).graph, _mlp(THandler).graph
    jp = jplanner.plan_graph_memory(jg, naive=naive, validate=True)
    tp = tplanner.plan_graph_memory(tg, naive=naive, validate=True)
    jo, to = jp.pop("offsets"), tp.pop("offsets")
    assert tp == jp
    assert [to.get(t.name) for t in tg.tensors] == \
        [jo.get(t.name) for t in jg.tensors]
    assert tplanner.validate_memory_plan(tg, {"offsets": to}) == []
    assert tplanner.native_available()


def test_planner_knobs():
    snap = tconfig.snapshot()
    for name, env in (("naive_allocator", "INFINITPU_NAIVE_ALLOC"),
                      ("validate_memory", "INFINITPU_VALIDATE_MEMORY")):
        jsnap = jconfig.snapshot()[name]
        assert snap[name]["env"] == env == jsnap["env"]
        assert snap[name]["value"] is False is jsnap["value"]
    g = _mlp(THandler).graph
    with tconfig.override(naive_allocator=True):
        assert tplanner.plan_graph_memory(g)["naive"] is True
    assert "naive" not in tplanner.plan_graph_memory(g)
    p = tplanner.MemoryPlanner()
    a = p.alloc(100)
    p.free(a)
    assert p.peak >= 100 and p.used == 0


# ---------------------------------------------------------------------------
# watchdog (the cases of tests/test_watchdog.py)
# ---------------------------------------------------------------------------

def test_babysit_forwards_output_and_rc(capfd):
    rc = babysit([sys.executable, "-c",
                  "import sys; print('{\"metric\": \"x\"}');"
                  "print('# hb', file=sys.stderr)"],
                 quiet_s=20, gap_s=0.1, attempts=2)
    out, err = capfd.readouterr()
    assert rc == 0
    assert '{"metric": "x"}' in out
    assert "# hb" in err


def test_babysit_kills_silent_child_and_retries(capfd):
    rc = babysit([sys.executable, "-c", "import time; time.sleep(600)"],
                 quiet_s=1.0, gap_s=0.2, attempts=2)
    out, err = capfd.readouterr()
    assert rc != 0
    assert err.count("(wedged); killing") == 2


def test_babysit_retry_succeeds_after_one_wedge(tmp_path, capfd):
    flag = tmp_path / "ran_once"
    prog = (f"import os, sys, time\n"
            f"p = {str(flag)!r}\n"
            f"if os.path.exists(p):\n"
            f"    print('recovered')\n"
            f"else:\n"
            f"    open(p, 'w').close(); time.sleep(600)\n")
    rc = babysit([sys.executable, "-c", prog],
                 quiet_s=4.0, gap_s=0.2, attempts=2)
    out, _ = capfd.readouterr()
    assert rc == 0
    assert "recovered" in out
