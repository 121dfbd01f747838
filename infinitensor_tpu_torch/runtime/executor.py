"""Graph executor: graph IR -> torch, eager on the CPU, a captured CUDA
graph per input signature on the card (counterpart of
infinitensor_tpu/runtime/executor.py).

The JAX package traces the whole graph into one XLA program per input
signature, in an LRU of executables. Here the ops run eagerly in topo
order through ops/lowering.py; on a CUDA device the sequence is captured
once per (graph version, input signature) into a CUDA graph and replayed:
the reference's run_with_cudagraph cache (reference
src/cuda/cuda_runtime.cc:351-426, capacity 16 there and
`executable_cache_capacity` here). A graph mutation (rewrite,
change_shape) clears the LRU, as the JAX executor drops its executables.
A replay first copies the inputs into the capture's static buffers and
returns copies of its outputs.

Dtypes at the boundary follow the JAX package (``_to_jax``): host
constants and inputs in float64 / int64 enter as float32 / int32, every
value in the graph tensor's (canonical) dtype.

State: the cache-append lowerings write into the cache tensors in place.
``run`` leaves the caller's tensors unchanged (an input that an in-place
op consumes is copied first); ``stepper`` owns its state tensors and
updates them in place step after step, the counterpart of the JAX
package's donated state buffers.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

import numpy as np
import torch

from infinitensor_tpu_torch.core.graph import Graph
from infinitensor_tpu_torch.core.tensor import TensorObj
from infinitensor_tpu_torch.ops.lowering import (
    LowerCtx, lower_op, torch_dtype,
)
from infinitensor_tpu_torch.runtime.profiling import captured_ms
from infinitensor_tpu_torch.utils.platform import resolve_device

#: op type -> the input positions its lowering writes in place
INPLACE_INPUTS = {"AttentionKVCache": (0, 1),
                  "AttentionKVCacheQ8": (0, 1, 2, 3)}


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch on the CPU, bf16 / fp8 numpy (ml_dtypes) by bits;
    a 0-d array stays 0-d (np.ascontiguousarray alone returns 1-d)."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    name = arr.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            getattr(torch, name))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def to_device(value, t: TensorObj, device: torch.device) -> torch.Tensor:
    """A host or device value as tensor t's value on `device`: the JAX
    boundary rule (float64 -> float32, int64 -> int32), in t's dtype."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        value = _host_tensor(arr)
    return value.to(device=device, dtype=torch_dtype(t.dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy (bf16 through ml_dtypes when present,
    else as f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        except ImportError:
            return t.float().numpy()
    return t.numpy()


class _Eager:
    """One input signature's program on the CPU: the ops, run eagerly."""

    captured = False

    def __init__(self, fn):
        self.fn = fn

    def replay(self, inputs: dict[str, torch.Tensor]) -> dict:
        return self.fn(inputs)


class _Capture:
    """One CUDA graph: static input buffers, the captured ``fn``, its
    static outputs. Made by GraphExecutor.capture."""

    captured = True

    def __init__(self, fn, inputs: dict[str, torch.Tensor], warmup=None,
                 keep=()):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # builds the kernels, no capture
            (warmup or fn)(self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        for t, v in zip(keep, saved):      # undo the warm-up's writes
            t.copy_(v)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(self.inputs)

    def replay(self, inputs: dict[str, torch.Tensor]) -> dict:
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return self.outputs


class GraphExecutor:
    def __init__(self, graph: Graph, device=None,
                 cache_capacity: Optional[int] = None,
                 use_cuda_graph: bool = True):
        graph.require_sorted()
        self.graph = graph
        self.device = resolve_device(device)
        self.ctx = LowerCtx(use_kernels=self.device.type == "cuda",
                            device=self.device)
        # LRU of captured graphs, bounded like the reference's CUDA-Graph
        # capture cache (include/cuda/cuda_runtime.h:66-128, capacity 16)
        if cache_capacity is None:
            from infinitensor_tpu_torch.utils.config import config
            cache_capacity = config.executable_cache_capacity
        self.cache_capacity = max(1, int(cache_capacity))
        self.use_cuda_graph = use_cuda_graph and self.device.type == "cuda"
        self._cache: OrderedDict = OrderedDict()   # signature -> _Capture
        self._weight_vals: Optional[dict[str, torch.Tensor]] = None
        self.epoch = 0      # bumped whenever captured graphs go stale
        self._snap_boundary()

    def _snap_boundary(self) -> None:
        self._inputs = self.graph.inputs()
        self._outputs = self.graph.outputs()
        self._weights = {t.name: t for t in self.graph.weights()}
        self._const_vals: Optional[dict[int, torch.Tensor]] = None
        self._mutated_inputs = set()
        for op in self.graph.operators:
            for i in INPLACE_INPUTS.get(op.op_type, ()):
                if i < len(op.inputs) and op.inputs[i] is not None:
                    self._mutated_inputs.add(op.inputs[i].name)
        self._graph_version = self.graph.version

    # ------------------------------------------------------------------
    def bound_weights(self) -> dict[str, torch.Tensor]:
        """The weights' values on the device, by name (made from the
        graph's data at the first call, or bound by set_weight)."""
        if self._weight_vals is None:
            self._weight_vals = {}
        for n, t in self._weights.items():
            if n not in self._weight_vals:
                if not t.has_data():
                    raise ValueError(
                        f"weight '{n}' is a placeholder with no data; "
                        f"supply it with set_weight() before running")
                self._weight_vals[n] = to_device(t.numpy(), t, self.device)
        return self._weight_vals

    def set_weight(self, name: str, value) -> None:
        """Bind a weight value (host or device; a tensor already on the
        executor's device in the weight's dtype is adopted without a
        copy). Works for placeholder weights made by
        GraphHandler.weight_placeholder. Drops the captured graphs, which
        read the old tensors."""
        if name not in self._weights:
            raise KeyError(f"no weight tensor named '{name}'")
        if self._weight_vals is None:
            self._weight_vals = {}
        self._weight_vals[name] = to_device(value, self._weights[name],
                                            self.device)
        self._cache.clear()
        self.epoch += 1

    def input_zeros(self, name: str) -> torch.Tensor:
        """A zero tensor of graph input `name`'s shape and dtype on the
        device (a state buffer)."""
        t = next(t for t in self._inputs if t.name == name)
        return torch.zeros(t.shape, dtype=torch_dtype(t.dtype),
                           device=self.device)

    def capture(self, fn, inputs: Optional[dict] = None, warmup=None,
                keep=()) -> _Capture:
        """Capture ``fn(static_inputs) -> outputs`` in one CUDA graph.
        The inputs are copied into static buffers; ``replay(inputs)``
        copies new values in, replays, and returns the static outputs.
        ``warmup`` (default ``fn``) runs once eagerly on a side stream
        first, so the kernels are built outside the capture; the tensors
        in ``keep`` get back the values they had before it."""
        return _Capture(fn, inputs or {}, warmup, keep)

    def forward(self, input_vals: dict[str, Any],
                weight_vals: Optional[dict[str, Any]] = None
                ) -> dict[str, torch.Tensor]:
        """Run the ops in topo order eagerly (captured by the callers),
        on `weight_vals` or the bound weights."""
        if weight_vals is None:
            weight_vals = self.bound_weights()
        env: dict[int, Any] = {}
        for t in self._inputs:
            env[t.guid] = input_vals[t.name]
        for name, arr in weight_vals.items():
            env[self._weights[name].guid] = arr
        env.update(self._constants(env))
        for op in self.graph.operators:
            ins = [env[t.guid] if t is not None else None for t in op.inputs]
            outs = lower_op(op, ins, self.ctx)
            for t, v in zip(op.outputs, outs):
                if tuple(v.shape) != t.shape:
                    raise RuntimeError(
                        f"{op.op_type} lowering produced shape "
                        f"{tuple(v.shape)}, IR says {t.shape} for {t.name}")
                env[t.guid] = v
        return {t.name: env[t.guid] for t in self._outputs}

    def _constants(self, env: dict) -> dict:
        """Tensors that are neither inputs nor weights but carry data (e.g.
        folded shapes), on the device: made at the first run (eager, so a
        capture copies nothing from the host), kept until the graph
        changes."""
        if self._const_vals is None:
            self._const_vals = {
                t.guid: to_device(t.numpy(), t, self.device)
                for t in self.graph.tensors
                if t.guid not in env and t.has_data() and t.source is None
                and t.name not in self._weights}
        return self._const_vals

    # ------------------------------------------------------------------
    @staticmethod
    def _signature(input_vals: dict[str, torch.Tensor]):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in input_vals.items()))

    def _check_version(self) -> None:
        if self.graph.version != self._graph_version:
            # Graph mutated (rewrite / change_shape): drop the captures and
            # re-snap the boundary (reference GraphCaptureStateObj::
            # markChanged)
            self._cache.clear()
            self.graph.require_sorted()
            self._snap_boundary()
            self._weight_vals = None
            self.epoch += 1

    def _compiled(self, input_vals: dict[str, torch.Tensor]):
        """The program of this input signature, from the LRU or made now:
        a captured CUDA graph on the card, the eager ops on the CPU."""
        self._check_version()
        key = self._signature(input_vals)
        cap = self._cache.get(key)
        if cap is None:
            weights = self.bound_weights()
            fn = lambda vals: self.forward(vals, weights)  # noqa: E731
            cap = self.capture(fn, input_vals) if self.use_cuda_graph \
                else _Eager(fn)
            self._cache[key] = cap
            while len(self._cache) > self.cache_capacity:
                self._cache.popitem(last=False)   # evict least-recent
        else:
            self._cache.move_to_end(key)
        return cap

    def _materialize(self, inputs: Optional[dict]) -> dict:
        inputs = dict(inputs or {})
        vals = {}
        for t in self._inputs:
            if t.name in inputs:
                v = to_device(inputs[t.name], t, self.device)
                if t.name in self._mutated_inputs and \
                        not self.use_cuda_graph and \
                        isinstance(inputs[t.name], torch.Tensor) and \
                        v.data_ptr() == inputs[t.name].data_ptr():
                    v = v.clone()      # the caller's tensor stays as it is
                vals[t.name] = v
            elif t.has_data():
                vals[t.name] = to_device(t.numpy(), t, self.device)
            else:
                raise ValueError(f"missing graph input {t.name!r}")
        return vals

    def run(self, inputs: Optional[dict[str, Any]] = None,
            return_numpy: bool = False) -> dict[str, Any]:
        self._check_version()
        vals = self._materialize(inputs)
        prog = self._compiled(vals)
        out = prog.replay(vals)
        if prog.captured:       # static buffers: the next replay rewrites
            out = {k: v.clone() for k, v in out.items()}
        if return_numpy:
            return {k: to_numpy(v) for k, v in out.items()}
        return out

    # ------------------------------------------------------------------
    # timing (reference getPerfTime / printProfilingData analogs)
    # ------------------------------------------------------------------
    def _timed_ms(self, call, n: int) -> float:
        """Mean ms of `n` calls: CUDA events on the card, the host clock
        (after the calls' work) on the CPU."""
        if self.device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n):
                call()
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1) / n
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        return (time.perf_counter() - t0) * 1e3 / n

    def time_ms(self, inputs: Optional[dict] = None, warmup: int = 2,
                iters: int = 10) -> float:
        """Whole-graph latency: the mean over `iters` runs after `warmup`
        (one captured graph's replays on the card)."""
        self._check_version()
        vals = self._materialize_inputs(inputs)
        prog = self._compiled(vals)
        call = lambda: prog.replay(vals)        # noqa: E731
        for _ in range(max(1, warmup)):
            call()
        return self._timed_ms(call, max(1, iters))

    def profile(self, inputs: Optional[dict] = None,
                perf_engine=None) -> list[tuple[str, str, float]]:
        """Per-op timing table (reference RuntimeObj::run profiling=true,
        src/core/runtime.cc:130-138): each op run alone on its real input
        values after one eager warm-up. Where the executor captures (the
        card), each op is timed as runtime/profiling.py captured_ms times
        a call: captured, on cold copies of its inputs, so the host's
        launch cost stays out; else 5 eager calls (CUDA events on the card
        without capture, the host clock on the CPU). The sum is an upper
        bound against the captured whole-graph run, whose ops may find
        their producer's output still in the L2."""
        self._check_version()
        inputs = self._materialize_inputs(inputs)
        env: dict[int, Any] = {}
        for t in self._inputs:
            env[t.guid] = inputs[t.name]
        for name, arr in self.bound_weights().items():
            env[self._weights[name].guid] = arr
        env.update(self._constants(env))
        rows = []
        for op in self.graph.operators:
            ins = [env[t.guid] if t is not None else None for t in op.inputs]
            outs = lower_op(op, ins, self.ctx)       # warm-up
            if self.device.type == "cuda" and self.use_cuda_graph:
                ms = captured_ms(
                    lambda *a, op=op: lower_op(op, list(a), self.ctx), ins)
            else:
                ms = self._timed_ms(lambda: lower_op(op, ins, self.ctx), 5)
            rows.append((op.name, op.op_type, ms))
            if perf_engine is not None:
                perf_engine.set(op.workload_key(), ms)
            for t, v in zip(op.outputs, outs):
                env[t.guid] = v
        return rows

    def _materialize_inputs(self, inputs: Optional[dict]) -> dict:
        """Inputs for timing: the given ones, the graph's constants, or
        seeded random values (standard normal floats, 0 / 1 ints)."""
        inputs = dict(inputs or {})
        rng = np.random.default_rng(0)
        for t in self._inputs:
            if t.name not in inputs and not t.has_data():
                if t.dtype.is_float:
                    inputs[t.name] = rng.standard_normal(t.shape,
                                                         dtype=np.float32)
                else:
                    inputs[t.name] = rng.integers(0, 2, size=t.shape)
        return self._materialize(inputs)

    # ------------------------------------------------------------------
    def stepper(self, state_map: dict[str, str],
                init_state: Optional[dict[str, Any]] = None
                ) -> "StatefulStepper":
        """Stateful autoregressive runner: ``state_map`` maps a state INPUT
        tensor name to the OUTPUT tensor name that carries its next value
        (e.g. KV-cache in -> KV-cache out of AttentionKVCache). The state
        lives on the device, owned by the stepper, and is updated in place
        every step: the counterpart of the JAX package's donated buffers
        (reference src/kernels/cuda/attention_kvcache.cu mutates its cache
        in the kernel the same way)."""
        return StatefulStepper(self, state_map, init_state)


class StatefulStepper:
    """Created by :meth:`GraphExecutor.stepper`; call with the non-state
    inputs, receive the non-state outputs; the state is threaded through
    tensors the stepper owns. On the card each input signature's step
    (forward + state write-back) is one captured CUDA graph."""

    def __init__(self, executor: GraphExecutor, state_map: dict[str, str],
                 init_state: Optional[dict[str, Any]] = None):
        self.executor = executor
        self.state_map = dict(state_map)
        in_names = {t.name for t in executor._inputs}
        out_names = {t.name for t in executor._outputs}
        missing = [n for n in state_map if n not in in_names] + \
            [n for n in state_map.values() if n not in out_names]
        if missing:
            raise ValueError(f"state_map names not in graph boundary: "
                             f"{missing}")
        self._state_out_names = set(state_map.values())
        init_state = init_state or {}
        by_name = {t.name: t for t in executor._inputs}
        self.state: dict[str, torch.Tensor] = {}
        for name in state_map:
            if name in init_state:
                self.state[name] = to_device(init_state[name], by_name[name],
                                             executor.device).clone()
            else:
                self.state[name] = executor.input_zeros(name)
        self._captures: dict = {}
        self._epoch = executor.epoch

    def _step(self, inputs: dict[str, torch.Tensor]) -> dict:
        ex = self.executor
        vals = dict(inputs)
        vals.update(self.state)
        out = ex.forward(vals)
        for k, v in self.state_map.items():
            if out[v] is not self.state[k]:       # not updated in place
                self.state[k].copy_(out[v])
        return {k: v for k, v in out.items()
                if k not in self._state_out_names}

    def __call__(self, inputs: dict[str, Any],
                 return_numpy: bool = False) -> dict[str, Any]:
        ex = self.executor
        ex._check_version()
        by_name = {t.name: t for t in ex._inputs}
        vals = {k: to_device(v, by_name[k], ex.device)
                for k, v in inputs.items()}
        if ex.use_cuda_graph:
            if ex.epoch != self._epoch:
                self._captures.clear()
                self._epoch = ex.epoch
            key = GraphExecutor._signature(vals)
            if key not in self._captures:
                # the capture's warm-up step writes the state; put it back
                self._captures[key] = ex.capture(
                    self._step, vals, keep=list(self.state.values()))
            out = {k: v.clone()
                   for k, v in self._captures[key].replay(vals).items()}
        else:
            out = self._step(vals)
        if return_numpy:
            return {k: to_numpy(v) for k, v in out.items()}
        return out

    def fetch_state(self) -> dict[str, np.ndarray]:
        """Host copy of the current state (checkpoint path)."""
        return {k: to_numpy(v) for k, v in self.state.items()}
