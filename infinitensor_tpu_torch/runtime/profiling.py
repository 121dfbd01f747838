"""Profiling / timing utilities (counterpart of
infinitensor_tpu/runtime/profiling.py).

Reference analogs (SURVEY §5): ``timeit`` harness (include/core/common.h:93),
per-op profiling tables (printProfilingData, src/core/runtime.cc:130-138),
plus a timeline tracer (``xprof_trace``, a torch.profiler Chrome trace
here) and a static-ish cost report (``compiled_cost``).

On the card a region is timed with CUDA events, as the executor's
``_timed_ms`` does; a function whose outputs lie on the CPU is timed on
the host clock with the JAX package's two-point region. ``captured_ms``
(the port's own) times a call on the card cold and captured: the
tuner's candidates and GraphExecutor.profile's ops, so the search's
costs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch


def tree_leaves(tree) -> list:
    """The leaves of a tree of lists, tuples, dicts and dataclasses (a
    QuantizedLinear gives its fields)."""
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if isinstance(tree, dict):
        return tree_leaves(list(tree.values()))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tree_leaves([getattr(tree, f.name)
                            for f in dataclasses.fields(tree)])
    return [tree]


def _leaves(out) -> list:
    """The tensors of an output tree."""
    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _leaves(out))


def host_fetch(out) -> None:
    """End a timed region: wait for the card, then fetch one element of
    the first output tensor to the host."""
    leaves = _leaves(out)
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    if leaves:
        leaves[0].reshape(-1)[:1].cpu()


def timeit(fn: Callable, *args, warmup: int = 2, rounds: int = 10) -> float:
    """ms/call of ``fn(*args)``: the mean of `rounds` calls between two
    CUDA events where the outputs lie on the card; on the CPU, host-fetch
    terminated regions with two-point launch-overhead cancellation
    (reference timeit, common.h:93)."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    host_fetch(out)
    rounds = max(2, rounds)
    if _on_card(out):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(rounds):
            fn(*args)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / rounds

    def region(n: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        host_fetch(out)
        return time.perf_counter() - t0

    t1 = region(1)
    tn = region(rounds)
    est = (tn - t1) / (rounds - 1)
    if est <= 0.0:
        # noise dominated the two-point pair (t1 caught a scheduling
        # stall): fall back to the launch-inclusive per-call mean, a
        # strict upper bound that is always positive
        est = tn / rounds
    return est * 1e3


#: a cold timing's operand copies hold together at least this many times
#: the card's L2, in at most MAX_COPIES copies
COLD_L2_TIMES = 4
MAX_COPIES = 64
REPLAYS = 10        # timed replays of a captured graph


def tree_map(fn: Callable, tree):
    """``tree`` with each leaf replaced by fn(leaf) (lists, tuples, dicts
    and dataclasses, as tree_leaves reads them)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def captured_ms(fn: Callable, args, warmup: int = 1, iters: int = 5,
                replays: int = REPLAYS) -> float:
    """ms/call of ``fn(*args)`` on the card, cold and without the host.
    The tensors of ``args`` are copied n times, n the fewest copies that
    hold COLD_L2_TIMES times the card's L2 (1 to MAX_COPIES); after
    `warmup` eager calls on a side stream, max(iters, n) calls, each on
    the next copy in turn, are captured in one CUDA graph, replayed
    `replays` times between two CUDA events. So a call finds none of its
    operands left in the L2 by the call before it, as each layer of a
    decode step meets its own weights and cache, and the host's cost of a
    launch, larger than these kernels' own time when they run eagerly,
    stays out of the time. fn must be capturable, as every op a graph
    executor runs on the card is; one that launches nothing (a view)
    captures an empty graph, which PyTorch warns of, and reads ~0 ms."""
    leaves = _leaves(args)
    dev = next(t.device for t in leaves if t.is_cuda)
    size = max(1, sum(t.numel() * t.element_size() for t in leaves))
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    n = max(1, min(MAX_COPIES, -(-COLD_L2_TIMES * l2 // size)))
    copies = [args] + [tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, args)
        for _ in range(n - 1)]
    calls = max(iters, n)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for i in range(max(1, warmup)):
            fn(*copies[i % n])
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*copies[i % n])
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (replays * calls)


@contextlib.contextmanager
def xprof_trace(logdir: Optional[str] = None):
    """Capture a torch.profiler trace (host and, where CUDA is present,
    device activity) and write it to ``logdir/trace.json`` in the Chrome
    trace format. Yields the directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "infinitpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn: Callable, *args) -> dict:
    """Cost of one call of ``fn(*args)``, with the JAX function's keys.

    ``flops`` is what torch.utils.flop_counter.FlopCounterMode counts over
    the call's aten operators; a kernel launched through ctypes (the
    port's CUDA kernels) is not an aten operator and is not counted.
    ``argument_bytes`` / ``output_bytes`` are the tensor arguments' and
    outputs' sizes; ``temp_bytes`` is the peak of
    torch.cuda.max_memory_allocated during the call above the memory
    allocated before it on the card (None on the CPU).
    ``bytes_accessed`` and ``transcendentals`` have no counterpart here
    (None)."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_leaves = _leaves(list(args))
    card = any(t.is_cuda for t in arg_leaves)
    if card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    temp = None
    if card or _on_card(out):
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - (base if card else 0)

    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    return {
        "flops": counter.get_total_flops(),
        "bytes_accessed": None,
        "transcendentals": None,
        "output_bytes": size(_leaves(out)),
        "temp_bytes": temp,
        "argument_bytes": size(arg_leaves),
    }


def profile_table(executor, inputs: Optional[dict] = None) -> str:
    """Formatted per-op timing table (reference printProfilingData)."""
    rows = executor.profile(inputs)
    total = sum(r[2] for r in rows)
    lines = [f"{'op':<32}{'type':<20}{'ms':>10}{'%':>8}"]
    for name, op_type, ms in sorted(rows, key=lambda r: -r[2]):
        pct = 100.0 * ms / total if total else 0.0
        lines.append(f"{name[:31]:<32}{op_type:<20}{ms:>10.4f}{pct:>7.1f}%")
    lines.append(f"{'TOTAL':<52}{total:>10.4f}")
    return "\n".join(lines)


def memory_report(graph) -> dict:
    """Engine-level memory plan via the native planner
    (native/planner.py), falling back to the weight and activation sums
    where the native library is unavailable (reference
    LazyAllocator::info peak print)."""
    try:
        from infinitensor_tpu_torch.native import plan_graph_memory
        return plan_graph_memory(graph)
    except RuntimeError:
        from infinitensor_tpu_torch.core.tensor import TensorRole
        return {
            "peak_bytes": None,
            "weight_bytes": sum(t.bytes() for t in graph.weights()),
            "activation_bytes": sum(
                t.bytes() for t in graph.tensors
                if t.role == TensorRole.OTHERS),
        }
