"""Kernel autotuner: multi-config timing with persistent cache
(counterpart of infinitensor_tpu/runtime/tuner.py).

The analog of the reference's per-kernel multi-algorithm tuning
(reference include/core/kernel.h:32-205 ``computeFuncTune`` picking the
fastest ``ComputeFuncPtr``; cuBLAS 24-algo loop in
src/kernels/cuda/matmul.cc:25-187): a kernel exposes launch knobs, the
tuner times each candidate on the target device and records the winner in
the PerfEngine JSON cache keyed by (kernel, arg shapes/dtypes, device
kind) so later runs skip the sweep.

Each pre-wired sweep keeps the function the same and changes only the
launch: the split count of the dense decode attention (the JAX package's
``seq_block``) and the K split of qmm_group's one-row CUDA-core form (its
``block_out``). The tuner is opt-in: the default routes do not read it.

A candidate the launch refuses (utils/errors.py Refused) is skipped,
logged and kept in the record with its error; any other error propagates
(a kernel that fails to build or launch raises RuntimeError, a wrapper's
shape check ValueError).

On the card a candidate is timed cold and without the host
(runtime/profiling.py captured_ms): its calls captured in one CUDA graph,
each on its own copy of the operands, the copies together at least four
times the L2, as a decode step meets each layer's weights and cache.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from infinitensor_tpu_torch.runtime.perf import PerfEngine
from infinitensor_tpu_torch.runtime.profiling import (
    captured_ms, timeit, tree_leaves,
)
from infinitensor_tpu_torch.utils.errors import Refused
from infinitensor_tpu_torch.utils.logging import get_logger

_log = get_logger("tuner")

def _device_kind(args) -> str:
    """The card's name where an argument lies on a CUDA device, else
    "cpu"."""
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return torch.cuda.get_device_name(t.device)
    return "cpu"


def _args_sig(args) -> list:
    sig = []
    for a in tree_leaves(args):
        if isinstance(a, torch.Tensor):
            sig.append([list(a.shape), str(a.dtype).removeprefix("torch.")])
        else:
            sig.append([repr(a)])
    return sig


def _engine(perf_engine: Optional[PerfEngine]) -> PerfEngine:
    """The given engine, even an empty one (an empty PerfEngine is falsy),
    else the process singleton."""
    return PerfEngine.instance() if perf_engine is None else perf_engine


def _time_call(fn: Callable, args, warmup: int = 1, iters: int = 5) -> float:
    """ms/call: runtime/profiling.py captured_ms on the card (the default
    routes run captured, and an eager call of these kernels costs the
    host more than the card, so eager timing would rank launch
    overheads), timeit elsewhere."""
    if _device_kind(args) == "cpu":
        return timeit(fn, *args, warmup=warmup, rounds=max(2, iters))
    return captured_ms(fn, args, warmup, iters)


def tune(name: str, make_fn: Callable[[dict], Callable],
         configs: Sequence[dict], args,
         perf_engine: Optional[PerfEngine] = None,
         warmup: int = 1, iters: int = 5) -> dict:
    """Pick the fastest config for ``make_fn(config)(*args)``.

    Returns the winning config; the choice, its time, every candidate's
    time and the skipped candidates with their errors are cached in the
    PerfEngine keyed by kernel name + arg signature + device kind, so the
    sweep runs once per workload per device.
    """
    if not configs:
        raise ValueError("no configs to tune over")
    pe = _engine(perf_engine)
    key = ["kernel_tune", name, _device_kind(args), _args_sig(args)]
    cached = pe.get(key)
    if isinstance(cached, dict) and "config" in cached:
        return cached["config"]

    best_cfg, best_ms = None, float("inf")
    timed, skipped = [], []
    for cfg in configs:
        try:
            fn = make_fn(cfg)
            ms = _time_call(fn, args, warmup, iters)
        except Refused as e:
            _log.warning("config_skipped", kernel=name, config=cfg,
                         error=repr(e))
            skipped.append({"config": cfg, "error": repr(e)})
            continue
        timed.append({"config": cfg, "ms": ms})
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms
    if best_cfg is None:
        raise RuntimeError(f"{name}: every tuning config failed: {skipped}")
    pe.set(key, {"config": best_cfg, "time_ms": best_ms,
                 "candidates": timed, "skipped": skipped})
    return best_cfg


def record(name: str, args, perf_engine: Optional[PerfEngine] = None):
    """The PerfEngine record `tune` keeps for (name, args), or None."""
    return _engine(perf_engine).get(
        ["kernel_tune", name, _device_kind(args), _args_sig(args)])


# -- pre-wired sweeps for the port's kernels ----------------------------------

def _split_configs(cap: int) -> list:
    """{"_splits": n} for 1 and the powers of two up to cap."""
    out, n = [{"_splits": 1}], 2
    while n <= cap:
        out.append({"_splits": n})
        n *= 2
    return out


def decode_split_configs(S: int) -> list:
    """The dense decode attention's split counts to try over a cache of S
    rows: 1 and the powers of two up to min(MAX_SPLITS, S //
    SPLIT_MIN_ROWS)."""
    from infinitensor_tpu_torch.kernels import attention as att
    return _split_configs(min(att.MAX_SPLITS, S // att.SPLIT_MIN_ROWS))


def tuned_flash_decode(q, k_cache, v_cache, pos,
                       perf_engine: Optional[PerfEngine] = None):
    """flash_decode with its split count swept (kernels/attention.py)."""
    from infinitensor_tpu_torch.kernels.attention import flash_decode
    cfg = tune("flash_decode",
               lambda c: (lambda *a: flash_decode(*a, **c)),
               decode_split_configs(k_cache.shape[2]),
               (q, k_cache, v_cache, pos), perf_engine)
    return flash_decode(q, k_cache, v_cache, pos, **cfg)


def tuned_flash_decode_q8(q, k_cache, v_cache, k_scale, v_scale, pos,
                          perf_engine: Optional[PerfEngine] = None):
    """flash_decode_q8 (INT8 KV) with its split count swept."""
    from infinitensor_tpu_torch.kernels.attention import flash_decode_q8
    cfg = tune("flash_decode_q8",
               lambda c: (lambda *a: flash_decode_q8(*a, **c)),
               decode_split_configs(k_cache.shape[2]),
               (q, k_cache, v_cache, k_scale, v_scale, pos), perf_engine)
    return flash_decode_q8(q, k_cache, v_cache, k_scale, v_scale, pos, **cfg)


def quant_matmul_configs(x, qlin) -> list:
    """The K splits to try for quant_matmul(x, qlin): at one row routed to
    qmm_group's CUDA-core form, 1 and the powers of two up to
    group_splits' cap min(SPLIT_MAX, packed rows // group); at other row
    counts and routes the route's own form only ([{}])."""
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    rows = qm._rows(x)
    if rows != 1 or qm.route(x, qlin)[0] != "qmm_group" or \
            qm.group_form(rows, x.dtype, False, qlin.bits) != "cuda_core":
        return [{}]
    return _split_configs(min(qm.SPLIT_MAX,
                              qm._packed_rows(qlin) // qlin.group_size))


def tuned_quant_matmul(x, qlin, perf_engine: Optional[PerfEngine] = None):
    """quant_matmul with the one-row K split swept
    (kernels/quant_matmul.py)."""
    from infinitensor_tpu_torch.kernels.quant_matmul import quant_matmul
    cfg = tune("quant_matmul",
               lambda c: (lambda *a: quant_matmul(*a, **c)),
               quant_matmul_configs(x, qlin), (x, qlin), perf_engine)
    return quant_matmul(x, qlin, **cfg)
