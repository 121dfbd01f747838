"""Standalone per-operator micro-benchmarks (counterpart of
infinitensor_tpu/runtime/operator_timer.py).

The analog of the reference's operator-timer FFI (reference
src/cuda/operator_timer.cc + python/infinitensor/operator_timer.py:
getPerfConvCudnn / getPerfMatmulCublas exposed to Python). Each entry
builds its op, runs it on `device` (the card unless the caller passes the
CPU) and returns ms/call: the conv and the matmul through the graph API
and the executor's ``time_ms`` (one captured CUDA graph's replays on the
card), the weight-only matmul and the decode attention through their
kernel wrappers and profiling.timeit (CUDA events on the card). Usable
interactively and as a PerfEngine seeding tool.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from infinitensor_tpu_torch.core.handler import GraphHandler
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.profiling import timeit
from infinitensor_tpu_torch.utils.platform import resolve_device


def _time_graph(h: GraphHandler, device, warmup=2, rounds=10) -> float:
    h.graph.infer_output_roles()
    ex = GraphExecutor(h.graph, device=device)
    return ex.time_ms(warmup=warmup, iters=rounds)


def get_perf_conv(n, c, h_, w_, f, r, s, pad=0, stride=1, dilation=1,
                  dtype=np.float32, device=None) -> float:
    g = GraphHandler()
    x = g.input((n, c, h_, w_))
    wt = g.weight(np.random.default_rng(0).standard_normal(
        (f, c, r, s)).astype(dtype))
    g.conv(x, wt, pads=(pad, pad), strides=(stride, stride),
           dilations=(dilation, dilation))
    return _time_graph(g, device)


def get_perf_matmul(b, m, n, k, dtype=np.float32, device=None) -> float:
    g = GraphHandler()
    shape_a = (b, m, k) if b > 1 else (m, k)
    shape_b = (b, k, n) if b > 1 else (k, n)
    a = g.input(shape_a)
    w = g.input(shape_b)
    g.matmul(a, w)
    return _time_graph(g, device)


def get_perf_quant_matmul(m, k, n, bits=8, group=128, device=None) -> float:
    """quantize_weight + quant_matmul of a bf16 [m, k] x (the qmm_group
    kernels on the card)."""
    from infinitensor_tpu_torch.kernels.quant_matmul import quant_matmul
    from infinitensor_tpu_torch.quant.weight_only import (
        QuantizedLinear, quantize_weight)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    q = quantize_weight(torch.randn(k, n, generator=gen), bits=bits,
                        group_size=group)
    q = QuantizedLinear(q.qweight.to(dev), q.scales.to(dev), q.bits,
                        q.group_size, q.out_logical)
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
    return timeit(lambda: quant_matmul(x, q))


def get_perf_decode_attention(b, h_, s, d, ctx: Optional[int] = None,
                              device=None) -> float:
    """decode_attention_gqa over a bf16 cache [b, h_, s, d] at position
    ctx (default s // 2): the cache append and flash_decode (with its
    merge where the launch is split) on the card."""
    from infinitensor_tpu_torch.kernels.attention import decode_attention_gqa
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16).to(dev)

    kc, vc = randn(b, h_, s, d), randn(b, h_, s, d)
    q, kv = randn(b, h_, 1, d), randn(b, h_, 1, d)
    pos = torch.full((b,), ctx or s // 2, dtype=torch.int32, device=dev)
    return timeit(lambda: decode_attention_gqa(kc, vc, q, kv, kv, pos))
