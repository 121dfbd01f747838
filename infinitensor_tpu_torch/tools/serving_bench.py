"""GPT-2 345M INT8 continuous-batching throughput on one card (the port's
counterpart of tools/serving_bench.py).

    python -m infinitensor_tpu_torch.tools.serving_bench

Random weights from seed 0, INT8 weight-only at group 128 with the int8
lm_head, a cache sized to the workload, and a fixed stream of
max(24, 3 * slots) requests of 16-249 prompt tokens and 64 new tokens
each through ServingEngine. Prints one JSON line. Knobs (environment):
SERVE_SLOTS (64), SERVE_CHUNK (64), SERVE_PIPELINE (2), SERVE_KV ("none":
bf16 cache; "int8"), SERVE_MAXSEQ (384), SERVE_REPS (2), GPT2_QLMHEAD
("1"), SERVE_LOOKAHEAD ("1"). Times are host-clock seconds around work
that ends in a device synchronise.
"""

from __future__ import annotations

import functools
import json
import os
import time

import numpy as np
import torch

from infinitensor_tpu_torch.models.gpt2 import (
    GPT2Config, gpt2_decode_step, gpt2_prefill, init_gpt2_cache,
    init_gpt2_params, quantize_gpt2_params,
)
from infinitensor_tpu_torch.serving import ServingEngine
from infinitensor_tpu_torch.utils.platform import resolve_device

NEW_TOKENS = 64
BUCKETS = (64, 256)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_params(cfg: GPT2Config, device=None, seed: int = 0,
                 quant_lm_head: bool = True) -> dict:
    """Random GPT-2 parameters made on `device` from `seed`, INT8
    weight-only at group 128."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_gpt2_params(cfg, gen, device=device)
    return quantize_gpt2_params(params, bits=8, group_size=128,
                                quant_lm_head=quant_lm_head)


def workload(slots: int, seed: int = 0, vocab_hi: int = 50000) -> list:
    """The fixed stream: max(24, 3 * slots) prompts of 16-249 tokens drawn
    from [1, vocab_hi)."""
    rng = np.random.default_rng(seed)
    n_req = max(24, 3 * slots)
    lens = rng.integers(16, 250, n_req)
    return [rng.integers(1, vocab_hi, int(n)).tolist() for n in lens]


def serve(params, cfg, *, slots=64, chunk=64, pipeline=2, kv_int8=False,
          lookahead=True, reps=2, prompts=None, device=None):
    """Warm an engine up, then drain the stream `reps` times. Returns
    (result dict, the last drain's generated tokens per request, engine)."""
    device = resolve_device(device)
    init_cache = functools.partial(init_gpt2_cache, kv_quant=True) \
        if kv_int8 else init_gpt2_cache
    eng = ServingEngine(
        params, cfg, max_slots=slots, lookahead=lookahead,
        prefill_buckets=BUCKETS, prefill_fn=gpt2_prefill,
        decode_fn=gpt2_decode_step, init_cache_fn=init_cache,
        decode_chunk=chunk, pipeline_depth=pipeline, device=device)
    _sync(device)
    t0 = time.perf_counter()
    eng.warmup()
    _sync(device)
    warmup_s = time.perf_counter() - t0
    if prompts is None:
        prompts = workload(slots)
    # one fixed workload reused every rep: reps measure run-to-run noise,
    # not prompt-length resampling
    samples, stats, all_done = [], None, True
    for _ in range(max(1, reps)):
        base_tokens, base_steps = eng.tokens_out, eng.steps
        eng.stats.clear()
        reqs = [eng.submit(list(p), max_new_tokens=NEW_TOKENS)
                for p in prompts]
        _sync(device)
        t0 = time.perf_counter()
        eng.run_to_completion()
        _sync(device)
        wall = time.perf_counter() - t0
        sample = (eng.tokens_out - base_tokens) / wall
        if not samples or sample >= max(samples):
            stats = dict(eng.stats)
        samples.append(sample)
        all_done &= all(r.done and len(r.generated) == NEW_TOKENS
                        for r in reqs)
        steps = eng.steps - base_steps
    best = max(samples)
    result = {
        "metric": f"gpt2-345m int8{'+kv8' if kv_int8 else ''} continuous "
                  f"batching tokens/s ({slots} slots)",
        "value": best, "unit": "tokens/s", "samples": samples,
        "spread_pct": 100.0 * (best - min(samples)) / best,
        "requests": len(prompts), "decode_steps": steps, "wall_s": wall,
        "warmup_s": warmup_s, "decode_chunk": chunk,
        "pipeline_depth": pipeline, "all_done": all_done, "stats": stats,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    return result, [list(r.generated) for r in reqs], eng


def main(device=None) -> dict:
    device = resolve_device(device)
    cfg = GPT2Config(max_seq=int(os.environ.get("SERVE_MAXSEQ", "384")))
    _sync(device)
    t0 = time.perf_counter()
    params = build_params(
        cfg, device,
        quant_lm_head=os.environ.get("GPT2_QLMHEAD", "1") == "1")
    _sync(device)
    build_s = time.perf_counter() - t0
    result, _, _ = serve(
        params, cfg, slots=int(os.environ.get("SERVE_SLOTS", "64")),
        chunk=int(os.environ.get("SERVE_CHUNK", "64")),
        pipeline=int(os.environ.get("SERVE_PIPELINE", "2")),
        kv_int8=os.environ.get("SERVE_KV", "none") == "int8",
        lookahead=os.environ.get("SERVE_LOOKAHEAD", "1") == "1",
        reps=int(os.environ.get("SERVE_REPS", "2")), device=device)
    result["build_s"] = build_s
    print(json.dumps(result), flush=True)
    if not result["all_done"]:
        raise SystemExit("a request did not finish with its 64 tokens")
    return result


if __name__ == "__main__":
    main()
