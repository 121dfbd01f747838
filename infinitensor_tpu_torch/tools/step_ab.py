"""The 7B decode paths of two checkouts, and the kernels this checkout
redesigned on them, timed in one call on one card: the paths of
chip_smoke.py phases 4 and 6 at their shapes (Llama-2-7B INT4, random
weights from chip_smoke.SEED) and rmsnorm / qmm_group_norm at phase 3's.

    python -m infinitensor_tpu_torch.tools.step_ab OLD_ROOT [NEW_ROOT]

Rows:
  * "decode tok/s": phase 4's region, 128 greedy steps from pos 1024 with
    the INT8 cache as one CUDA graph, the best of 3 runs from fresh state;
  * "paged step ms bf16 / int8": phase 6's paged engine (8 slots, pages of
    64 rows) at 8 live slots from pos 640, its captured step replayed in
    chunks of 8, host clock over 8 chunks, best of 3 (phase 6's
    decode_ms_per_step_8_live); "dense step ms int8": the dense engine's
    step the same way in CUDA events (median of 20 chunks, phase 6's
    dense_forms);
  * "qmm_group_norm wqkv / w_gateup N rows" (quant_matmul_norm, 1 and 8
    rows) and "rmsnorm bf16 / f32 Nx4096" (1-4096 rows): ms, median of 50
    CUDA-event timings after a 1 GB memset (cold L2).

Run by tools/attention_ab.main: both roots built at once, then one
process per root in turns, old, new, new, old, each calling only the
interface both checkouts share; chip_smoke.py's helpers come from this
checkout and take the old one's modules as arguments. Prints the card
(nvidia-smi name and power limit) and one JSON line {row: {"old": [v, v],
"new": [v, v]}}.
"""

from __future__ import annotations

import runpy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def time_rows() -> dict:
    """{row: value} of the checkout on the import path."""
    import torch

    from infinitensor_tpu_torch.kernels import norms
    from infinitensor_tpu_torch.kernels import quant_matmul as qm
    from infinitensor_tpu_torch.models import llama
    from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear
    from infinitensor_tpu_torch.serving import (PagedServingEngine,
                                                ServingEngine)
    from infinitensor_tpu_torch.tools.qmm_bench import _ms

    cs = runpy.run_path(str(ROOT / "chip_smoke.py"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev).manual_seed(cs["SEED"])
    cfg = llama.LlamaConfig(max_seq=cs["MAX_SEQ"])
    params = cs["build_params"](torch, cfg, gen, dev, QuantizedLinear)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    rows = {}

    # phase 4's region
    token = torch.zeros(1, dtype=torch.int32, device=dev)
    pos = torch.full((1,), cs["CTX"], dtype=torch.int32, device=dev)
    cache = llama.init_kv_cache(cfg, 1, kv_quant=True, device=dev)
    g = llama.DecodeGraph(params, cfg, token, pos, cache, cs["STEPS"])
    rows["decode tok/s"] = max(cs["time_graph"](torch, g, cache, token,
                                                pos))
    del g, cache

    # phase 6's engines at SLOTS live slots
    slots, chunk = cs["SLOTS"], cs["CHUNK"]
    tok0 = torch.zeros(slots, dtype=torch.int32, device=dev)
    pos0 = torch.full((slots,), 640, dtype=torch.int32, device=dev)
    kw = dict(max_slots=slots, prefill_buckets=cs["BUCKETS"],
              decode_chunk=chunk)
    for tag, kv_quant in (("bf16", False), ("int8", True)):
        eng = PagedServingEngine(params, cfg, kv_quant=kv_quant,
                                 n_pages=cs["POOL_PAGES"],
                                 page_size=cs["PAGE"], **kw)
        eng.cache["block_table"].zero_()
        eng.cache["block_table"][:, :12] = torch.arange(
            slots * 12, device=dev, dtype=torch.int32).reshape(slots, 12) + 1
        eng._run_program(tok0, pos0, chunk)             # captures the step
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                eng._program.run(tok0, pos0, chunk)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) / (8 * chunk))
        rows[f"paged step ms {tag}"] = 1e3 * min(samples)
        del eng
    dense = ServingEngine(params, cfg, kv_quant=True, **kw)
    dense._run_program(tok0, torch.zeros_like(tok0), 1)
    rows["dense step ms int8"] = cs["cuda_ms"](
        torch, lambda: dense._program.run(tok0, pos0, chunk), 20) / chunk
    del dense

    # the kernels at phase 3's shapes
    layer0 = params["layers"][0]
    for n in (1, 8):
        x = (torch.randn(n, cfg.dim, generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        for label in ("wqkv", "w_gateup"):
            rows[f"qmm_group_norm {label} {n} rows"] = _ms(
                lambda x=x, q=layer0[label]: qm.quant_matmul_norm(
                    x, layer0["attn_norm"], q, cfg.norm_eps), flush)
    w = (torch.rand(cfg.dim, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for n in (1, 8, 64, 256, 1024, 4096):
            x = (torch.randn(n, cfg.dim, generator=gen, device=dev) * 3).to(dt)
            rows[f"rmsnorm {tag} {n}x{cfg.dim}"] = _ms(
                lambda x=x: norms.rmsnorm(x, w, cfg.norm_eps), flush)
    return rows


if __name__ == "__main__":
    from infinitensor_tpu_torch.tools import attention_ab
    attention_ab.main(sys.argv[1:], __file__, __doc__)
