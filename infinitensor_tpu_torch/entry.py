"""Entry point of the port (counterpart of __graft_entry__.entry()).

entry(device=None) -> (fn, args): one decode step of a small Llama, the
JAX package's own entry configuration (__graft_entry__.py:15-43): vocab
2048, dim 512, 4 layers, 8 heads, intermediate 1376, max_seq 256, INT4
weights at group 64, INT8 KV cache, batch 2, write position 5. fn is
llama_decode_step and fn(*args) returns (logits [2, 2048], cache). On the
card unless the caller asks for the CPU; weights from a torch.Generator
seeded 0 on that device.

At group 64 every linear but w_down takes the chunk kernel (qmm_chunk):
wqkv and w_gateup through rmsnorm + quant_matmul, the group being no multiple of
128; w_down (1376 inputs: quantize_weight snaps its group to 32, which
does not divide its 688 packed rows) takes the dequant route, as in the
JAX package. dryrun_multichip(n) waits for the parallelism slice (ROADMAP
Queue 1 item 14).
"""

from __future__ import annotations

import torch

from infinitensor_tpu_torch.models.llama import (
    LlamaConfig, init_kv_cache, init_llama_params, llama_decode_step,
    quantize_llama_params,
)
from infinitensor_tpu_torch.utils.platform import resolve_device

BATCH, POS, GROUP = 2, 5, 64


def small_config() -> LlamaConfig:
    return LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=8,
                       n_kv_heads=8, intermediate=1376, max_seq=256)


def entry(device=None):
    device = resolve_device(device)
    cfg = small_config()
    gen = torch.Generator(device=device).manual_seed(0)
    params = quantize_llama_params(
        init_llama_params(cfg, gen, device=device), bits=4,
        group_size=GROUP)
    cache = init_kv_cache(cfg, BATCH, kv_quant=True, device=device)
    token = torch.zeros(BATCH, dtype=torch.int32, device=device)
    pos = torch.full((BATCH,), POS, dtype=torch.int32, device=device)
    return llama_decode_step, (params, cfg, token, pos, cache)
