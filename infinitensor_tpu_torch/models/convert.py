"""Carry parameters (or a KV cache, dense or paged) from the JAX package
into the port: the Llama tree, the GPT-2 tree with its "lm_head_q"
QuantizedLinear, "wte", "wpe", biases and LayerNorm vectors, the OPT tree
(the same keys as GPT-2's but no "lm_head_q", QuantizedLinear leaves
after quantize_opt_params) and the BERT tree ("tok", "pos", "type", the
embedding LayerNorm, per layer wq / wk / wv / wo with their biases, the
two LayerNorms, w_up / w_down).

The input is the JAX pytree after ``jax.tree.map(np.asarray, tree)``:
dicts, lists, numpy arrays, and quantized leaves (any object with
qweight, scales, bits, group_size and out_logical). JAX's numpy bf16 has
the dtype ``ml_dtypes.bfloat16``, which torch.from_numpy refuses; it is
recognised by name and carried through its uint16 bits, so ml_dtypes is
not needed.
"""

from __future__ import annotations

import numpy as np
import torch

from infinitensor_tpu_torch.quant.weight_only import QuantizedLinear
from infinitensor_tpu_torch.utils.platform import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy: caches mutate
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax_numpy(tree, device=None):
    """Same structure with torch tensors on `device` and QuantizedLinear
    leaves; bit-exact for every dtype."""
    device = resolve_device(device)
    if all(hasattr(tree, f) for f in ("qweight", "scales", "bits",
                                       "group_size", "out_logical")):
        return QuantizedLinear(_tensor(tree.qweight, device),
                               _tensor(tree.scales, device), int(tree.bits),
                               int(tree.group_size), int(tree.out_logical))
    if isinstance(tree, dict):
        return {k: params_from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax_numpy(v, device) for v in tree)
    return _tensor(tree, device)


def cache_from_jax_numpy(cache, device=None) -> dict:
    """A dense KV cache dict of the JAX package (llama.init_kv_cache or
    gpt2.init_gpt2_cache) after ``jax.tree.map(np.asarray, cache)``: "k" and
    "v" per layer, with kv_quant "k_scale" and "v_scale". Same keys,
    bit-exact tensors, each a writable copy (the port appends in place)."""
    return params_from_jax_numpy(dict(cache), device)


def paged_cache_from_jax_numpy(cache, device=None) -> dict:
    """The JAX package's paged cache dict after
    ``jax.tree.map(np.asarray, cache)`` ("k_pages", "v_pages", with
    kv_quant "ks_pages" and "vs_pages", and "block_table") as the port's:
    the same keys, bit-exact pools, and an int32 block table."""
    out = params_from_jax_numpy(dict(cache), device)
    out["block_table"] = out["block_table"].to(torch.int32)
    return out
