"""PyTorch/CUDA port of infinitensor_tpu for one NVIDIA H100 (sm_90a).

The JAX package beside it is the reference. This package imports neither
jax nor infinitensor_tpu; its kernels are CUDA C++ under kernels/csrc/,
built with nvcc at their first launch (kernels/_build.py), never on
import.

Slice ported so far: Llama-2 INT4 weight-only + INT8-KV greedy decode
(models/llama.py llama_decode_step / llama_decode_multi).
"""

from infinitensor_tpu_torch.utils.platform import resolve_device
from infinitensor_tpu_torch.quant.weight_only import (
    INT4_PACK_VERSION, QuantizedLinear, dequantize_weight, quantize_weight,
)
from infinitensor_tpu_torch.models.llama import (
    LlamaConfig, init_kv_cache, init_llama_params, llama_decode_multi,
    llama_decode_step, quantize_llama_params,
)
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy

__all__ = [
    "resolve_device", "INT4_PACK_VERSION", "QuantizedLinear",
    "dequantize_weight", "quantize_weight", "LlamaConfig", "init_kv_cache",
    "init_llama_params", "llama_decode_multi", "llama_decode_step",
    "quantize_llama_params", "params_from_jax_numpy",
]
