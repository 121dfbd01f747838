"""PyTorch/CUDA port of infinitensor_tpu for one NVIDIA H100 (sm_90a).

The JAX package beside it is the reference. This package imports neither
jax nor infinitensor_tpu; its kernels are CUDA C++ under kernels/csrc/,
built with nvcc at their first launch (kernels/_build.py), never on
import.

Slices ported so far: Llama-2 INT4/INT8 weight-only prompt -> generate
over a bf16 or an INT8 KV cache (models/llama.py greedy_generate,
llama_prefill, llama_decode_step / llama_decode_multi, llama_verify_step),
and continuous-batching serving over the dense or the paged KV cache
(serving/: ServingEngine, PagedServingEngine, speculative_generate);
the same decode with paired-scale int4 weights (the slab kernels); and
GPT-2 INT8 weight-only serving (models/gpt2.py, models/loader.py,
tools/serving_bench.py); the graph IR (core/: GraphHandler, Graph;
ops/: shape rules and the torch lowering of every op) and its executor
(runtime/executor.py GraphExecutor: eager on the CPU, one captured CUDA
graph per input signature on the card), with the graph-built Llama
(models/graph_llama.py) and the band ops of Longformer attention; the
other models (models/opt.py, bert.py, vision.py, moe.py) and the ONNX
frontend (onnx/: OnnxStub / import_onnx, export_onnx, the wire codec).
"""

from infinitensor_tpu_torch.utils.platform import resolve_device
from infinitensor_tpu_torch.quant.weight_only import (
    INT4_PACK_VERSION, QuantizedLinear, dequantize_weight, quantize_weight,
)
from infinitensor_tpu_torch.models.llama import (
    LlamaConfig, greedy_generate, init_kv_cache, init_llama_params,
    init_paged_kv_cache, llama_decode_multi, llama_decode_step, llama_prefill, llama_verify_step,
    quantize_llama_params,
)
from infinitensor_tpu_torch.models.gpt2 import (
    GPT2Config, gpt2_decode_step, gpt2_prefill, init_gpt2_cache,
    init_gpt2_params, quantize_gpt2_params,
)
from infinitensor_tpu_torch.models.loader import (
    load_bert_params, load_gpt2_params, load_llama_params, load_opt_params,
)
from infinitensor_tpu_torch.models.opt import (
    OPTConfig, init_opt_cache, init_opt_params, opt_decode_step, opt_prefill,
    quantize_opt_params,
)
from infinitensor_tpu_torch.models.bert import (
    BertConfig, bert_encode, build_bert_graph, build_bert_layer_graph,
    init_bert_params,
)
from infinitensor_tpu_torch.models.convert import params_from_jax_numpy
from infinitensor_tpu_torch.serving import (
    ModelDraft, PagedServingEngine, PromptLookupDraft, Request, ServingEngine,
    speculative_generate,
)
from infinitensor_tpu_torch.core import DataType, Graph, GraphHandler
from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.runtime import (
    Runtime, cpu_runtime, cuda_runtime,
)
from infinitensor_tpu_torch.onnx import OnnxStub, export_onnx, import_onnx

__all__ = [
    "resolve_device", "INT4_PACK_VERSION", "QuantizedLinear",
    "dequantize_weight", "quantize_weight", "LlamaConfig", "greedy_generate",
    "init_kv_cache", "init_llama_params", "llama_decode_multi",
    "llama_decode_step", "llama_prefill", "llama_verify_step",
    "quantize_llama_params", "params_from_jax_numpy", "init_paged_kv_cache",
    "ServingEngine", "PagedServingEngine", "Request", "speculative_generate",
    "ModelDraft", "PromptLookupDraft", "GPT2Config", "gpt2_decode_step",
    "gpt2_prefill", "init_gpt2_cache", "init_gpt2_params",
    "quantize_gpt2_params", "load_gpt2_params", "load_llama_params",
    "load_bert_params", "load_opt_params", "OPTConfig", "init_opt_cache",
    "init_opt_params", "opt_decode_step", "opt_prefill",
    "quantize_opt_params", "BertConfig", "bert_encode", "build_bert_graph",
    "build_bert_layer_graph", "init_bert_params", "OnnxStub", "export_onnx",
    "import_onnx",
    "DataType", "Graph", "GraphHandler", "GraphExecutor", "Runtime",
    "cpu_runtime", "cuda_runtime",
]
