"""Graph execution: the executor (eager per-op dispatch, CUDA-graph
capture on the card), the device runtime handle, the per-op timing cache
(PerfEngine) and the host scratch arena (Workspace)."""

from infinitensor_tpu_torch.runtime.executor import GraphExecutor
from infinitensor_tpu_torch.runtime.runtime import (
    Runtime, cpu_runtime, cuda_runtime,
)
from infinitensor_tpu_torch.runtime.perf import PerfEngine
from infinitensor_tpu_torch.runtime.workspace import Workspace

__all__ = ["GraphExecutor", "Runtime", "cpu_runtime", "cuda_runtime",
           "PerfEngine", "Workspace"]
