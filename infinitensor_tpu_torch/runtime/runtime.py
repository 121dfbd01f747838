"""Device runtimes (counterpart of infinitensor_tpu/runtime/runtime.py).

Thin analog of the reference's RuntimeObj hierarchy (reference
include/core/runtime.h:38-136): streams, the caching allocator and kernel
dispatch are PyTorch's, so a Runtime here is a device handle + executor
factory; the communicator comes with the parallelism modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from infinitensor_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class Runtime:
    platform: str                     # "cuda" | "cpu"
    device_index: int = 0

    @property
    def device(self) -> torch.device:
        """The torch.device; a "cuda" runtime raises where CUDA is
        unavailable (resolve_device)."""
        if self.platform == "cpu":
            return resolve_device("cpu")
        if self.platform != "cuda":
            raise ValueError(f"unsupported platform {self.platform!r}: "
                             "'cuda' or 'cpu'")
        return resolve_device(f"cuda:{self.device_index}")

    def is_cpu(self) -> bool:
        return self.platform == "cpu"

    def executor(self, graph, **kwargs):
        from infinitensor_tpu_torch.runtime.executor import GraphExecutor
        return GraphExecutor(graph, device=self.device, **kwargs)

    def run(self, graph, inputs=None, **kwargs):
        return self.executor(graph).run(inputs, **kwargs)

    def init_comm(self, name: str, world_size: int, rank: int,
                  coordinator: Optional[str] = None) -> None:
        """Multi-process bootstrap (reference initComm,
        src/cuda/cuda_runtime.cc:495): torch.distributed over NCCL, not
        ported yet."""
        raise NotImplementedError(
            "init_comm: the process group comes with the parallelism "
            "modules (ROADMAP.md Queue 1 item 14)")


def cpu_runtime() -> Runtime:
    return Runtime("cpu")


def cuda_runtime(device_index: int = 0) -> Runtime:
    return Runtime("cuda", device_index)


def default_runtime() -> Runtime:
    """The card: the port's entry points run there unless the caller asks
    for the CPU (cpu_runtime())."""
    return Runtime("cuda", torch.cuda.current_device()
                   if torch.cuda.is_available() else 0)
