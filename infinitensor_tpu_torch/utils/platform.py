"""Device resolution for the PyTorch/CUDA port.

Counterpart of infinitensor_tpu/utils/platform.py:16-48. The JAX package
detects a TPU and otherwise falls back to the jnp path (or the Pallas
interpreter); the port has no interpret mode and no escape hatch: entry
points run on the CUDA card, and take the CPU only when the caller asks
for it (the tests do, to run the kernels' plain PyTorch versions).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    None -> the current CUDA device, raising when there is none; "cpu"
    -> the CPU (plain PyTorch versions of every kernel); "cuda[:n]" ->
    that card, raising when CUDA is unavailable. Never falls back quietly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "not available")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
