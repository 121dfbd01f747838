"""Central runtime configuration (counterpart of
infinitensor_tpu/utils/config.py).

One typed registry backs both programmatic overrides and `INFINITPU_*`
environment variables, read from the same variables as in the JAX
package, so every knob is discoverable in one place (`config.snapshot()`).
The port carries the knobs it reads: `executable_cache_capacity` (the
executor's capture LRU), the memory planner's two (`naive_allocator`,
`validate_memory`, read by native/planner.py) and `log_level`.
`pallas_interpret` has no counterpart: the
port has no interpret mode, and a CPU tensor always takes a kernel's plain
version.

Usage:
    from infinitensor_tpu_torch.utils.config import config
    config.executable_cache_capacity          # typed read (env-aware)
    config.set(executable_cache_capacity=4)   # programmatic override
    with config.override(log_level="DEBUG"):
        ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class _Knob:
    name: str
    env: str
    default: Any
    type: type
    doc: str


_KNOBS = [
    _Knob("executable_cache_capacity", "INFINITPU_EXEC_CACHE", 16, int,
          "LRU capacity of GraphExecutor's captured-CUDA-graph cache "
          "(reference CUDA-Graph capture cache capacity)."),
    _Knob("naive_allocator", "INFINITPU_NAIVE_ALLOC", False, bool,
          "Memory planner gives every activation its own region (no "
          "reuse) — the reference's allocator debug mode "
          "(graph.cc:371-380)."),
    _Knob("validate_memory", "INFINITPU_VALIDATE_MEMORY", False, bool,
          "Cross-check planned offsets against liveness after planning "
          "(reference validateMemory, graph.cc:605-622)."),
    _Knob("log_level", "INFINITPU_LOG", "WARNING", str,
          "Log level for infinitensor_tpu_torch structured logs."),
]


def _parse(knob: _Knob, raw: str):
    if knob.type is bool:
        return raw.strip().lower() not in ("", "0", "false", "no", "off")
    return knob.type(raw)


class Config:
    def __init__(self):
        self._knobs = {k.name: k for k in _KNOBS}
        self._overrides: dict[str, Any] = {}

    def __getattr__(self, name: str):
        knobs = object.__getattribute__(self, "_knobs")
        if name not in knobs:
            raise AttributeError(name)
        overrides = object.__getattribute__(self, "_overrides")
        if name in overrides:
            return overrides[name]
        knob = knobs[name]
        raw = os.environ.get(knob.env)
        return knob.default if raw is None else _parse(knob, raw)

    def set(self, **kw) -> None:
        for name, value in kw.items():
            if name not in self._knobs:
                raise KeyError(f"unknown config knob {name!r}; "
                               f"have {sorted(self._knobs)}")
            self._overrides[name] = value

    def unset(self, *names: str) -> None:
        for name in names:
            self._overrides.pop(name, None)

    @contextlib.contextmanager
    def override(self, **kw):
        prev = dict(self._overrides)
        try:
            self.set(**kw)
            yield self
        finally:
            self._overrides = prev

    def snapshot(self) -> dict:
        """Every knob with its effective value + provenance."""
        out = {}
        for name, knob in self._knobs.items():
            src = ("override" if name in self._overrides
                   else "env" if knob.env in os.environ else "default")
            out[name] = {"value": getattr(self, name), "source": src,
                         "env": knob.env, "doc": knob.doc}
        return out


config = Config()
