"""PerfEngine: persistent per-op timing cache (counterpart of
infinitensor_tpu/runtime/perf.py).

Mirrors the reference PerfEngine (include/core/perf_engine.h:8-51,
src/core/perf_engine.cc:7-22): a map (workload key) -> time ms with JSON
save/load. Used as the cost model for the graph optimizer's beam search
(getPerfTime without execution).

Copy of the JAX package's module: the JSON format and ``_key_str`` are
the same byte for byte, so a file saved by either package loads in the
other and ``Operator.workload_key()`` names the same entries. A key
carries no device: an engine filled on the CPU must not score graphs
for the card (make a fresh ``PerfEngine()`` there).
"""

from __future__ import annotations

import json
import os
from typing import Optional


def _key_str(key) -> str:
    return json.dumps(key, default=str, sort_keys=True)


class PerfEngine:
    _instance: Optional["PerfEngine"] = None

    def __init__(self):
        self._records: dict[str, float] = {}

    @classmethod
    def instance(cls) -> "PerfEngine":
        if cls._instance is None:
            cls._instance = PerfEngine()
        return cls._instance

    def get(self, workload_key, default: Optional[float] = None) -> Optional[float]:
        return self._records.get(_key_str(workload_key), default)

    def set(self, workload_key, record) -> None:
        """record: a time in ms (float) or any JSON-able PerfRecord payload
        (reference PerfRecord carries time + algorithm choice,
        include/core/perf_engine.h:8-51)."""
        if isinstance(record, (int, float)):
            record = float(record)
        self._records[_key_str(workload_key)] = record

    def __len__(self) -> int:
        return len(self._records)

    def graph_time_ms(self, graph, executor=None) -> float:
        """Cost-model estimate: sum of cached per-op times; ops missing from
        the cache are timed on demand (reference RuntimeObj::getPerfTime,
        src/core/runtime.cc:66-128)."""
        missing = [op for op in graph.operators
                   if self.get(op.workload_key()) is None]
        if missing and executor is not None:
            executor.profile(perf_engine=self)
        total = 0.0
        for op in graph.operators:
            t = self.get(op.workload_key())
            total += t if t is not None else 0.0
        return total

    # persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self._records, f, indent=1)

    def load(self, path: str) -> None:
        if os.path.exists(path):
            with open(path) as f:
                self._records.update(json.load(f))
