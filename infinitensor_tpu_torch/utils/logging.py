"""Structured logging (counterpart of infinitensor_tpu/utils/logging.py).

Stdlib loggers with a key=value formatter and one knob, log_level of
utils/config.py (env INFINITPU_LOG: a level name, default WARNING), so
serving deployments get
machine-parseable events without a logging dependency.

    log = get_logger("serving")
    log.info("admit", slot=3, prompt_len=17, pages=5)
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Any

_CONFIGURED = False
_ROOT = "infinitensor_tpu_torch"


class _KVLogger:
    """Thin wrapper: level methods take a message + key=value fields."""

    def __init__(self, logger: logging.Logger):
        self._log = logger

    def _emit(self, level: int, event: str, fields: dict) -> None:
        if not self._log.isEnabledFor(level):
            return
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        self._log.log(level, f"{event} {kv}".rstrip())

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(logging.ERROR, event, fields)


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(_ROOT)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s",
        datefmt="%H:%M:%S"))
    root.addHandler(handler)
    root.propagate = False
    try:
        from infinitensor_tpu_torch.utils.config import config
        root.setLevel(config.log_level.upper())
    except ValueError:
        root.setLevel(logging.WARNING)
    _CONFIGURED = True


def get_logger(name: str) -> _KVLogger:
    _configure()
    return _KVLogger(logging.getLogger(f"{_ROOT}.{name}"))


class Timer:
    """Context timer that logs wall seconds on exit (debug level)."""

    def __init__(self, log: _KVLogger, event: str, **fields: Any):
        self.log, self.event, self.fields = log, event, fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.log.debug(self.event, wall_s=round(
            time.perf_counter() - self._t0, 4), **self.fields)
