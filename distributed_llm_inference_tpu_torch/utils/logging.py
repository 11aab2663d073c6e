"""Structured JSON-lines logging (a copy of the JAX package's
utils/logging.py, under this package's logger namespace).

Every log record is one JSON object on stderr with arbitrary structured
fields:

    log = get_logger("engine")
    log.info("request", model="tinyllama-1.1b", tokens=20, ttft_s=0.01)
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import sys
from typing import Any, Optional

_ROOT = "distributed_llm_inference_tpu_torch"

# Current request / W3C trace id: set around a request's processing so
# every record logged inside carries them with no plumbing.
_REQUEST_ID: contextvars.ContextVar = contextvars.ContextVar(
    "request_id", default=None
)
_TRACE_ID: contextvars.ContextVar = contextvars.ContextVar(
    "trace_id", default=None
)


def get_request_id() -> Optional[str]:
    return _REQUEST_ID.get()


@contextlib.contextmanager
def request_id_context(rid: Optional[str], trace_id: Optional[str] = None):
    token = _REQUEST_ID.set(rid)
    t_token = _TRACE_ID.set(trace_id) if trace_id is not None else None
    try:
        yield
    finally:
        if t_token is not None:
            _TRACE_ID.reset(t_token)
        _REQUEST_ID.reset(token)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        rid = _REQUEST_ID.get()
        if rid is not None:
            out["request_id"] = rid
        tid = _TRACE_ID.get()
        if tid is not None:
            out["trace_id"] = tid
        fields = getattr(record, "fields", None)
        if fields:
            out.update(fields)  # an explicit request_id field wins
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class StructuredLogger:
    """Thin wrapper adding **fields kwargs to the stdlib logger."""

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def _log(self, level: int, event: str, exc_info=None, **fields: Any):
        if self._logger.isEnabledFor(level):
            self._logger.log(level, event, extra={"fields": fields}, exc_info=exc_info)

    def debug(self, event: str, **fields):
        self._log(logging.DEBUG, event, **fields)

    def info(self, event: str, **fields):
        self._log(logging.INFO, event, **fields)

    def warning(self, event: str, **fields):
        self._log(logging.WARNING, event, **fields)

    def error(self, event: str, exc_info=None, **fields):
        self._log(logging.ERROR, event, exc_info=exc_info, **fields)


def configure(level: int = logging.INFO, stream=None) -> None:
    """Install the JSON handler on the package root logger, once; the
    level applies on every call."""
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if any(isinstance(h.formatter, _JsonFormatter) for h in root.handlers):
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(_JsonFormatter())
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> StructuredLogger:
    """Library-safe: installs no handler — records propagate to the host
    application's logging config. Entry points (the server CLI) call
    configure() for the JSON-lines handler."""
    return StructuredLogger(logging.getLogger(f"{_ROOT}.{name}"))
