"""Structured logging with request-id correlation.

Reference: ``model_gateway/src/observability/logging.rs`` (structured JSON logs
with request correlation, SURVEY.md §5).  We use stdlib logging with an
optional JSON formatter and a contextvar carrying the current request id.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time

request_id_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "smg_request_id", default=None
)

_CONFIGURED = False


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        rid = request_id_var.get()
        if rid:
            out["request_id"] = rid
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


class TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        rid = request_id_var.get()
        prefix = f"[{rid}] " if rid else ""
        base = f"{self.formatTime(record, '%H:%M:%S')} {record.levelname:<7} {record.name}: {prefix}{record.getMessage()}"
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def configure(level: str | None = None, json_logs: bool | None = None) -> None:
    global _CONFIGURED
    level = level or os.environ.get("SMG_LOG_LEVEL", "INFO")
    if json_logs is None:
        json_logs = os.environ.get("SMG_LOG_JSON", "0") == "1"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonFormatter() if json_logs else TextFormatter())
    root = logging.getLogger("smg_tpu_torch")
    root.handlers[:] = [handler]
    root.setLevel(level.upper())
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    if not _CONFIGURED:
        configure()
    if not name.startswith("smg_tpu_torch"):
        name = f"smg_tpu_torch.{name}"
    return logging.getLogger(name)
