"""Structured logging for the port (a host copy of the JAX package's
``utils/log.py``): every module gets a namespaced stdlib logger with one
process-wide configuration point, an opt-in JSON-lines mode for machine
consumption, and an env override (``SL_TPU_LOG=debug``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

ROOT_NAME = "structured_light_for_3d_model_replication_tpu_torch"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def configure(level: str | int | None = None, json_lines: bool = False,
              stream=None) -> None:
    """Configure the framework's root logger (idempotent; call again to
    reconfigure). Level resolution order: arg > $SL_TPU_LOG > INFO."""
    if level is None:
        level = os.environ.get("SL_TPU_LOG", "info")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root = logging.getLogger(ROOT_NAME)
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    if json_lines or os.environ.get("SL_TPU_LOG_JSON"):
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger under the port's root. Handlers are set only by
    :func:`configure` (the command-line entry points call it), so a
    library caller keeps its own logging set-up."""
    if not name.startswith(ROOT_NAME):
        name = f"{ROOT_NAME}.{name}"
    return logging.getLogger(name)
