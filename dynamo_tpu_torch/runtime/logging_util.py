"""Structured logging setup (a copy of dynamo_tpu/runtime/logging_util.py).

``DYN_LOG_LEVEL`` sets the level, ``DYN_LOG_JSONL=1`` switches to one-JSON-
object-per-line output for log shippers. Request ids propagate via the
``extra={"request_id": ...}`` convention.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        for key in ("request_id", "instance_id", "model"):
            val = getattr(record, key, None)
            if val is not None:
                entry[key] = val
        return json.dumps(entry)


def setup_logging(level: str | None = None, jsonl: bool | None = None) -> None:
    level = level or os.environ.get("DYN_LOG_LEVEL", "INFO")
    if jsonl is None:
        jsonl = os.environ.get("DYN_LOG_JSONL", "") in ("1", "true")
    handler = logging.StreamHandler(sys.stderr)
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s %(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level.upper())
