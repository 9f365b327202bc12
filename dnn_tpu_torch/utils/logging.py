"""Structured logging (port of dnn_tpu/utils/logging.py).

`setup_logging` configures the dnn_tpu_torch logger tree: leveled,
timestamped, with the node id as a prefix. JSON mode (`DNN_TPU_LOG=json`,
or `fmt="json"`): one JSON object per record — ts, level, logger, msg,
node_id and, when the calling thread is inside an active request span,
its trace id (obs/trace.current_span), so a daemon's log lines correlate
with its /trace output.

Unlike JAX's, the tree keeps propagating to the root logger: a host
application's handlers (and pytest's caplog) still see its records. The
node CLI installs no root handler, so a record prints once.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional


class _NodeFilter(logging.Filter):
    def __init__(self, node_id: str):
        super().__init__()
        self.node_id = node_id

    def filter(self, record):
        record.node_id = self.node_id
        return True


class JSONFormatter(logging.Formatter):
    """One JSON object per record, the active span's trace id injected
    when there is one."""

    def format(self, record):
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        node_id = getattr(record, "node_id", None)
        if node_id:
            out["node_id"] = node_id
        try:
            from dnn_tpu_torch.obs.trace import current_span

            sp = current_span()
            if sp is not None and sp.trace_id is not None:
                out["trace_id"] = sp.trace_id
        except Exception:  # noqa: BLE001 — logging must never raise
            pass
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(level: str = "INFO", *, node_id: Optional[str] = None,
                  stream=None, fmt: Optional[str] = None):
    """Configure the dnn_tpu_torch logger tree. `fmt` is "text" (the
    default) or "json"; None reads DNN_TPU_LOG (json|text)."""
    root = logging.getLogger("dnn_tpu_torch")
    root.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    root.handlers.clear()
    handler = logging.StreamHandler(stream or sys.stderr)
    if fmt is None:
        fmt = os.environ.get("DNN_TPU_LOG", "text").lower()
    if fmt == "json":
        handler.setFormatter(JSONFormatter())
    else:
        prefix = "[%(node_id)s] " if node_id else ""
        handler.setFormatter(
            logging.Formatter(
                f"%(asctime)s %(levelname)s %(name)s: {prefix}%(message)s",
                datefmt="%H:%M:%S",
            )
        )
    if node_id:
        handler.addFilter(_NodeFilter(node_id))
    root.addHandler(handler)
    return root
