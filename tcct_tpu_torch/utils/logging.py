"""Structured metric logging (JAX counterpart ``tcct_tpu/utils/logging.py``;
the reference logs through print/tqdm only).  One JSON line per event."""

from __future__ import annotations

import json
import time
from typing import Any


class MetricLogger:
    """Appends one JSON object per :meth:`log` call to ``path``.  A tensor
    or numpy value is read (``.item()``) once, when its line is written."""

    def __init__(self, path: str):
        self.path = path

    def log(self, **kv: Any) -> None:
        kv["t"] = time.time()
        clean = {}
        for k, v in kv.items():
            if hasattr(v, "item"):
                try:
                    v = v.item()
                except (ValueError, RuntimeError):  # more than one element
                    v = str(v)
            clean[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(clean) + "\n")
