"""Metrics logging, the counterpart of `kagnn_tpu/utils/logging.py`.

The reference logs via print + append-only text files
(node_classification_clean/utils.py:216-235, graph_classification_utils.py:
142-159). Here: a JSON-lines metric logger (one object per event), plus the
same append-only text convention where drivers want it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    """Append JSON-lines metric events to `<log_dir>/<name>.jsonl`."""

    def __init__(self, log_dir: str, name: str, also_print: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self.also_print = also_print
        self._t0 = time.time()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "t": round(time.time() - self._t0, 3),
               **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        if self.also_print:
            print(json.dumps(rec, default=float), flush=True)

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def count_params(model) -> int:
    """Total parameter count (reference count_params,
    node_classification_clean/utils.py:19-23); buffers such as the KAN
    knots and the BatchNorm statistics are not parameters."""
    return sum(p.numel() for p in model.parameters())
