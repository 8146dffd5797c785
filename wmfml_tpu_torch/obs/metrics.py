"""Scalar metrics sink: ``metrics.jsonl`` in the run directory.

The same streams as the JAX package (``Loss/train``, ``Loss/validation``,
``Loss/test``), one JSON object per line, appended as it is written (a few
lines per validation, so no file is held open). TensorBoard is not written.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def add_scalar(self, tag: str, value, step: int):
        line = json.dumps({"tag": tag, "value": float(value),
                           "step": int(step), "time": time.time()})
        with open(self.path, "a") as f:
            f.write(line + "\n")
