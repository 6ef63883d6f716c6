"""Metrics sink: ``metrics.jsonl`` in the log directory.

Counterpart of ``wavenet_tpu/utils/summaries.py``, writing the same
scalar records (one JSON object per line: tag, value, step, ts). The
JAX package also writes TensorBoard event files when TensorFlow is
importable, and parameter histograms; the port writes neither yet.
"""

from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                           buffering=1)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")

    def close(self) -> None:
        self._jsonl.close()
