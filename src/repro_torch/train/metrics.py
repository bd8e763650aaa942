"""Training observability (port of ``repro.train.metrics``): a JSONL
metrics sink and rolling aggregates.

One line per step: loss, grad-norm, lr, step time, tokens/s, and
fault-tolerance events.  The file is append-only and crash-safe (line
granularity); ``load_metrics`` reads it back for analysis.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *,
                 tokens_per_step: int = 0):
        self.path = path
        self.tokens_per_step = tokens_per_step
        self._t_last = time.perf_counter()
        self._window: List[float] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log_step(self, step: int, metrics: Dict[str, Any], **extra):
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        self._window.append(dt)
        self._window = self._window[-64:]
        rec = {"step": step, "t_step_s": round(dt, 4)}
        if self.tokens_per_step:
            rec["tokens_per_s"] = round(self.tokens_per_step / max(dt, 1e-9))
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        rec.update(extra)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def log_event(self, kind: str, **fields):
        rec = {"event": kind, "time": time.time(), **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @property
    def median_step_s(self) -> float:
        return float(np.median(self._window)) if self._window else 0.0


def load_metrics(path: str):
    steps, events = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            (events if "event" in rec else steps).append(rec)
    return steps, events
