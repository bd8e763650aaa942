"""Assigned input-shape cells and per-arch applicability rules (port of
``repro.configs.shapes``).

  train_4k      seq=4096   global_batch=256   lowers train_step
  prefill_32k   seq=32768  global_batch=32    lowers prefill_step
  decode_32k    seq=32768  global_batch=128   lowers serve_step (1 new token)
  long_500k     seq=524288 global_batch=1     lowers serve_step

Skips (recorded, per spec): ``long_500k`` needs sub-quadratic attention —
runs only for the SSM/hybrid family; encoder-only archs have no decode step.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def applicability(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped)."""
    s = SHAPES[shape_name]
    if s.phase == "decode" and cfg.encoder_only:
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention (skip per spec)")
    return True, ""


def runnable_cells(cfg: ModelConfig) -> List[str]:
    return [n for n in SHAPE_ORDER if applicability(cfg, n)[0]]
