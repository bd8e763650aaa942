"""Data pipeline (port of the synthetic stream of ``repro.data.pipeline``;
numpy, so the port keeps its own copy and the batches are bitwise the JAX
package's).

Synthetic stream — a seeded Zipf-ish LM task with learnable structure (each
token depends on the previous one through a fixed random bigram table), so a
real model shows a real loss curve without external data.  Deterministic in
(seed, step, rank): restart-safe (the checkpoint stores the step; the stream
resumes exactly) and elastic-safe (re-sharding by rank count is pure
arithmetic).  The memory-mapped token files, the host-side prefetcher and
the vision/audio stub inputs are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "synthetic"          # "synthetic" ("memmap": not ported)
    path: Optional[str] = None       # memmap token file (.bin uint32)


class SyntheticLM:
    """Bigram-structured synthetic stream: next ~ table[prev] with noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        self._table = rng.integers(0, v, size=(v,), dtype=np.int64)

    def batch(self, step: int, rank: int = 0, world: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_rank = cfg.global_batch // world
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + rank)
        B, S = per_rank, cfg.seq_len
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=(B,))
        noise = rng.random((B, S)) < 0.15
        rand = rng.integers(0, cfg.vocab, size=(B, S))
        for t in range(1, S):
            nxt = self._table[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_pipeline(cfg: DataConfig):
    if cfg.kind == "memmap":
        raise NotImplementedError(
            "the memory-mapped token pipeline is not ported yet "
            "(ROADMAP.md)")
    if cfg.kind != "synthetic":
        raise ValueError(f"unknown pipeline kind {cfg.kind!r}")
    return SyntheticLM(cfg)
