"""Data pipeline (port of ``repro.data.pipeline``; numpy, so the port keeps
its own copy and the batches are bitwise the JAX package's): deterministic
synthetic token streams and memory-mapped token files, sharded per
data-parallel rank, with a host-side prefetch thread.

Synthetic stream — a seeded Zipf-ish LM task with learnable structure (each
token depends on the previous one through a fixed random bigram table), so a
real model shows a real loss curve without external data.  Deterministic in
(seed, step, rank): restart-safe (the checkpoint stores the step; the stream
resumes exactly) and elastic-safe (re-sharding by rank count is pure
arithmetic).  The vision and audio families' stub inputs (``frontend``)
come from the same generator, after the tokens.
"""
from __future__ import annotations

import dataclasses
import queue as queue_lib
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "synthetic"          # "synthetic" | "memmap"
    path: Optional[str] = None       # memmap token file (.bin uint32)
    frontend: str = "none"           # vision/audio stub embeds
    d_model: int = 0
    n_patches: int = 0


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
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "audio":
            out = {"embeds": rng.standard_normal(
                       (B, S - 1, cfg.d_model)).astype(np.float32),
                   "labels": out["labels"]}
        elif cfg.frontend == "vision":
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return out


class MemmapLM:
    """Token file pipeline: flat uint32 tokens, strided per (step, rank)."""

    def __init__(self, cfg: DataConfig):
        if not cfg.path:
            raise ValueError("the memmap pipeline needs a path")
        self.cfg = cfg
        self._data = np.memmap(cfg.path, dtype=np.uint32, mode="r")

    def batch(self, step: int, rank: int = 0, world: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_rank = cfg.global_batch // world
        S = cfg.seq_len
        n_windows = (len(self._data) - 1) // S
        base = (step * cfg.global_batch + rank * per_rank) % max(
            1, n_windows - per_rank)
        rows = []
        for i in range(per_rank):
            off = ((base + i) % n_windows) * S
            rows.append(np.asarray(self._data[off: off + S + 1],
                                   dtype=np.int64))
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_pipeline(cfg: DataConfig):
    if cfg.kind == "memmap":
        return MemmapLM(cfg)
    if cfg.kind != "synthetic":
        raise ValueError(f"unknown pipeline kind {cfg.kind!r}")
    return SyntheticLM(cfg)


class Prefetcher:
    """Host-side background prefetch: a thread assembles the batches of
    steps ``start_step, start_step + 1, ...`` into a queue of ``depth``
    while the device computes.  Iterating yields ``(step, batch)``; an
    exception in the thread is raised by the next ``next()``.  ``close()``
    stops the thread and waits for it."""

    def __init__(self, pipeline, start_step: int = 0, depth: int = 2,
                 rank: int = 0, world: int = 1):
        self._pipe = pipeline
        self._q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
        self._step = start_step
        self._rank, self._world = rank, world
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro_torch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._pipe.batch(step, self._rank, self._world)
            except Exception as err:  # noqa: BLE001 — raised in next()
                self._put(err)
                return
            if not self._put((step, batch)):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
