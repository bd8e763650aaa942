"""Block-paged KV cache pool (port of ``repro.serve.kv_cache``).

A fixed device-resident pool of fixed-size **blocks** (``block_size`` token
positions each, per layer), a host-side **free list** that hands blocks to
requests and reclaims them on eviction, and per-request **block tables**
mapping logical token positions to physical blocks.

Layout (one pool tensor per K and V):

    k, v: (n_layers, n_blocks, block_size, n_kv_heads, head_dim)

Logical position ``p`` of a request lives at ``pool[layer, table[p // bs],
p % bs]``.  Block 0 is the reserved **trash block**: table rows point their
unallocated tail (and whole rows of inactive micro-batch slots) at it, so
writes need no branching.  Reads are masked by per-slot ``length``, and every
position in ``[prompt_len, length)`` is rewritten by the decode step that
produced it before any read.

Unlike the JAX pool, whose steps return new pool arrays, the port's steps
write into the pool in place: layer ``l`` writes into its view
``pool.k[l]`` (no per-step copy of the whole pool).  :meth:`update` keeps
the JAX API (with its shape check) for callers that hand a pool back.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

# physical block 0 is never allocated: the write target for everything that
# must go nowhere (inactive slots, padded prefill tails past a reservation)
TRASH_BLOCK = 0


@dataclasses.dataclass
class PagedKVCache:
    """One layer's view of the paged pool for one step: the layer's pool
    blocks (written in place), the micro-batch's block table (B, W) int32
    and per-slot lengths (B,) int32, all on the device."""

    k: torch.Tensor            # (n_blocks, block_size, Hkv, Dh)
    v: torch.Tensor            # (n_blocks, block_size, Hkv, Dh)
    block_table: torch.Tensor  # (B, W) int32 physical block ids
    length: torch.Tensor       # (B,) int32 valid prefix per slot

    @property
    def block_size(self) -> int:
        return self.k.shape[-3]


class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation asks for more blocks than the free list
    has."""


class PagedKVPool:
    """Device block pool + host free-list allocator.

    The free list is host state under a lock, so engines sharing one pool
    never race the accounting.  Allocation never hands out a block twice: a
    block is either free, live (owned by exactly one request), or the trash
    block.  The pool lives on the card unless the caller passes
    ``device="cpu"``."""

    def __init__(self, n_layers: int, n_blocks: int, block_size: int,
                 n_kv_heads: int, head_dim: int, *, max_blocks_per_seq: int,
                 dtype=torch.float32, device="cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError("PagedKVPool(device='cuda') needs a CUDA "
                               "device; pass device='cpu' for a pool on "
                               "the CPU")
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved trash)")
        if block_size < 1 or max_blocks_per_seq < 1:
            raise ValueError("block_size and max_blocks_per_seq must be >= 1")
        self.n_layers = n_layers
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        shape = (n_layers, n_blocks, block_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._free: List[int] = list(range(1, n_blocks))  # LIFO reuse
        self._live: set = set()
        self._lock = threading.Lock()
        # seam of the fault injector (serve/faults.py in the JAX package,
        # ported with the fleet): None here
        self.fault_injector = None

    # ---- free-list accounting ---------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` positions."""
        return max(1, -(-n_tokens // self.block_size))

    def try_alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks off the free list, all-or-nothing, or return
        None (the graceful admission primitive: exhaustion is an expected
        serving condition)."""
        with self._lock:
            if n > self.max_blocks_per_seq or n > len(self._free):
                return None
            taken = [self._free.pop() for _ in range(n)]
            for b in taken:
                assert b not in self._live and b != TRASH_BLOCK  # never double
                self._live.add(b)
            return taken

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks off the free list (all-or-nothing); raises
        :class:`BlockPoolExhausted` when the reservation cannot be met."""
        taken = self.try_alloc(n)
        if taken is None:
            if n > self.max_blocks_per_seq:
                raise BlockPoolExhausted(
                    f"request needs {n} blocks > max_blocks_per_seq="
                    f"{self.max_blocks_per_seq}")
            raise BlockPoolExhausted(
                f"need {n} blocks, free list has {len(self._free)} "
                f"({len(self._live)} live)")
        return taken

    def free(self, blocks: Iterable[int]) -> None:
        """Return a request's blocks to the free list (eviction reclaim)."""
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    raise ValueError("cannot free the trash block")
                if b not in self._live:
                    raise ValueError(f"double free / foreign block {b}")
                self._live.discard(b)
                self._free.append(b)

    def table_row(self, blocks: Sequence[int]) -> np.ndarray:
        """A request's block-table row: its blocks, trash-padded to width."""
        row = np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)
        row[: len(blocks)] = np.asarray(blocks, np.int32)
        return row

    def trash_row(self) -> np.ndarray:
        """All-trash row for inactive / padded micro-batch slots."""
        return np.full((self.max_blocks_per_seq,), TRASH_BLOCK, np.int32)

    # ---- cross-pool KV handoff --------------------------------------------
    def transfer_blocks(self, dst: "PagedKVPool", src_blocks: Sequence[int],
                        dst_blocks: Sequence[int]) -> None:
        """Copy block *contents* into another pool (the disaggregated
        prefill->decode handoff): ``dst.pool[:, dst_blocks] =
        src.pool[:, src_blocks]`` for K and V.  The caller owns the
        free-list bookkeeping on both pools."""
        if len(src_blocks) != len(dst_blocks):
            raise ValueError(
                f"block count mismatch: {len(src_blocks)} src vs "
                f"{len(dst_blocks)} dst")
        if (self.k.shape[2:] != dst.k.shape[2:]
                or self.n_layers != dst.n_layers):
            raise ValueError(f"incompatible pool geometry: "
                             f"{tuple(self.k.shape)} vs {tuple(dst.k.shape)}")
        si = torch.as_tensor(list(src_blocks), dtype=torch.long,
                             device=self.k.device)
        di = torch.as_tensor(list(dst_blocks), dtype=torch.long,
                             device=dst.k.device)
        dst.k[:, di] = self.k[:, si].to(dst.k.device)
        dst.v[:, di] = self.v[:, si].to(dst.v.device)

    # ---- pool hand-back -----------------------------------------------------
    def update(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Adopt the pool tensors a step returned (the port's steps return
        the pool they wrote in place, so this is a shape-checked no-op)."""
        if k.shape != self.k.shape or v.shape != self.v.shape:
            raise ValueError(
                f"pool shape changed: {tuple(k.shape)} vs "
                f"{tuple(self.k.shape)}")
        self.k, self.v = k, v
