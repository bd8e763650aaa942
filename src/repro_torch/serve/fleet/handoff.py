"""Paged-KV handoff: how a prefilled request moves to a decode engine (port
of ``repro.serve.fleet.handoff``).

The handoff carries no token data — only the request record (which holds its
block ids and cache ``length``) and the pool the blocks live in.  Delivery
has two regimes:

  * **same pool** (the common case: a cell's prefill and decode engines
    share one :class:`~repro_torch.serve.kv_cache.PagedKVPool`):
    zero-copy — the block table the decode step builds points at the very
    blocks prefill wrote, so "inheriting KV without recomputation" is
    literally a list of ints changing owner;
  * **cross pool** (router spills a handoff to another cell because the
    origin cell's decode slots are full): block-granular device copy via
    :meth:`PagedKVPool.transfer_blocks` into freshly reserved destination
    blocks (a gather and a scatter on the card, no read back to the host),
    then the source blocks are freed — the in-repo analogue of a NIC-side
    paged-KV transfer between disaggregated hosts.

Delivery is all-or-nothing and graceful: if the destination pool cannot
reserve the blocks, the handoff is left untouched (still valid against its
source pool) and ``deliver`` returns False so the router can retry or try
another cell — KV pressure is a scheduling event, never a crash.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.serve.primitives import ScheduledRequest


@dataclasses.dataclass
class KVHandoff:
    """A prefilled request ready for decode: ``req.blocks`` live in
    ``src_pool``, ``req.length`` tokens are written, ``req.next_token`` is
    the first generated token (the decode step's first input)."""

    req: ScheduledRequest
    src_pool: PagedKVPool
    src_cell: int = -1


def deliver(handoff: KVHandoff, dst_pool: PagedKVPool, *,
            injector=None, dst_cell: int = -1) -> bool:
    """Move the handoff's KV state into ``dst_pool``; True on success.

    Same-pool delivery is free.  Cross-pool delivery reserves matching
    blocks in the destination (all-or-nothing), copies contents, frees the
    source blocks, and repoints the request — on reservation failure nothing
    changes and the caller keeps the handoff.  An injected
    ``handoff_transfer_fail`` (serve/faults.py) fails the transfer *before
    any side effect* — the handoff stays valid against its source pool and
    parks for retry, exactly like destination exhaustion."""
    req = handoff.req
    if dst_pool is handoff.src_pool:
        return True
    if injector is not None and injector.transfer_fail(handoff.src_cell,
                                                       dst_cell):
        return False
    dst_blocks = dst_pool.try_alloc(len(req.blocks))
    if dst_blocks is None:
        return False
    handoff.src_pool.transfer_blocks(dst_pool, req.blocks, dst_blocks)
    handoff.src_pool.free(req.blocks)
    req.blocks = dst_blocks
    handoff.src_pool = dst_pool
    return True
