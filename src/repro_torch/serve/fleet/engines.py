"""Disaggregated prefill/decode engines and the cell that pairs them (port
of ``repro.serve.fleet.engines``).

One :class:`~repro_torch.serve.engine.ServeEngine` is shared by *every*
engine in the fleet — its paged step closures and pre-limbed decode weights
are keyed by policy, not pool identity, so N cells share one set of weights
on the card.  What a cell owns is **state**: its own
:class:`~repro_torch.serve.kv_cache.PagedKVPool` on the engine's device,
plus the two loops over it —

  * :class:`PrefillEngine` — a paced queue of admitted (block-reserved)
    requests; each tick it prefills at most ``max_prefills_per_tick`` of
    them (B=1 bucketed prefill via
    :func:`repro_torch.serve.primitives.prefill_request`) and emits
    :class:`~repro_torch.serve.fleet.handoff.KVHandoff` records.  The pacing is
    the disaggregation lever: prefill is the long-pole launch, so bounding
    prefills per tick bounds the inter-token latency spikes decode slots
    see (the interference the fleet benchmark measures);
  * :class:`DecodeEngine` — a slot map over the cell pool; accepts handoffs
    into free slots (zero-copy from its own prefill engine, block-copy from
    another cell's) and runs one shape-bucketed decode tick
    (:func:`repro_torch.serve.primitives.decode_tick_plan`): static-format
    slots share ONE launch regardless of mode mix — heterogeneous sets take
    the partitioned-lane
    :func:`repro_torch.serve.primitives.decode_mixed_step`, homogeneous sets
    :func:`repro_torch.serve.primitives.decode_bucket_step`.

Pool discipline: the device tensors are single-writer — the router steps
each cell's engines serially on one stream, so at most one step writes a
pool at a time; only the host free list is lock-guarded.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Tuple

import torch

from repro_torch.serve import primitives as prim
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import CellCrashed, FaultInjector
from repro_torch.serve.fleet.handoff import KVHandoff, deliver
from repro_torch.serve.kv_cache import PagedKVPool
from repro_torch.serve.primitives import GuardrailConfig, ScheduledRequest


class PrefillEngine:
    """Paced prefill loop over a cell's pool.

    Requests arrive *already block-reserved* (the router calls
    :meth:`try_admit`, which runs the graceful all-or-nothing reservation),
    so a queued request can never stall on KV mid-prefill.
    ``max_prefills_per_tick=0`` means unpaced (greedy, the interleaved
    single-engine discipline); ``1`` is the disaggregated default."""

    def __init__(self, engine: ServeEngine, pool: PagedKVPool, *,
                 cell_id: int = 0, max_prefills_per_tick: int = 1):
        self.engine = engine
        self.pool = pool
        self.cell_id = cell_id
        self.max_prefills_per_tick = max_prefills_per_tick
        self.queue: Deque[ScheduledRequest] = deque()
        self.prefills = 0

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def try_admit(self, req: ScheduledRequest) -> bool:
        """Reserve the request's full block budget and enqueue it; False
        (nothing reserved, nothing enqueued) when the pool cannot supply the
        blocks right now — the router requeues with backoff."""
        if not prim.try_reserve(self.pool, req):
            return False
        req.state = "running"
        self.queue.append(req)
        return True

    def step(self) -> Tuple[List[KVHandoff], List[ScheduledRequest]]:
        """Prefill up to ``max_prefills_per_tick`` queued requests.  Returns
        (handoffs ready for a decode engine, requests already complete after
        their first token — max_new=1 or instant EOS — with blocks freed).

        A *recovery* request (non-empty ``req.out``: it lost its cell or
        tripped the guardrail mid-stream) re-prefills its generated prefix
        instead — the emitted history is immutable, so the prefill's output
        token is discarded and decode resumes from ``out[-1]``.

        When a prefill raises, the request and those this step already
        prefilled go back to the queue's front before the error leaves, so
        the router's drain of the cell recovers them."""
        handoffs: List[KVHandoff] = []
        completed: List[ScheduledRequest] = []
        budget = self.max_prefills_per_tick or len(self.queue)
        for _ in range(min(budget, len(self.queue))):
            req = self.queue.popleft()
            resumed = bool(req.out)
            try:
                tok = prim.prefill_request(self.engine, self.pool, req)
            except Exception:
                self.requeue_front([h.req for h in handoffs] + completed
                                   + [req])
                raise
            self.prefills += 1
            if not resumed:
                req.out.append(tok)
                req.next_token = tok
            if len(req.out) >= req.max_new or req.out[-1] == req.eos_token:
                prim.release(self.pool, req)
                req.state = "done"
                completed.append(req)
            else:
                handoffs.append(KVHandoff(req=req, src_pool=self.pool,
                                          src_cell=self.cell_id))
        return handoffs, completed

    def requeue_front(self, reqs: List[ScheduledRequest]) -> None:
        """Put requests back at the queue's front, in their order."""
        for req in reversed(reqs):
            self.queue.appendleft(req)


class DecodeEngine:
    """Slot-mapped decode loop over a cell's pool (the decode half of the
    single-engine scheduler, minus admission — that moved to the router)."""

    def __init__(self, engine: ServeEngine, pool: PagedKVPool, *,
                 cell_id: int = 0, max_slots: Optional[int] = None,
                 guard: Optional[GuardrailConfig] = None):
        self.engine = engine
        self.pool = pool
        self.cell_id = cell_id
        self.max_slots = max_slots or engine.max_batch
        self._slots: List[Optional[ScheduledRequest]] = [None] * self.max_slots
        self.steps = 0
        self.decode_token_slots = 0
        self.decode_launches = 0
        self.guard = guard or GuardrailConfig()
        self.injector: Optional[FaultInjector] = None  # chaos seam
        self.guard_trips = 0

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def n_free_slots(self) -> int:
        return self.max_slots - self.n_active

    @property
    def kv_pressure(self) -> float:
        """Fraction of the cell pool's allocatable blocks currently live —
        the least_kv balancing signal."""
        return self.pool.n_live / max(1, self.pool.n_blocks - 1)

    def accept(self, handoff: KVHandoff) -> bool:
        """Take a prefilled request into a free slot, delivering its KV
        state into this engine's pool (zero-copy when the handoff originated
        here; block copy from a foreign pool).  False — with the handoff
        untouched — when no slot is free or the pool cannot host the
        blocks."""
        slot = next((i for i, r in enumerate(self._slots) if r is None), None)
        if slot is None:
            return False
        if not deliver(handoff, self.pool, injector=self.injector,
                       dst_cell=self.cell_id):
            return False
        req = handoff.req
        req.slot = slot
        req.engine_id = self.cell_id
        self._slots[slot] = req
        return True

    def step(self) -> Tuple[List[ScheduledRequest], List[ScheduledRequest]]:
        """One decode tick over the tick's decode plan, evicting finished
        requests (blocks freed, slot cleared).  The plan is shape-bucketed:
        every static-format request rides ONE launch per tick regardless of
        the cell's mode mix (heterogeneous sets take the partitioned-lane
        mixed step; only AUTO policies still bucket per policy).  Returns
        ``(completed, tripped)``: requests that finished this tick, and
        requests the numerical guardrail evicted (poisoned logits — their
        bad token is discarded, their blocks are freed, and the router
        re-admits them escalated one mode up)."""
        active = [r for r in self._slots if r is not None]
        completed: List[ScheduledRequest] = []
        tripped: List[ScheduledRequest] = []
        plan = prim.decode_tick_plan(active, self.engine.policy)
        cap = prim.pow2_at_most(self.max_slots)
        for kind, reqs in plan:
            step_fn = (prim.decode_mixed_step if kind == "mixed"
                       else prim.decode_bucket_step)
            toks, ok = step_fn(
                self.engine, self.pool, reqs, max_slots=self.max_slots,
                guard=self.guard, injector=self.injector,
                cell_id=self.cell_id)
            self.decode_launches += -(-len(reqs) // cap)
            self.decode_token_slots += len(reqs)
            for req, tok, good in zip(list(reqs), toks, ok):
                if not good:
                    # evict ONLY the poisoned slot; survivors in the same
                    # bucket keep streaming untouched
                    prim.release(self.pool, req)
                    self._slots[req.slot] = None
                    req.slot = None
                    req.guard_trips += 1
                    self.guard_trips += 1
                    tripped.append(req)
                    continue
                tok = int(tok)
                req.out.append(tok)
                req.next_token = tok
                if len(req.out) >= req.max_new or tok == req.eos_token:
                    prim.release(self.pool, req)
                    self._slots[req.slot] = None
                    req.slot = None
                    req.state = "done"
                    completed.append(req)
        if plan:
            self.steps += 1
        return completed, tripped


class FleetCell:
    """One engine replica: a pool plus its prefill and decode engines.

    ``disaggregate=True`` paces prefill (``max_prefills_per_tick=1``) so
    decode ticks are never starved behind a prefill burst;
    ``disaggregate=False`` reproduces the interleaved single-engine
    discipline (greedy prefill) inside the same fleet plumbing — the
    benchmark's like-for-like interference baseline."""

    def __init__(self, engine: ServeEngine, *, cell_id: int,
                 n_blocks: int = 64, block_size: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 disaggregate: bool = True,
                 guard: Optional[GuardrailConfig] = None):
        cfg = engine.cfg
        if cfg.family not in ("dense",) or cfg.mla is not None:
            raise NotImplementedError(
                "fleet serving supports dense GQA models only")
        if max_blocks_per_seq is None:
            max_blocks_per_seq = max(1, -(-engine.max_seq // block_size))
        self.cell_id = cell_id
        self.pool = PagedKVPool(
            cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
            cfg.resolved_head_dim, max_blocks_per_seq=max_blocks_per_seq,
            dtype=torch.float32, device=engine.device)
        self.prefill = PrefillEngine(
            engine, self.pool, cell_id=cell_id,
            max_prefills_per_tick=1 if disaggregate else 0)
        self.decode = DecodeEngine(engine, self.pool, cell_id=cell_id,
                                   guard=guard)
        self.injector: Optional[FaultInjector] = None

    @property
    def load(self) -> int:
        """Queued + active requests — the queue-depth balancing signal."""
        return self.prefill.queue_depth + self.decode.n_active

    def install_faults(self, injector: Optional[FaultInjector]) -> None:
        """Wire one injector through every chaos seam this cell owns (decode
        step wrapper, handoff delivery, pool block transfer)."""
        self.injector = injector
        self.decode.injector = injector
        self.pool.fault_injector = injector

    def tick(self, tick: int) -> Tuple[List[KVHandoff],
                                       List[ScheduledRequest],
                                       List[ScheduledRequest],
                                       List[ScheduledRequest], float]:
        """One cell tick: fault checks, then the paced prefill step and one
        decode step.  Returns ``(handoffs, instant_completions,
        decode_completions, guard_tripped, injected_delay_s)``.

        Raises :class:`~repro_torch.serve.faults.CellCrashed` when the
        installed plan schedules this cell's death — the router catches it,
        marks the cell dead, and recovers every in-flight request from its
        host-visible prefix.  When a step raises, the requests the tick
        prefilled go back to the front of the prefill queue first, so the
        router's drain recovers them (the JAX cell drops them)."""
        delay = 0.0
        if self.injector is not None:
            if self.injector.cell_crash(self.cell_id):
                raise CellCrashed(self.cell_id)
            delay = self.injector.straggler_delay(self.cell_id)
        handoffs, instant = self.prefill.step()
        try:
            completed, tripped = self.decode.step()
        except Exception:
            # the requests this tick prefilled would leave with the raised
            # tick: back to the queue's front, where the router's drain of
            # this cell recovers them with the rest
            self.prefill.requeue_front([h.req for h in handoffs] + instant)
            raise
        return handoffs, instant, completed, tripped, delay


def make_fleet(engine: ServeEngine, n_cells: int, *, n_blocks: int = 64,
               block_size: int = 16,
               max_blocks_per_seq: Optional[int] = None,
               disaggregate: bool = True,
               guard: Optional[GuardrailConfig] = None) -> List[FleetCell]:
    """N identical cells over ONE shared ServeEngine: same step closures,
    same pre-limbed weights, N independent pools on the engine's device.
    Identical pool geometry is what makes every cross-cell block transfer
    geometry-compatible."""
    if n_cells < 1:
        raise ValueError("need at least one cell")
    return [FleetCell(engine, cell_id=i, n_blocks=n_blocks,
                      block_size=block_size,
                      max_blocks_per_seq=max_blocks_per_seq,
                      disaggregate=disaggregate, guard=guard)
            for i in range(n_cells)]
