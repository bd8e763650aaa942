"""Continuous-batching request scheduler with per-request precision modes
(port of ``repro.serve.scheduler``).

  * **continuous batching** — requests join the decode batch the tick they
    arrive (admission queue -> free slot) and leave the tick they finish
    (EOS / token budget);
  * **paged KV memory** — slots borrow fixed-size blocks from a shared
    :class:`~repro_torch.serve.kv_cache.PagedKVPool` on the engine's device
    and return them on eviction;
  * **per-request precision (QoS)** — each request carries its own mode or
    policy, resolved through
    :func:`repro_torch.core.context.resolve_request_policy`; every tick runs
    ONE decode launch for all static-format requests, a partitioned-lane
    launch when their formats differ (``core/lanes.py``).

Token semantics match the static path: the first output token is the argmax
of the prefill logits at the last prompt position; each decode step
consumes the previous token and emits the next.  Batch rows are independent
through the whole network (every kernel and every reduction on the decode
path computes a row the same way whatever the micro-batch width), and paged
reads are length-masked, so a request's token stream is bit-identical
whether it runs solo or continuously scheduled while neighbours join and
leave.

Lifecycle: requests may carry a ``deadline_ticks`` TTL, may be canceled
mid-flight (:meth:`ContinuousScheduler.cancel`), and every decode step runs
the numerical guardrail — a slot whose logits go non-finite (or past the
configured bound) is evicted alone and re-queued at the front escalated one
precision mode up, its generated prefix re-prefilled.

Not ported yet: fault injection (``install_faults``; ``serve/faults.py``
comes with the fleet, ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import torch

from repro_torch.serve import primitives as prim
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import BlockPoolExhausted, PagedKVPool
from repro_torch.serve.primitives import (  # re-export  # noqa: F401
    GuardrailConfig,
    ScheduledRequest,
)


class ContinuousScheduler:
    """Admission queue + slot map + per-tick join/evict over a ServeEngine.

    The engine contributes the paged prefill / decode steps (one pair per
    resolved policy, one mixed decode step per lane envelope) and the
    pre-limbed decode weights; the scheduler owns all host state: the
    request queue, the slot map, the block free list and the per-tick
    plan.  Prompts pad to power-of-two length buckets and decode
    micro-batches to power-of-two widths, as in the JAX package."""

    def __init__(self, engine: ServeEngine, *, n_blocks: int = 64,
                 block_size: int = 16,
                 max_blocks_per_seq: Optional[int] = None,
                 guard: Optional[GuardrailConfig] = None):
        cfg = engine.cfg
        if cfg.family != "dense" or cfg.mla is not None:
            raise NotImplementedError(
                "continuous scheduling supports dense GQA models only")
        self.engine = engine
        if max_blocks_per_seq is None:
            max_blocks_per_seq = max(1, -(-engine.max_seq // block_size))
        self.pool = PagedKVPool(
            cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
            cfg.resolved_head_dim, max_blocks_per_seq=max_blocks_per_seq,
            dtype=torch.float32, device=engine.device)
        self.max_slots = engine.max_batch
        self._slots: List[Optional[ScheduledRequest]] = [None] * self.max_slots
        self._queue: Deque[ScheduledRequest] = deque()
        self._requests: Dict[int, ScheduledRequest] = {}  # rid -> live req
        self.completed: List[ScheduledRequest] = []
        self.expired: List[ScheduledRequest] = []
        self.canceled: List[ScheduledRequest] = []
        self.guard = guard or GuardrailConfig()
        self.injector = None        # fault seam: stays None in the port
        self.steps = 0              # decode ticks executed (virtual clock)
        self.prefills = 0
        self.decode_token_slots = 0  # useful (non-padded) decode lanes used
        self.useful_tokens = 0
        self.submitted = 0
        self.guard_trip_events = 0
        self.escalation_events = 0
        self.decode_launches = 0    # decode launches issued
        self.decode_ticks = 0       # ticks that ran >= 1 decode launch

    def install_faults(self, plan_or_injector):
        """Fault injection is not ported yet: ``serve/faults.py`` comes with
        the fleet (ROADMAP.md Queue 1 item 6)."""
        raise NotImplementedError(
            "install_faults: serve/faults.py is not ported yet; it comes "
            "with the fleet, ROADMAP.md Queue 1 item 6 'Fleet and chaos "
            "serving'")

    # ---- admission ---------------------------------------------------------
    def submit(self, req: ScheduledRequest) -> None:
        if req.state != "queued":
            raise ValueError(f"request {req.rid} already {req.state}")
        prim.validate_request(self.pool, req)
        prim.resolve_request(req, self.engine.policy)  # resolve + cache once
        if req.t_submit < 0:
            req.t_submit = time.perf_counter()
        req.submitted_tick = self.steps
        self._requests[req.rid] = req
        self.submitted += 1
        self._queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._slots):
            if r is None:
                return i
        return None

    def _admit(self) -> int:
        """Join-on-arrival: move queued requests into free slots while both
        a slot and the request's full block reservation are available (FIFO,
        no head-of-line skipping).  Exhaustion requeues instead of raising;
        ``run()`` still raises for a request the pool can never satisfy.

        A *resumed* request (non-empty ``req.out``: the guardrail evicted it)
        re-prefills its generated prefix; the prefill's token is discarded
        and decode resumes consuming ``out[-1]``."""
        admitted = 0
        while self._queue:
            req = self._queue[0]
            slot = self._free_slot()
            if slot is None:
                break
            if not prim.try_reserve(self.pool, req):
                break  # reservation not available yet; eviction will free it
            self._queue.popleft()
            req.slot = slot
            req.state = "running"
            req.admitted_step = self.steps
            self._slots[slot] = req
            resumed = bool(req.out)
            tok = prim.prefill_request(self.engine, self.pool, req)
            self.prefills += 1
            if resumed:
                req.next_token = req.out[-1]
            else:
                self._push_token(req, tok)
            admitted += 1
        return admitted

    # ---- decode ------------------------------------------------------------
    def _push_token(self, req: ScheduledRequest, tok: int) -> None:
        req.out.append(tok)
        req.next_token = tok
        self.useful_tokens += 1
        if len(req.out) >= req.max_new or tok == req.eos_token:
            self._evict(req, "done", self.completed)

    def _evict(self, req: ScheduledRequest, state: str,
               into: List[ScheduledRequest]) -> None:
        """Evict a slot (EOS / budget / expiry / cancel): blocks back to the
        free list, slot released; the surviving slots' state is untouched,
        so their token streams are unaffected (bit-identical, tested)."""
        prim.release(self.pool, req)
        self._slots[req.slot] = None
        req.slot = None
        self._retire(req, state, into)

    def _retire(self, req: ScheduledRequest, state: str,
                into: List[ScheduledRequest]) -> None:
        req.state = state
        req.done_step = self.steps
        req.t_done = time.perf_counter()
        self._requests.pop(req.rid, None)
        into.append(req)

    def _trip(self, req: ScheduledRequest) -> None:
        """Guardrail eviction: poisoned token discarded, blocks freed,
        request re-queued at the *front* escalated one mode up (its
        generated prefix re-prefills on re-admission)."""
        prim.release(self.pool, req)
        self._slots[req.slot] = None
        req.slot = None
        req.guard_trips += 1
        self.guard_trip_events += 1
        if req.guard_trips > self.guard.max_trips_per_request:
            raise RuntimeError(
                f"request {req.rid} tripped the numerical guardrail "
                f"{req.guard_trips} times (mode={req.mode!r}); "
                f"escalation ladder exhausted")
        if prim.escalate_mode(req):
            self.escalation_events += 1
            prim.resolve_request(req, self.engine.policy)  # re-resolve
        req.state = "queued"
        if req.out:
            req.next_token = req.out[-1]
        req.recovery_prefixes.append(len(req.out))
        self._queue.appendleft(req)

    def _sweep_deadlines(self) -> None:
        """Expire TTL'd requests in the queue and the slot map (blocks
        reclaimed the same tick, accounted under ``expired``)."""
        if not any(r.deadline_ticks is not None
                   for r in self._requests.values()):
            return
        for req in [r for r in self._queue
                    if prim.deadline_expired(r, self.steps)]:
            self._queue.remove(req)
            self._retire(req, "expired", self.expired)
        for req in [r for r in self._slots
                    if r is not None and prim.deadline_expired(r, self.steps)]:
            self._evict(req, "expired", self.expired)

    def cancel(self, rid: int) -> bool:
        """Cancel a request whether queued or decoding (its blocks are
        reclaimed this tick).  Unknown / finished ids return False."""
        req = self._requests.get(rid)
        if req is None:
            return False
        if req in self._queue:
            self._queue.remove(req)
            self._retire(req, "canceled", self.canceled)
            return True
        if req.slot is not None and self._slots[req.slot] is req:
            self._evict(req, "canceled", self.canceled)
            return True
        return False

    def step(self) -> bool:
        """One scheduler tick: expire deadlines, admit arrivals, then run
        the tick's decode plan (guardrail verdicts folded into each step —
        a tripped slot is evicted alone and escalated).

        The plan buckets by shape, not by format: every static-format
        request rides ONE launch per tick, a homogeneous set on the
        per-policy step, a heterogeneous set on the partitioned-lane mixed
        step.  Only AUTO-policy requests would bucket per policy.  Returns
        True if any work was done."""
        self._sweep_deadlines()
        admitted = self._admit()
        active = [r for r in self._slots if r is not None]
        plan = prim.decode_tick_plan(active, self.engine.policy)
        cap = prim.pow2_at_most(self.max_slots)
        for kind, reqs in plan:
            step_fn = (prim.decode_mixed_step if kind == "mixed"
                       else prim.decode_bucket_step)
            toks, ok = step_fn(
                self.engine, self.pool, reqs, max_slots=self.max_slots,
                guard=self.guard, injector=self.injector, cell_id=0)
            self.decode_launches += -(-len(reqs) // cap)
            self.decode_token_slots += len(reqs)
            for req, tok, good in zip(list(reqs), toks, ok):
                if good:
                    self._push_token(req, int(tok))
                else:
                    self._trip(req)
        if plan:
            self.decode_ticks += 1
            self.steps += 1
        return bool(admitted or plan)

    # ---- drivers -----------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def run(self, requests: Optional[Sequence[ScheduledRequest]] = None
            ) -> List[ScheduledRequest]:
        """Drive to completion.  ``requests`` may carry virtual ``arrival``
        ticks: a request is submitted once the decode clock reaches its
        arrival tick."""
        pending = deque(sorted(requests or [],
                               key=lambda r: (r.arrival, r.rid)))
        while pending or self._queue or self.n_active:
            while pending and pending[0].arrival <= self.steps:
                self.submit(pending.popleft())
            if not self.step():
                if self._queue and not self.n_active and not pending:
                    head = self._queue[0]
                    raise BlockPoolExhausted(
                        f"request {head.rid} needs "
                        f"{prim.blocks_needed(self.pool, head)} "
                        f"blocks but the pool can never satisfy it "
                        f"(free={self.pool.n_free}, "
                        f"max_blocks_per_seq={self.pool.max_blocks_per_seq})")
                if pending:
                    # idle tick: advance the virtual clock to the next arrival
                    self.steps = max(self.steps + 1, pending[0].arrival)
        return self.completed

    def stats(self) -> Dict[str, float]:
        """Occupancy / accounting counters, the engine's cache counters and
        per-request latency percentiles (TTFT / TPOT / ITL / queue-wait
        p50/p95, :func:`repro_torch.serve.primitives.latency_stats`)."""
        occ = (self.decode_token_slots / (self.steps * self.max_slots)
               if self.steps else 0.0)
        out = {"steps": self.steps, "prefills": self.prefills,
               "useful_tokens": self.useful_tokens,
               "submitted": self.submitted,
               "completed": len(self.completed),
               "expired": len(self.expired),
               "canceled": len(self.canceled),
               "guard_trips": self.guard_trip_events,
               "escalations": self.escalation_events,
               "slot_occupancy": round(occ, 4),
               "blocks_free": self.pool.n_free,
               "blocks_live": self.pool.n_live,
               "decode_launches": self.decode_launches,
               "launches_per_tick": round(
                   self.decode_launches / self.decode_ticks, 4)
               if self.decode_ticks else 0.0}
        out.update(self.engine.cache_stats())
        out.update(prim.latency_stats(self.completed))
        return out
