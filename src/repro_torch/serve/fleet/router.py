"""Mode-aware fleet router: admission control, load balancing, fan-out,
cell health, and failure recovery (port of ``repro.serve.fleet.router``).

The router is the fleet's only control loop — the follow-up IP-core paper's
reservation-station shape (many requesters -> one shared reconfigurable
datapath -> tagged results back to requesters) lifted to engine replicas:

  * **admission** — a backlog ordered by (retry_at, submit order); per-mode
    in-flight caps bound how much of the fleet any one QoS class can hold
    (an M23 flood cannot starve M8 latency traffic);
  * **placement** — ``round_robin`` (ignore state, spread arrivals),
    ``least_kv`` (most free blocks first: KV-pressure balancing),
    ``mode_affinity`` (each mode pins to a home cell, so a cell's decode
    tick is one policy bucket — fuller micro-batches, fewer launches);
  * **graceful degradation** — a placement that fails (KV pressure, caps)
    requeues with exponential backoff ``base * 2^(requeues-1)`` instead of
    raising; after ``downgrade_after`` requeues a mode-tagged request is
    downgraded one step (M23 -> M16 -> M8) — the paper's run-time
    reconfiguration applied as a load-shedding policy, recorded on the
    request (``downgraded_from``), never silent;
  * **handoff routing** — prefilled requests go to their origin cell's
    decode engine (zero-copy); if its slots are full, to the least-loaded
    other cell (cross-pool block copy); if nowhere fits, the handoff waits
    in a retry queue — its blocks stay valid in the origin pool;
  * **fan-out** — completions land in per-submitter queues
    (``completions[submitter]``), the tagged-result return path.

Failure model (DESIGN.md §10).  Each cell carries a health state machine

    healthy -> degraded -> quarantined -> dead

driven by a per-tick latency EWMA (straggler detection: a tick slower than
``straggler_factor`` x the cell's own EWMA trips it) and exception/fault
counters (a crash — injected via serve/faults.py or a real exception out of
the cell tick — jumps straight to quarantined or dead).  Degraded cells are
deprioritized among placement *fallbacks* (the policy's primary choice is
untouched, so mode pinning survives a wobble); quarantined cells take no new
work and sit out a probation window; dead cells are permanent.

**Recovery, not loss**: when a cell dies or is quarantine-drained, every
in-flight victim — prefill queue, decode slots, parked handoffs whose KV
lives in that cell's pool — is reconstructed from its host-visible prefix
(prompt + tokens already streamed to the submitter), its blocks are returned
to the owning pool's free list (no leak, even on a dead pool), and it is
re-admitted at backlog-front priority to re-prefill on a healthy cell.
Because decode is greedy and batch rows are independent, a recovered
request's remaining tokens are bit-identical to a resumed solo run of its
prefix (same re-prefix-then-decode computation) — the chaos soak's gate.
They are *not* guaranteed to match the never-crashed timeline bit-for-bit:
re-prefilled positions carry prefill-built K/V where the original had
decode-built K/V, a low-bit difference that can flip a tight greedy argmax.

**Numerical guardrail**: a decode slot whose logits go non-finite (or past
the sentinel bound) is evicted alone and re-admitted *escalated* one mode up
(M8 -> M16 -> M23, ``escalated_from``) — the inverse dial of the pressure
downgrade, and the recovery path the ROADMAP's speculative verify/escalate
controller plugs into.

Determinism: with a fixed arrival trace the router is a pure function of its
inputs — ticks are a virtual clock, ties break on submit order, every engine
step is serialized, and health latency samples are virtual (1.0 + injected
straggler delay) unless ``wallclock_health`` is set — so fleet runs are
replayable and the KV-handoff bit-parity tests can compare whole token
streams even through injected faults.

A real exception out of a cell tick quarantines the cell and re-places its
work, as in the JAX package, with one exception on the card: a CUDA error
(a kernel that failed to launch or faulted) leaves the device context
unusable, so it ends the run instead of being recorded on the cell.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.serve import primitives as prim
from repro_torch.serve.faults import CellCrashed, FaultInjector, FaultPlan
from repro_torch.serve.fleet.engines import FleetCell
from repro_torch.serve.fleet.handoff import KVHandoff
from repro_torch.serve.kv_cache import BlockPoolExhausted
from repro_torch.serve.primitives import GuardrailConfig, ScheduledRequest

ROUTER_POLICIES = ("round_robin", "least_kv", "mode_affinity")

# one-step QoS downgrade under sustained admission pressure (the guardrail's
# escalation dial is the inverse: primitives.ESCALATE_CHAIN)
DOWNGRADE_CHAIN = {"M23": "M16", "M16": "M8"}

HEALTH_STATES = ("healthy", "degraded", "quarantined", "dead")
_HEALTH_RANK = {"healthy": 0, "degraded": 1}


class CellHealth:
    """Per-cell health: latency EWMA straggler detector + fault counters.

    Latency samples are virtual by default (1.0 per tick + any injected
    straggler delay) so health transitions are deterministic under test;
    production drivers pass wall-clock durations instead.  The EWMA is the
    cell's own baseline, so "straggler" means *slower than itself*, which
    survives heterogeneous hardware."""

    def __init__(self, *, ewma_alpha: float = 0.25,
                 straggler_factor: float = 8.0, min_samples: int = 4,
                 degrade_after: int = 1, quarantine_after: int = 4,
                 errors_to_kill: int = 3, probation_ticks: int = 16):
        self.state = "healthy"
        self.ewma: Optional[float] = None
        self.samples = 0
        self.straggler_events = 0        # since the last state reset
        self.total_straggler_events = 0  # lifetime (stats/accounting)
        self.errors = 0
        self.guard_trips = 0
        self.probation = 0
        self.last_error: Optional[str] = None
        self.ewma_alpha = ewma_alpha
        self.straggler_factor = straggler_factor
        self.min_samples = min_samples
        self.degrade_after = degrade_after
        self.quarantine_after = quarantine_after
        self.errors_to_kill = errors_to_kill
        self.probation_ticks = probation_ticks

    @property
    def placeable(self) -> bool:
        return self.state in ("healthy", "degraded")

    @property
    def rank(self) -> int:
        """Fallback-ordering tier (healthy before degraded)."""
        return _HEALTH_RANK.get(self.state, 2)

    def observe_latency(self, dt: float) -> bool:
        """Fold one tick latency into the EWMA; True when it trips the
        straggler detector (only judged once a baseline exists).  Tripping
        samples are *excluded* from the baseline — otherwise one spike
        inflates the EWMA enough to mask the next one, and a consistently
        slow cell would grade itself healthy."""
        trip = (self.ewma is not None and self.samples >= self.min_samples
                and dt > self.straggler_factor * self.ewma)
        if trip:
            self.straggler_events += 1
            self.total_straggler_events += 1
        else:
            self.ewma = dt if self.ewma is None else (
                self.ewma_alpha * dt + (1.0 - self.ewma_alpha) * self.ewma)
        self.samples += 1
        return trip


class FleetRouter:
    """Routes :class:`ScheduledRequest` streams over a list of
    :class:`FleetCell` replicas.  See the module docstring for the state
    machine; :meth:`run` drives a virtual-clock arrival trace to completion,
    :meth:`step` is one tick for external drivers."""

    def __init__(self, cells: Sequence[FleetCell], *,
                 policy: str = "round_robin",
                 backoff_base: int = 1,
                 admission_caps: Optional[Dict[str, int]] = None,
                 downgrade_after: Optional[int] = None,
                 max_idle_ticks: int = 64,
                 guard: Optional[GuardrailConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 health_kwargs: Optional[Dict] = None,
                 wallclock_health: bool = False):
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r}; have {ROUTER_POLICIES}")
        if not cells:
            raise ValueError("need at least one cell")
        if backoff_base < 1:
            raise ValueError("backoff_base must be >= 1")
        self.cells = list(cells)
        self.policy = policy
        self.backoff_base = backoff_base
        self.admission_caps = dict(admission_caps or {})
        self.downgrade_after = downgrade_after
        self.max_idle_ticks = max_idle_ticks
        self.guard = guard or GuardrailConfig()
        self.wallclock_health = wallclock_health
        self.health: Dict[int, CellHealth] = {
            c.cell_id: CellHealth(**(health_kwargs or {}))
            for c in self.cells}
        for c in self.cells:
            c.decode.guard = self.guard
        self.injector: Optional[FaultInjector] = None
        if fault_plan is not None:
            self.install_faults(fault_plan)
        self.tick = 0
        self._order = 0
        # recovery re-admissions sort before every normal submission at the
        # same retry tick (backlog-front priority) via a negative order band
        self._front_order = -(1 << 30)
        # backlog entries: (retry_at, submit_order, request) — the order
        # field is unique, so heap comparison never reaches the request
        self._backlog: List[Tuple[int, int, ScheduledRequest]] = []
        self._pending_handoffs: Deque[KVHandoff] = deque()
        self._rr = 0
        self._mode_home: Dict[str, int] = {}
        self._inflight: Dict[str, int] = defaultdict(int)
        self._admit_key: Dict[int, str] = {}
        self._requests: Dict[int, ScheduledRequest] = {}  # rid -> live req
        self.completions: Dict[str, Deque[ScheduledRequest]] = \
            defaultdict(deque)
        self.completed: List[ScheduledRequest] = []
        self.expired: List[ScheduledRequest] = []
        self.canceled: List[ScheduledRequest] = []
        self.submitted = 0
        self.useful_tokens = 0
        self.requeue_events = 0
        self.downgrade_events = 0
        self.escalation_events = 0
        self.guard_trip_events = 0
        self.recovered_requests = 0
        self.cell_deaths = 0
        self.recovery_latencies: List[int] = []

    # ---- fault installation ------------------------------------------------
    def install_faults(self, plan_or_injector) -> FaultInjector:
        """Install a fault plan (or a prebuilt injector) and thread it
        through every seam: cell ticks, decode step wrappers, handoff
        delivery, and pool block transfers."""
        inj = (plan_or_injector
               if isinstance(plan_or_injector, FaultInjector)
               else FaultInjector(plan_or_injector))
        self.injector = inj
        for cell in self.cells:
            cell.install_faults(inj)
        return inj

    # ---- submission --------------------------------------------------------
    def submit(self, req: ScheduledRequest) -> None:
        if req.state != "queued":
            raise ValueError(f"request {req.rid} already {req.state}")
        pool = next((c.pool for c in self.cells
                     if self.health[c.cell_id].state != "dead"),
                    self.cells[0].pool)
        prim.validate_request(pool, req)
        if req.t_submit < 0:
            req.t_submit = time.perf_counter()
        req.submitted_tick = self.tick
        self._requests[req.rid] = req
        self.submitted += 1
        heapq.heappush(self._backlog, (self.tick, self._order, req))
        self._order += 1

    # ---- placement ---------------------------------------------------------
    def _live_cells(self) -> List[FleetCell]:
        return [c for c in self.cells if self.health[c.cell_id].placeable]

    def _pick_cells(self, req: ScheduledRequest) -> List[FleetCell]:
        """Candidate cells, preferred first.  Every policy returns the full
        placeable list (primary choice + pressure fallbacks) so one hot cell
        degrades placement quality, not availability.  Health shapes only
        the fallback ordering (healthy tier before degraded) — the policy's
        primary pick stands unless its cell is quarantined or dead."""
        live = self._live_cells()
        if not live:
            return []
        rank = lambda c: self.health[c.cell_id].rank  # noqa: E731
        if self.policy == "round_robin":
            start = self._rr
            self._rr = (self._rr + 1) % len(live)
            rotated = [live[(start + i) % len(live)]
                       for i in range(len(live))]
            return rotated[:1] + sorted(rotated[1:], key=lambda c: (
                rank(c), rotated.index(c)))
        if self.policy == "least_kv":
            return sorted(
                live,
                key=lambda c: (rank(c), -c.pool.n_free, c.load, c.cell_id))
        # mode_affinity: first-seen modes claim home cells in rotation; a
        # dead home is remapped permanently, a quarantined one spills
        # temporarily (the mapping survives probation)
        key = _mode_key(req)
        home = self._mode_home.setdefault(
            key, len(self._mode_home) % len(self.cells))
        if self.health[self.cells[home].cell_id].state == "dead":
            home = self._mode_home[key] = min(
                live, key=lambda c: c.cell_id).cell_id
        head = ([self.cells[home]]
                if self.health[self.cells[home].cell_id].placeable else [])
        rest = sorted((c for c in live if c.cell_id != home),
                      key=lambda c: (rank(c), -c.pool.n_free, c.load,
                                     c.cell_id))
        return head + rest

    def _try_place(self, req: ScheduledRequest) -> bool:
        key = _mode_key(req)
        cap = self.admission_caps.get(key)
        if cap is not None and self._inflight[key] >= cap:
            return False
        for cell in self._pick_cells(req):
            if cell.prefill.try_admit(req):
                req.admitted_step = self.tick
                self._inflight[key] += 1
                self._admit_key[req.rid] = key
                if req.lost_tick >= 0:
                    self.recovery_latencies.append(self.tick - req.lost_tick)
                    req.lost_tick = -1
                    self.recovered_requests += 1
                return True
        return False

    def _requeue(self, req: ScheduledRequest) -> None:
        req.requeues += 1
        self.requeue_events += 1
        if (self.downgrade_after is not None
                and req.requeues >= self.downgrade_after
                and req.policy is None):
            cur = _mode_key(req)
            nxt = DOWNGRADE_CHAIN.get(cur)
            if nxt is not None:
                if req.downgraded_from is None:
                    req.downgraded_from = cur
                req.mode = nxt
                req.resolved_policy = None  # re-resolve at the new mode
                self.downgrade_events += 1
        delay = self.backoff_base * (2 ** min(req.requeues - 1, 6))
        heapq.heappush(self._backlog,
                       (self.tick + delay, self._order, req))
        self._order += 1

    def _place_handoff(self, h: KVHandoff) -> bool:
        """Origin cell first (zero-copy), then other placeable cells by free
        decode slots (cross-pool block copy)."""
        origin = self.cells[h.src_cell] if 0 <= h.src_cell < len(self.cells) \
            else self.cells[0]
        live = self._live_cells()
        others = sorted((c for c in live if c is not origin),
                        key=lambda c: (self.health[c.cell_id].rank,
                                       -c.decode.n_free_slots,
                                       -c.pool.n_free, c.cell_id))
        head = [origin] if self.health[origin.cell_id].placeable else []
        for cell in head + others:
            if cell.decode.accept(h):
                return True
        return False

    # ---- retirement (the four ways a request leaves the router) -----------
    def _retire(self, req: ScheduledRequest, state: str,
                into: List[ScheduledRequest]) -> None:
        req.state = state
        req.done_step = self.tick
        req.t_done = time.perf_counter()
        key = self._admit_key.pop(req.rid, None)
        if key is not None:
            self._inflight[key] -= 1
        self._requests.pop(req.rid, None)
        into.append(req)
        self.completions[req.submitter].append(req)

    def _finish(self, req: ScheduledRequest) -> None:
        self.useful_tokens += len(req.out)
        self._retire(req, "done", self.completed)

    def _expire(self, req: ScheduledRequest) -> None:
        self._retire(req, "expired", self.expired)

    def _cancel(self, req: ScheduledRequest) -> None:
        self._retire(req, "canceled", self.canceled)

    # ---- recovery ----------------------------------------------------------
    def _readmit(self, req: ScheduledRequest) -> None:
        """Backlog-front re-admission of an in-flight victim: the request
        keeps its emitted tokens (the host-visible prefix a healthy cell
        will re-prefill) and sorts before every normal arrival at this
        tick."""
        key = self._admit_key.pop(req.rid, None)
        if key is not None:
            self._inflight[key] -= 1
        req.state = "queued"
        req.slot = None
        req.lost_tick = self.tick
        if req.out:
            req.next_token = req.out[-1]
        req.recoveries += 1
        req.recovery_prefixes.append(len(req.out))
        heapq.heappush(self._backlog, (self.tick, self._front_order, req))
        self._front_order += 1

    def _drain_cell(self, cell: FleetCell) -> int:
        """Recover every in-flight request a cell holds: prefill queue,
        decode slots, and parked handoffs whose KV lives in its pool.
        Blocks go back to the owning pool's free list (no leak even when
        the pool is dead — a dead free list is simply never drawn again)."""
        victims: List[ScheduledRequest] = []
        while cell.prefill.queue:
            victims.append(cell.prefill.queue.popleft())
        for i, req in enumerate(cell.decode._slots):
            if req is not None:
                victims.append(req)
                cell.decode._slots[i] = None
        keep: Deque[KVHandoff] = deque()
        for h in self._pending_handoffs:
            if h.src_pool is cell.pool:
                victims.append(h.req)
            else:
                keep.append(h)
        self._pending_handoffs = keep
        for req in victims:
            prim.release(cell.pool, req)
            self._readmit(req)
        return len(victims)

    def _kill_cell(self, cell: FleetCell, reason: str) -> None:
        h = self.health[cell.cell_id]
        if h.state == "dead":
            return
        h.state = "dead"
        h.last_error = reason
        self.cell_deaths += 1
        self._drain_cell(cell)
        if not self._live_cells() and not any(
                self.health[c.cell_id].state == "quarantined"
                for c in self.cells):
            raise BlockPoolExhausted(
                f"every fleet cell is dead (last: cell {cell.cell_id}, "
                f"{reason}); nothing can serve the backlog")

    def _quarantine_cell(self, cell: FleetCell, reason: str) -> None:
        h = self.health[cell.cell_id]
        if h.state in ("quarantined", "dead"):
            return
        h.state = "quarantined"
        h.probation = h.probation_ticks
        h.last_error = reason
        self._drain_cell(cell)

    def _cell_error(self, cell: FleetCell, err: Exception) -> None:
        """A real exception escaped a cell tick: count it, quarantine the
        cell (drain + probation), kill it when errors persist.  The error
        is recorded on the health record, never swallowed silently."""
        h = self.health[cell.cell_id]
        h.errors += 1
        if h.errors >= h.errors_to_kill:
            self._kill_cell(cell, f"{type(err).__name__}: {err}")
        else:
            self._quarantine_cell(cell, f"{type(err).__name__}: {err}")

    def _handle_guard_trip(self, req: ScheduledRequest, cell: FleetCell
                           ) -> None:
        """Numerical guardrail eviction: escalate one mode up when the
        ladder allows, then re-admit at backlog-front priority.  A request
        that keeps tripping past the configured cap is a model bug — fail
        loudly rather than cycling forever."""
        self.guard_trip_events += 1
        self.health[cell.cell_id].guard_trips += 1
        if req.guard_trips > self.guard.max_trips_per_request:
            raise RuntimeError(
                f"request {req.rid} tripped the numerical guardrail "
                f"{req.guard_trips} times (mode={req.mode!r}); "
                f"escalation ladder exhausted")
        if prim.escalate_mode(req):
            self.escalation_events += 1
        self._readmit(req)

    # ---- deadlines and cancellation ---------------------------------------
    def _sweep_deadlines(self) -> None:
        """Expire TTL'd requests wherever they sit: backlog, prefill
        queues, decode slots, parked handoffs — blocks reclaimed same
        tick."""
        if not any(r.deadline_ticks is not None
                   for r in self._requests.values()):
            return
        live = [e for e in self._backlog
                if not prim.deadline_expired(e[2], self.tick)]
        if len(live) != len(self._backlog):
            for _, _, req in self._backlog:
                if prim.deadline_expired(req, self.tick):
                    self._expire(req)
            self._backlog = live
            heapq.heapify(self._backlog)
        keep: Deque[KVHandoff] = deque()
        for h in self._pending_handoffs:
            if prim.deadline_expired(h.req, self.tick):
                prim.release(h.src_pool, h.req)
                self._expire(h.req)
            else:
                keep.append(h)
        self._pending_handoffs = keep
        for cell in self.cells:
            for req in [r for r in cell.prefill.queue
                        if prim.deadline_expired(r, self.tick)]:
                cell.prefill.queue.remove(req)
                prim.release(cell.pool, req)
                self._expire(req)
            for i, req in enumerate(cell.decode._slots):
                if req is not None and prim.deadline_expired(req, self.tick):
                    prim.release(cell.pool, req)
                    cell.decode._slots[i] = None
                    req.slot = None
                    self._expire(req)

    def cancel(self, rid: int) -> bool:
        """Cancel a request wherever it sits — queued (backlog), prefilling
        (cell queue, blocks reserved), or decoding (slot) — reclaiming its
        blocks this tick.  Unknown / already-finished ids are a no-op
        returning False, never a KeyError."""
        req = self._requests.get(rid)
        if req is None:
            return False
        entry = next((e for e in self._backlog if e[2] is req), None)
        if entry is not None:
            self._backlog.remove(entry)
            heapq.heapify(self._backlog)
            self._cancel(req)
            return True
        for h in list(self._pending_handoffs):
            if h.req is req:
                self._pending_handoffs.remove(h)
                prim.release(h.src_pool, req)
                self._cancel(req)
                return True
        for cell in self.cells:
            if req in cell.prefill.queue:
                cell.prefill.queue.remove(req)
                prim.release(cell.pool, req)
                self._cancel(req)
                return True
            if req.slot is not None \
                    and cell.decode._slots[req.slot] is req:
                prim.release(cell.pool, req)
                cell.decode._slots[req.slot] = None
                req.slot = None
                self._cancel(req)
                return True
        return False

    # ---- the tick ----------------------------------------------------------
    def step(self) -> bool:
        """One fleet tick: expire deadlines, drain due backlog into cells,
        retry parked handoffs, then step every live cell (serially — the
        single-writer-per-pool discipline), folding its latency into the
        health EWMA and recovering from any crash.  Returns True if any
        work was done."""
        if self.injector is not None:
            self.injector.begin_tick(self.tick)
        self._sweep_deadlines()
        progressed = False
        due: List[Tuple[int, int, ScheduledRequest]] = []
        while self._backlog and self._backlog[0][0] <= self.tick:
            due.append(heapq.heappop(self._backlog))
        for _, _, req in due:
            if self._try_place(req):
                progressed = True
            else:
                self._requeue(req)
        for _ in range(len(self._pending_handoffs)):
            h = self._pending_handoffs.popleft()
            if self._place_handoff(h):
                progressed = True
            else:
                self._pending_handoffs.append(h)
        for cell in self.cells:
            health = self.health[cell.cell_id]
            if health.state == "dead":
                continue
            if health.state == "quarantined":
                health.probation -= 1
                if health.probation <= 0:
                    health.state = "degraded"
                    health.straggler_events = 0
                progressed = True  # probation is progress toward service
                continue
            t0 = time.perf_counter()
            try:
                handoffs, instant, completed, tripped, delay = \
                    cell.tick(self.tick)
            except CellCrashed:
                self._kill_cell(cell, "crash")
                progressed = True
                continue
            except Exception as err:  # noqa: BLE001 — survive, record, recover
                if _device_fault(err):
                    raise
                self._cell_error(cell, err)
                progressed = True
                continue
            progressed = progressed or bool(handoffs or instant or completed
                                            or tripped)
            for req in instant:
                self._finish(req)
            for h in handoffs:
                if not self._place_handoff(h):
                    self._pending_handoffs.append(h)
            if cell.decode.n_active:
                progressed = True
            for req in completed:
                self._finish(req)
            for req in tripped:
                self._handle_guard_trip(req, cell)
            # health transitions come AFTER the tick's outputs are routed —
            # a quarantine triggered by this very tick must not drop the
            # handoffs/completions the tick already produced
            sample = delay + (time.perf_counter() - t0
                              if self.wallclock_health else 1.0)
            if health.observe_latency(sample):
                if health.straggler_events >= health.quarantine_after:
                    self._quarantine_cell(cell, "straggler")
                elif (health.state == "healthy"
                      and health.straggler_events >= health.degrade_after):
                    health.state = "degraded"
        self.tick += 1
        return progressed

    # ---- drivers -----------------------------------------------------------
    @property
    def n_inflight(self) -> int:
        return (len(self._pending_handoffs)
                + sum(c.load for c in self.cells))

    def run(self, requests: Optional[Sequence[ScheduledRequest]] = None
            ) -> List[ScheduledRequest]:
        """Drive an arrival trace (virtual ``arrival`` ticks) to completion.
        Idle ticks fast-forward the clock to the next arrival or backoff
        expiry; sustained no-progress with work outstanding (every pool too
        fragmented for the backlog head, no decode active to free blocks)
        raises rather than spinning forever."""
        pending = deque(sorted(requests or [],
                               key=lambda r: (r.arrival, r.rid)))
        idle = 0
        while pending or self._backlog or self.n_inflight:
            while pending and pending[0].arrival <= self.tick:
                self.submit(pending.popleft())
            if self.step():
                idle = 0
                continue
            horizons = []
            if pending:
                horizons.append(pending[0].arrival)
            if self._backlog:
                horizons.append(self._backlog[0][0])
            if horizons:
                jump = min(horizons)
                if jump > self.tick:
                    self.tick = jump
                    idle = 0
                    continue
            idle += 1
            if idle > self.max_idle_ticks:
                raise BlockPoolExhausted(
                    f"fleet made no progress for {idle} ticks: "
                    f"backlog={len(self._backlog)}, "
                    f"pending_handoffs={len(self._pending_handoffs)}, "
                    f"free blocks per cell="
                    f"{[c.pool.n_free for c in self.cells]}")
        return self.completed

    def drain(self, submitter: str = "default") -> List[ScheduledRequest]:
        """Pop this submitter's finished requests (tagged fan-out) —
        completed, expired, and canceled alike; the ``state`` field says
        which."""
        q = self.completions[submitter]
        out = list(q)
        q.clear()
        return out

    def stats(self) -> Dict[str, float]:
        """Fleet-aggregate accounting + pooled latency percentiles (same
        keys as ``ContinuousScheduler.stats()`` so the two compare),
        plus the failure-model counters the chaos gate reads."""
        steps = sum(c.decode.steps for c in self.cells)
        slots = sum(c.decode.decode_token_slots for c in self.cells)
        cap = sum(c.decode.steps * c.decode.max_slots for c in self.cells)
        rec = sorted(self.recovery_latencies)
        out = {"ticks": self.tick, "cells": len(self.cells),
               "steps": steps,
               "prefills": sum(c.prefill.prefills for c in self.cells),
               "useful_tokens": self.useful_tokens,
               "submitted": self.submitted,
               "completed": len(self.completed),
               "expired": len(self.expired),
               "canceled": len(self.canceled),
               "slot_occupancy": round(slots / cap, 4) if cap else 0.0,
               "blocks_free": sum(c.pool.n_free for c in self.cells),
               "blocks_live": sum(c.pool.n_live for c in self.cells),
               "requeues": self.requeue_events,
               "downgrades": self.downgrade_events,
               "escalations": self.escalation_events,
               "guard_trips": self.guard_trip_events,
               "recovered_requests": self.recovered_requests,
               "cell_deaths": self.cell_deaths,
               "straggler_events": sum(h.total_straggler_events
                                       for h in self.health.values()),
               "cell_states": {cid: h.state
                               for cid, h in sorted(self.health.items())},
               "recovery_latency_p95_ticks":
                   float(rec[max(0, int(len(rec) * 0.95) - 1)]) if rec
                   else 0.0,
               "pending_handoffs": len(self._pending_handoffs)}
        if self.injector is not None:
            out.update(self.injector.stats())
        out.update(prim.latency_stats(self.completed))
        return out


def _mode_key(req: ScheduledRequest) -> str:
    """Admission/affinity bucket for a request's QoS class.  Full-policy
    requests bucket together ('policy'): they are rare, never downgraded,
    and affinity only needs *stable* keys, not semantic ones."""
    if req.policy is not None:
        return "policy"
    if req.mode is None:
        return "default"
    return getattr(req.mode, "name", None) or str(req.mode)


def _device_fault(err: Exception) -> bool:
    """A CUDA error (sticky: the context cannot run another kernel) or a
    kernel build failure — not a cell's fault, so never recovered from."""
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None and isinstance(err, acc):
        return True
    msg = str(err)
    return "CUDA error" in msg or "kernel build failed" in msg \
        or "nvcc" in msg
