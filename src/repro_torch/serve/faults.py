"""Deterministic fault injection for the serving fleet (port of
``repro.serve.faults``; numpy only, so the port keeps its own copy, and a
seed's :meth:`FaultPlan.chaos` draws the JAX package's plan exactly).

Production units fail; the follow-up IP-core deployment of the paper's
multiplier (arXiv:1910.05100) assumes a datapath whose accuracy is *policed*
at run time, not trusted.  This module makes every failure mode the fleet
must survive reproducible: a :class:`FaultPlan` is pure data (a seed plus a
schedule of events keyed by tick/cell/slot — no wall clock, no global RNG),
and a :class:`FaultInjector` is the seam the serving loops consult.  The
same plan always produces the same event trace (:attr:`FaultInjector.trace`),
so chaos runs are bit-reproducible.

Event kinds (who consults them):

  ============================  ===========================================
  ``cell_crash``                :meth:`FleetCell.tick` — the whole cell dies
                                (pool contents unrecoverable); the router
                                recovers every in-flight request.
  ``handoff_transfer_fail``     :func:`repro_torch.serve.fleet.handoff.
                                deliver` — a cross-pool block transfer
                                fails before any side effect; the handoff
                                parks and retries.
  ``step_nan``                  the decode step wrapper
                                (:func:`repro_torch.serve.primitives.
                                decode_bucket_step`) — one slot's logits
                                read as non-finite, tripping the numerical
                                guardrail (evict + escalate one mode up).
  ``straggler_delay``           :meth:`FleetCell.tick` — adds ``value``
                                virtual seconds to the cell's tick latency,
                                driving the router's EWMA straggler
                                detector.
  ``pool_block_corrupt``        :meth:`PagedKVPool.transfer_blocks` — the
                                first transferred block lands as NaN in the
                                destination pool (a poisoned handoff); the
                                guardrail catches it on the victim's next
                                decode step.
  ============================  ===========================================

Events with an explicit ``tick`` fire only on that tick (and silently
expire if their site is never consulted that tick — e.g. ``step_nan`` on an
empty slot).  Events with ``tick=None`` fire at the first opportunity,
which keeps unit tests independent of exact scheduling.  Every event fires
at most once.

Zero-overhead contract: nothing in the serving loops constructs or consults
an injector unless one is installed — every seam is a single
``injector is not None`` check when no plan is loaded.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("cell_crash", "handoff_transfer_fail", "step_nan",
               "straggler_delay", "pool_block_corrupt")


class CellCrashed(RuntimeError):
    """Raised out of a cell tick when the plan schedules ``cell_crash`` —
    the router's cue to mark the cell dead and recover its in-flight work."""

    def __init__(self, cell_id: int):
        super().__init__(f"cell {cell_id} crashed (injected)")
        self.cell_id = cell_id


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``None`` fields are wildcards: ``tick=None``
    means first opportunity, ``cell``/``slot`` ``None`` match any site.
    ``value`` is kind-specific (straggler delay in virtual seconds)."""

    kind: str
    tick: Optional[int] = None
    cell: Optional[int] = None
    slot: Optional[int] = None
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}")


@dataclasses.dataclass
class FaultPlan:
    """Pure-data fault schedule: a seed (provenance + generation) and the
    event list.  JSON round-trips losslessly (``--fault-plan plan.json``)."""

    seed: int = 0
    events: List[FaultEvent] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events]},
            indent=1)

    @classmethod
    def from_json(cls, payload) -> "FaultPlan":
        if isinstance(payload, (str, bytes)):
            payload = json.loads(payload)
        return cls(seed=int(payload.get("seed", 0)),
                   events=[FaultEvent(**e) for e in payload["events"]])

    @classmethod
    def chaos(cls, seed: int, *, n_cells: int, horizon: int = 40,
              kill_cells: int = 1, nan_steps: int = 1,
              transfer_fails: int = 1, stragglers: int = 0,
              corrupt_transfers: int = 0) -> "FaultPlan":
        """The canonical chaos schedule (the chaos soak's scenario): kill
        ``kill_cells`` cells mid-stream, poison ``nan_steps`` decode slots,
        fail ``transfer_fails`` cross-pool handoffs — all placed by a
        seed-keyed RNG so distinct seeds exercise distinct timings while
        each seed is fully reproducible."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        lo, hi = max(1, horizon // 4), max(2, horizon)
        victims = rng.choice(n_cells, size=min(kill_cells, n_cells),
                             replace=False)
        for c in victims:
            events.append(FaultEvent("cell_crash",
                                     tick=int(rng.integers(lo, hi)),
                                     cell=int(c)))
        alive = [c for c in range(n_cells) if c not in set(int(v)
                                                           for v in victims)]
        for _ in range(nan_steps):
            events.append(FaultEvent(
                "step_nan", tick=None,
                cell=int(rng.choice(alive)) if alive else None))
        for _ in range(transfer_fails):
            events.append(FaultEvent("handoff_transfer_fail", tick=None))
        for _ in range(stragglers):
            events.append(FaultEvent(
                "straggler_delay", tick=int(rng.integers(lo, hi)),
                cell=int(rng.integers(0, n_cells)),
                value=float(rng.uniform(20.0, 50.0))))
        for _ in range(corrupt_transfers):
            events.append(FaultEvent("pool_block_corrupt", tick=None))
        return cls(seed=seed, events=events)


class FaultInjector:
    """The run-time seam: serving loops ask it "does a fault fire here, now?"

    Stateful only in which events have fired and the current tick cursor
    (the router calls :meth:`begin_tick`); all decisions are table lookups
    against the plan, so two runs of the same plan over the same workload
    produce identical :attr:`trace` lists — the determinism the chaos gate
    asserts.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired = [False] * len(plan.events)
        self.tick = 0
        # (tick, kind, cell, slot, rid) per fired event, in firing order
        self.trace: List[Tuple[int, str, Optional[int], Optional[int],
                               Optional[int]]] = []

    def begin_tick(self, tick: int) -> None:
        self.tick = tick

    def _match(self, kind: str, cell: Optional[int],
               slot: Optional[int]) -> Optional[int]:
        for i, ev in enumerate(self.plan.events):
            if self._fired[i] or ev.kind != kind:
                continue
            if ev.tick is not None and ev.tick != self.tick:
                continue
            if ev.cell is not None and cell is not None and ev.cell != cell:
                continue
            if ev.slot is not None and slot is not None and ev.slot != slot:
                continue
            return i
        return None

    def _fire(self, i: int, kind: str, cell: Optional[int],
              slot: Optional[int], rid: Optional[int]) -> None:
        self._fired[i] = True
        self.trace.append((self.tick, kind, cell, slot, rid))

    # ---- site queries ------------------------------------------------------
    def cell_crash(self, cell: int) -> bool:
        i = self._match("cell_crash", cell, None)
        if i is None:
            return False
        self._fire(i, "cell_crash", cell, None, None)
        return True

    def straggler_delay(self, cell: int) -> float:
        delay = 0.0
        while True:
            i = self._match("straggler_delay", cell, None)
            if i is None:
                return delay
            delay += self.plan.events[i].value
            self._fire(i, "straggler_delay", cell, None, None)

    def transfer_fail(self, src_cell: int, dst_cell: int) -> bool:
        i = self._match("handoff_transfer_fail", src_cell, None)
        if i is None:
            return False
        self._fire(i, "handoff_transfer_fail", src_cell, dst_cell, None)
        return True

    def step_nan(self, cell: int, slot: Optional[int],
                 rid: Optional[int]) -> bool:
        i = self._match("step_nan", cell, slot)
        if i is None:
            return False
        self._fire(i, "step_nan", cell, slot, rid)
        return True

    def block_corrupt(self) -> bool:
        i = self._match("pool_block_corrupt", None, None)
        if i is None:
            return False
        self._fire(i, "pool_block_corrupt", None, None, None)
        return True

    # ---- accounting --------------------------------------------------------
    @property
    def n_fired(self) -> int:
        return sum(self._fired)

    @property
    def unfired(self) -> List[FaultEvent]:
        """Events that never found their site (e.g. ``step_nan`` scheduled
        on a tick where the slot was empty) — chaos tests assert this is
        empty so a mis-aimed schedule fails loudly, not silently."""
        return [e for e, f in zip(self.plan.events, self._fired) if not f]

    def stats(self) -> Dict[str, int]:
        by_kind: Dict[str, int] = {}
        for _, kind, *_ in self.trace:
            by_kind[kind] = by_kind.get(kind, 0) + 1
        return {"fault_events_fired": self.n_fired,
                "fault_events_unfired": len(self.unfired),
                **{f"fault_{k}": v for k, v in sorted(by_kind.items())}}
