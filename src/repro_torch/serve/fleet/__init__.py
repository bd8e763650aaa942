"""Disaggregated serving fleet (port of ``repro.serve.fleet``):
prefill/decode engine replicas exchanging paged-KV handoffs behind a
mode-aware router.  The cells share one card: each owns a pool there, and
all share the one engine's weights.

Quickstart (one shared ServeEngine, four cells, mode-pinned routing)::

    from repro_torch.serve.fleet import FleetRouter, make_fleet

    cells = make_fleet(engine, 4, n_blocks=64, block_size=8)
    router = FleetRouter(cells, policy="mode_affinity")
    done = router.run(requests)          # ScheduledRequest list, as ever
    mine = router.drain("my-client")     # tagged completion fan-out

Chaos quickstart (deterministic fault injection + recovery)::

    from repro_torch.serve.faults import FaultPlan

    plan = FaultPlan.chaos(seed=0, n_cells=4)   # or hand-written events
    router = FleetRouter(cells, fault_plan=plan)
    done = router.run(requests)                  # still completes 100%
    router.stats()["cell_deaths"], router.injector.trace

DESIGN.md §9 describes the handoff protocol, the router's state machine and
the graceful-degradation (backoff / mode-downgrade) rules; §10 the failure
model: cell health states, in-flight recovery, and the numerical
guardrail's precision-escalation ladder.
"""
from repro_torch.serve.faults import (  # noqa: F401
    CellCrashed,
    FaultEvent,
    FaultInjector,
    FaultPlan,
)
from repro_torch.serve.fleet.engines import (  # noqa: F401
    DecodeEngine,
    FleetCell,
    PrefillEngine,
    make_fleet,
)
from repro_torch.serve.fleet.handoff import KVHandoff, deliver  # noqa: F401
from repro_torch.serve.fleet.router import (  # noqa: F401
    DOWNGRADE_CHAIN,
    HEALTH_STATES,
    ROUTER_POLICIES,
    CellHealth,
    FleetRouter,
)
from repro_torch.serve.primitives import (  # noqa: F401
    ESCALATE_CHAIN,
    GuardrailConfig,
)
