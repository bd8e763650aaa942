"""PyTorch port: deterministic fault injection and recovery in serving
(``serve/faults.py`` and its seams in the scheduler, the paged pool and the
fleet), ports of the serving half of tests/test_fault_tolerance.py on CPU
tensors, where every kernel wrapper runs its plain version.

Fault plans are numpy data: a seed's ``FaultPlan.chaos`` and an injector's
trace are the JAX package's exactly.  The router's recovery decisions do
not depend on token values when no request stops at EOS, so the injector
trace, cell states and every counter of ``stats()`` (the wall-clock
latencies aside) are held against the JAX fleet on the same trace.  Token
streams are held inside the port: untouched requests bitwise the no-fault
run, a recovered suffix bitwise a resumed solo run."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve import faults as jfaults
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.fleet import FleetRouter as JRouter
from repro.serve.fleet import make_fleet as jmake_fleet
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import ScheduledRequest as JRequest
from repro_torch.configs import paper_mpfp
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.serve import primitives as prim
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import (FAULT_KINDS, CellCrashed, FaultEvent,
                                      FaultInjector, FaultPlan)
from repro_torch.serve.fleet import FleetRouter, make_fleet
from repro_torch.serve.scheduler import ContinuousScheduler, \
    GuardrailConfig, ScheduledRequest
from repro_torch.weights import params_from_jax

CFG = paper_mpfp.SMOKE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# =========================================================================
# fault plans and injectors (pure data)
# =========================================================================
def test_fault_kinds_and_crash_are_jax():
    assert FAULT_KINDS == jfaults.FAULT_KINDS
    err = CellCrashed(3)
    assert err.cell_id == 3 and str(err) == str(jfaults.CellCrashed(3))


def test_json_roundtrip():
    plan = FaultPlan.chaos(seed=7, n_cells=4, stragglers=2,
                           corrupt_transfers=1)
    assert FaultPlan.from_json(plan.to_json()) == plan


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17])
@pytest.mark.parametrize("kw", [{}, dict(n_cells=2, horizon=12),
                                dict(stragglers=2, corrupt_transfers=1,
                                     kill_cells=2, nan_steps=2)])
def test_chaos_plan_is_jax(seed, kw):
    """The same seed draws the same plan: the JSON wire forms are equal,
    and each package reads the other's."""
    kw = {"n_cells": 4, **kw}
    p, j = FaultPlan.chaos(seed, **kw), jfaults.FaultPlan.chaos(seed, **kw)
    assert p.to_json() == j.to_json()
    assert FaultPlan.from_json(j.to_json()) == p
    assert jfaults.FaultPlan.from_json(p.to_json()) == j


def test_chaos_reproducible_and_seed_sensitive():
    a = FaultPlan.chaos(seed=3, n_cells=4)
    assert a == FaultPlan.chaos(seed=3, n_cells=4)
    assert a != FaultPlan.chaos(seed=4, n_cells=4)


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("disk_on_fire")


def _drive(inj):
    for t in range(4):
        inj.begin_tick(t)
        for cell in (0, 1):
            inj.cell_crash(cell)
            inj.straggler_delay(cell)
            inj.step_nan(cell, slot=0, rid=10 + cell)
            inj.transfer_fail(cell, 1 - cell)
            inj.block_corrupt()
    return inj.trace


def test_events_fire_once_and_trace_is_deterministic():
    plan = FaultPlan(events=[
        FaultEvent("cell_crash", tick=2, cell=1),
        FaultEvent("step_nan", tick=None, cell=0),
        FaultEvent("straggler_delay", tick=1, cell=0, value=5.0)])
    t1, t2 = _drive(FaultInjector(plan)), _drive(FaultInjector(plan))
    assert t1 == t2
    assert [e[1] for e in t1] == ["step_nan", "straggler_delay",
                                  "cell_crash"]
    inj = FaultInjector(plan)
    inj.begin_tick(2)
    assert inj.cell_crash(1) and not inj.cell_crash(1)  # one-shot
    assert not inj.cell_crash(0)  # wrong cell never matches


@pytest.mark.parametrize("seed", [0, 5])
def test_injector_trace_and_stats_are_jax(seed):
    """Every site consulted on the same schedule: the same trace, the same
    stats, the same unfired events."""
    kw = dict(n_cells=2, horizon=4, stragglers=2, corrupt_transfers=1,
              transfer_fails=2)
    p = FaultInjector(FaultPlan.chaos(seed, **kw))
    j = jfaults.FaultInjector(jfaults.FaultPlan.chaos(seed, **kw))
    assert _drive(p) == _drive(j)
    assert p.stats() == j.stats() and p.unfired == [
        FaultEvent(**e.__dict__) for e in j.unfired]


def test_tick_scoped_event_expires_silently():
    inj = FaultInjector(FaultPlan(events=[
        FaultEvent("step_nan", tick=1, cell=0)]))
    inj.begin_tick(3)
    assert not inj.step_nan(0, slot=0, rid=0)
    assert inj.n_fired == 0 and len(inj.unfired) == 1
    assert inj.stats()["fault_events_unfired"] == 1


def test_guard_check_finite_and_sentinel():
    policy = PrecisionPolicy.serve_default().overlay("M16")
    stat = np.asarray([1.0, np.nan, np.inf, 1e9])
    ok = prim.guard_check(stat, policy, GuardrailConfig())
    assert ok.tolist() == [True, False, False, True]
    ok = prim.guard_check(stat, policy, GuardrailConfig(logit_bound=100.0))
    assert ok.tolist() == [True, False, False, False]


def test_escalate_mode_ladder():
    req = ScheduledRequest(rid=0, prompt=np.asarray([1], np.int32),
                           mode="M8")
    assert prim.escalate_mode(req) and req.mode == "M16"
    assert prim.escalate_mode(req) and req.mode == "M23"
    assert req.escalated_from == "M8"
    assert not prim.escalate_mode(req)
    bare = ScheduledRequest(rid=1, prompt=np.asarray([1], np.int32))
    assert not prim.escalate_mode(bare)


# =========================================================================
# fleet recovery and guardrails (model-backed)
# =========================================================================
@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def eng(jax_params):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    return ServeEngine(CFG, params, max_batch=4, max_seq=64,
                       policy=PrecisionPolicy.serve_default(), device="cpu")


@pytest.fixture(scope="module")
def jeng(jax_params):
    return JEngine(jconfigs.SMOKE, jax_params, max_batch=4, max_seq=64,
                   policy=JPolicy.serve_default(), matmul_backend="ref",
                   prelimb_weights=False)


def _reqs(seed=0, n=6, max_new=6, modes=("M8", "M16"), cls=None, **kw):
    rng = np.random.default_rng(seed)
    return [(cls or ScheduledRequest)(
        rid=i,
        prompt=rng.integers(0, CFG.vocab,
                            size=int(rng.integers(2, 9))).astype(np.int32),
        max_new=int(rng.integers(3, max_new + 1)),
        mode=modes[i % len(modes)] if modes else None,
        arrival=i // 2, **kw)
        for i in range(n)]


def _outs(done):
    return {r.rid: r.out for r in done}


def _solo_suffix(eng, v, mode=None):
    """A resumed solo run of a recovered request: its prefix in ``out``."""
    k = v.recovery_prefixes[-1]
    solo = ScheduledRequest(rid=99, prompt=np.asarray(v.prompt, np.int32),
                            max_new=v.max_new, mode=mode or v.mode)
    solo.out = list(v.out[:k])
    ContinuousScheduler(eng, n_blocks=17, block_size=8).run([solo])
    return solo.out[k:]


def test_cell_crash_recovery_bit_parity(eng):
    """Kill a cell mid-stream: every request completes; the untouched are
    bitwise the no-fault run; each victim's history is kept and its suffix
    is bitwise a resumed solo run; no block leaks from the dead pool."""
    want = _outs(FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8))
                 .run(_reqs()))
    router = FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8),
                         fault_plan=FaultPlan(events=[
                             FaultEvent("cell_crash", tick=2, cell=1)]))
    done = router.run(_reqs())
    stats, outs = router.stats(), _outs(done)
    victims = [r for r in done if r.recovery_prefixes]
    assert victims
    for r in done:
        if not r.recovery_prefixes:
            assert outs[r.rid] == want[r.rid]
    for v in victims:
        k0 = v.recovery_prefixes[0]
        assert v.out[:k0] == want[v.rid][:k0]
        assert v.out[v.recovery_prefixes[-1]:] == _solo_suffix(eng, v)
    assert stats["cell_deaths"] == 1 and stats["cell_states"][1] == "dead"
    assert stats["recovered_requests"] >= 1
    assert stats["blocks_live"] == 0 and stats["pending_handoffs"] == 0
    assert stats["fault_events_unfired"] == 0
    assert router.health[1].last_error == "crash"
    assert sum(h.errors for h in router.health.values()) == 0


def test_step_nan_escalates_and_matches_solo_rerun(eng):
    router = FleetRouter(make_fleet(eng, 1, n_blocks=33, block_size=8),
                         fault_plan=FaultPlan(events=[
                             FaultEvent("step_nan", tick=None, cell=0)]))
    done = router.run(_reqs(n=4, modes=("M8",), max_new=6))
    victims = [r for r in done if r.guard_trips]
    assert len(victims) == 1
    v = victims[0]
    assert v.escalated_from == "M8" and v.mode == "M16"
    assert len(v.out) == v.max_new
    assert router.stats()["escalations"] == 1
    assert v.out[v.recovery_prefixes[-1]:] == _solo_suffix(eng, v, "M16")


def test_straggler_drives_degrade_then_quarantine(eng):
    plan = FaultPlan(events=[
        FaultEvent("straggler_delay", tick=t, cell=1, value=100.0)
        for t in (4, 5, 6)])
    router = FleetRouter(
        make_fleet(eng, 2, n_blocks=33, block_size=8), fault_plan=plan,
        health_kwargs=dict(min_samples=2, degrade_after=1,
                           quarantine_after=2, probation_ticks=3))
    done = router.run(_reqs(n=8, max_new=8))
    stats = router.stats()
    assert len(done) == 8
    assert stats["straggler_events"] >= 2 and stats["cell_deaths"] == 0
    assert stats["cell_states"][1] in ("degraded", "quarantined")


def test_guardrail_exhaustion_fails_loudly(eng):
    plan = FaultPlan(events=[
        FaultEvent("step_nan", tick=None, cell=0) for _ in range(4)])
    router = FleetRouter(make_fleet(eng, 1, n_blocks=33, block_size=8),
                         fault_plan=plan,
                         guard=GuardrailConfig(max_trips_per_request=2))
    with pytest.raises(RuntimeError, match="guardrail"):
        router.run(_reqs(n=1, modes=None, max_new=8))


def test_a_real_cell_error_quarantines_but_a_cuda_error_ends_the_run(
        eng, monkeypatch):
    """The router's catch-all: an exception out of a cell tick quarantines
    the cell and its work moves on (recorded on the health record); a CUDA
    error is sticky, so it is raised instead."""
    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)
    real, calls = cells[1].decode.step, {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("bad slot table")
        return real()

    monkeypatch.setattr(cells[1].decode, "step", flaky)
    router = FleetRouter(cells)
    done = router.run(_reqs(n=6, max_new=6))
    # the requests the cell prefilled in the failed tick are recovered too
    assert len(done) == 6 and all(len(r.out) == r.max_new for r in done)
    assert router.health[1].errors == 1
    assert router.health[1].last_error == "ValueError: bad slot table"
    assert router.stats()["blocks_live"] == 0

    # a prefill that raises: the request it took is recovered too
    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)
    real_prefill, calls = prim.prefill_request, {"n": 0}

    def flaky_prefill(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("bad prompt bucket")
        return real_prefill(*args)

    monkeypatch.setattr(prim, "prefill_request", flaky_prefill)
    router = FleetRouter(cells)
    done = router.run(_reqs(n=6, max_new=6))
    assert len(done) == 6 and all(len(r.out) == r.max_new for r in done)
    assert sum(h.errors for h in router.health.values()) == 1
    assert router.stats()["blocks_live"] == 0
    monkeypatch.setattr(prim, "prefill_request", real_prefill)

    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)

    def fault():
        raise RuntimeError("mp_paged_attention: CUDA error 700 at launch")

    monkeypatch.setattr(cells[0].decode, "step", fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        FleetRouter(cells).run(_reqs(n=2, max_new=4))


def test_scheduler_takes_a_fault_plan(eng):
    """Single-engine chaos: the scheduler's step_nan seam trips one slot,
    which escalates and completes; its suffix is a resumed solo run's; the
    tick cursor reaches the injector."""
    sched = ContinuousScheduler(eng, n_blocks=33, block_size=8)
    inj = sched.install_faults(FaultPlan(events=[
        FaultEvent("step_nan", tick=3, cell=0)]))
    assert sched.pool.fault_injector is inj
    done = sched.run(_reqs(n=4, modes=("M8",), max_new=6))
    assert inj.trace and inj.trace[0][:2] == (3, "step_nan")
    victims = [r for r in done if r.guard_trips]
    assert len(victims) == 1 and sched.stats()["escalations"] == 1
    v = victims[0]
    assert v.out[v.recovery_prefixes[-1]:] == _solo_suffix(eng, v, "M16")


def _soak_trace(seed=0, n=24, per_tick=4):
    """Four modes, four arrivals a tick: decode slots fill, so handoffs
    cross pools (where ``handoff_transfer_fail`` fires)."""
    rng = np.random.default_rng(seed)
    return [ScheduledRequest(
        rid=i, prompt=rng.integers(0, CFG.vocab, size=int(
            rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(8, 17)),
        mode=("M8", "M16", "M23", "M36")[i % 4], arrival=i // per_tick)
        for i in range(n)]


@pytest.mark.parametrize("seed", [0, 2])
def test_chaos_soak_gates(eng, seed):
    """benchmarks/chaos_soak.py's gates on the port: every event fires, no
    lost request, no leaked block, slot or handoff, untouched streams ==
    the no-fault run, a recovered history kept and its suffix == a resumed
    solo run at its (possibly escalated) mode, the plan twice identical,
    recovery p95 within 24 ticks."""
    def run(plan):
        cells = make_fleet(eng, 4, n_blocks=40, block_size=4)
        router = FleetRouter(cells, policy="least_kv", fault_plan=plan)
        done = router.run(_soak_trace())
        return router, cells, {r.rid: r for r in done}

    _, _, base = run(None)
    router, cells, got = run(FaultPlan.chaos(seed, n_cells=4, horizon=12))
    st = router.stats()
    assert st["fault_events_unfired"] == 0 and st["cell_deaths"] == 1
    assert st["guard_trips"] >= 1 and st["fault_handoff_transfer_fail"] == 1
    assert st["completed"] == 24 and st["expired"] == st["canceled"] == 0
    assert all(len(r.out) == r.max_new for r in got.values())
    assert st["blocks_live"] == 0 and st["pending_handoffs"] == 0
    for c in cells:
        assert c.decode.n_active == 0 and c.prefill.queue_depth == 0
        assert c.pool.n_free == c.pool.n_blocks - 1
    recovered = [r for r in got.values() if r.recovery_prefixes]
    assert recovered
    for rid, r in got.items():
        if not r.recovery_prefixes and not r.guard_trips:
            assert r.out == base[rid].out
    for r in recovered:
        k0 = r.recovery_prefixes[0]
        assert r.out[:k0] == base[r.rid].out[:k0]
        assert r.out[r.recovery_prefixes[-1]:] == _solo_suffix(eng, r)
    again, _, twice = run(FaultPlan.chaos(seed, n_cells=4, horizon=12))
    assert again.injector.trace == router.injector.trace
    assert {k: r.out for k, r in twice.items()} == \
        {k: r.out for k, r in got.items()}
    assert st["recovery_latency_p95_ticks"] <= 24
    assert sum(h.errors for h in router.health.values()) == 0


# =========================================================================
# against the JAX fleet: the same faults, the same decisions
# =========================================================================
def _decisions(router, done):
    stats = {k: v for k, v in router.stats().items()
             if not k.endswith("_ms")}
    per_req = sorted((r.rid, r.engine_id, r.done_step, r.requeues,
                      r.recoveries, tuple(r.recovery_prefixes),
                      r.guard_trips, str(r.mode), str(r.escalated_from))
                     for r in done)
    return router.injector.trace, stats, per_req


@pytest.mark.parametrize("seed", [0, 2])
def test_chaos_decisions_are_jax(jeng, eng, seed):
    """``FaultPlan.chaos(seed)`` over one trace in both packages' fleets:
    the same injector trace, cell states, recoveries, escalations and
    counters."""
    plan = dict(n_cells=3, horizon=10)
    jr = JRouter(jmake_fleet(jeng, 3, n_blocks=12, block_size=8),
                 policy="least_kv",
                 fault_plan=jfaults.FaultPlan.chaos(seed, **plan))
    jd = jr.run(_reqs(n=12, max_new=8, cls=JRequest))
    pr = FleetRouter(make_fleet(eng, 3, n_blocks=12, block_size=8),
                     policy="least_kv", fault_plan=FaultPlan.chaos(seed,
                                                                   **plan))
    pd = pr.run(_reqs(n=12, max_new=8))
    assert _decisions(pr, pd) == _decisions(jr, jd)
    assert pr.stats()["fault_events_fired"] >= 2


def _corrupt_trace(cls):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, CFG.vocab, size=int(
        rng.integers(2, 20))).astype(np.int32),
        max_new=int(rng.integers(8, 20)), mode=("M8", "M16")[i % 2],
        arrival=i // 4) for i in range(16)]


def test_poisoned_handoff_is_caught_as_in_jax(jeng, eng):
    """A ``pool_block_corrupt`` handoff: the receiving slot trips the
    guardrail, escalates and completes, with JAX's decisions."""
    kw = dict(n_blocks=40, block_size=4)
    jr = JRouter(jmake_fleet(jeng, 2, **kw), policy="least_kv",
                 fault_plan=jfaults.FaultPlan(events=[
                     jfaults.FaultEvent("pool_block_corrupt")]))
    jd = jr.run(_corrupt_trace(JRequest))
    pr = FleetRouter(make_fleet(eng, 2, **kw), policy="least_kv",
                     fault_plan=FaultPlan(events=[
                         FaultEvent("pool_block_corrupt")]))
    pd = pr.run(_corrupt_trace(ScheduledRequest))
    assert _decisions(pr, pd) == _decisions(jr, jd)
    st = pr.stats()
    assert st["fault_pool_block_corrupt"] == 1 and st["guard_trips"] == 1
    assert st["completed"] == 16 and st["blocks_live"] == 0
    assert sum(h.errors for h in pr.health.values()) == 0


def test_a_poisoned_block_can_trip_its_next_owner(eng):
    """The victim frees its blocks with the NaNs in them; a later owner
    reads that block's stale tail (masked to p = 0, but 0 x NaN is NaN in
    P V) and trips too.  The JAX fleet frees the block the same way
    (ROADMAP.md Queue 3).  Every request still completes, escalated."""
    pe2 = ServeEngine(CFG, eng.params, max_batch=2, max_seq=64,
                      policy=PrecisionPolicy.serve_default(), device="cpu")
    router = FleetRouter(make_fleet(pe2, 2, n_blocks=40, block_size=4),
                         policy="least_kv", fault_plan=FaultPlan(events=[
                             FaultEvent("pool_block_corrupt")]))
    done = router.run(_corrupt_trace(ScheduledRequest))
    st = router.stats()
    assert st["fault_pool_block_corrupt"] == 1 and st["guard_trips"] == 2
    assert sorted(r.rid for r in done if r.guard_trips) == [4, 14]
    assert all(r.escalated_from == "M8" for r in done if r.guard_trips)
    assert st["completed"] == 16 and st["blocks_live"] == 0


def test_scheduler_step_nan_decisions_are_jax(jeng, eng):
    plan = [FaultEvent("step_nan", tick=2, cell=0)]
    js = JScheduler(jeng, n_blocks=33, block_size=8)
    js.install_faults(jfaults.FaultPlan(events=[
        jfaults.FaultEvent("step_nan", tick=2, cell=0)]))
    jd = js.run(_reqs(n=4, modes=("M8",), cls=JRequest))
    ps = ContinuousScheduler(eng, n_blocks=33, block_size=8)
    ps.install_faults(FaultPlan(events=plan))
    pd = ps.run(_reqs(n=4, modes=("M8",)))
    assert ps.injector.trace == js.injector.trace
    key = lambda d: sorted((r.rid, r.guard_trips, str(r.mode),  # noqa: E731
                            r.done_step, tuple(r.recovery_prefixes))
                           for r in d)
    assert key(pd) == key(jd)


# =========================================================================
# deadlines and cancellation in both control loops
# =========================================================================
def test_scheduler_deadline_expiry_accounting(eng):
    sched = ContinuousScheduler(eng, n_blocks=17, block_size=8)
    reqs = _reqs(n=3, modes=None, max_new=6)
    reqs[1].deadline_ticks, reqs[1].max_new = 2, 40
    done = sched.run(reqs)
    stats = sched.stats()
    assert {r.rid for r in done} == {0, 2}
    assert stats["expired"] == 1 and stats["completed"] == 2
    assert sched.expired[0].rid == 1 and sched.expired[0].state == "expired"
    assert len(sched.expired[0].out) <= 3
    assert stats["blocks_live"] == 0


def test_router_deadline_expiry_accounting(eng):
    router = FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8))
    reqs = _reqs(n=4, max_new=6)
    reqs[2].deadline_ticks, reqs[2].max_new = 2, 40
    done = router.run(reqs)
    stats = router.stats()
    assert {r.rid for r in done} == {0, 1, 3}
    assert stats["expired"] == 1 and stats["completed"] == 3
    assert stats["blocks_live"] == 0 and stats["pending_handoffs"] == 0
    assert {r.rid: r.state for r in router.drain()}[2] == "expired"


def test_scheduler_cancel_lifecycle(eng):
    sched = ContinuousScheduler(eng, n_blocks=17, block_size=8)
    reqs = _reqs(n=3, modes=None, max_new=8)
    for r in reqs:
        sched.submit(r)
    assert sched.cancel(999) is False
    assert sched.cancel(reqs[2].rid) is True
    sched.step()
    assert sched.cancel(reqs[0].rid) is True
    assert sched.cancel(reqs[0].rid) is False
    sched.run()
    stats = sched.stats()
    assert stats["canceled"] == 2 and stats["completed"] == 1
    assert stats["blocks_live"] == 0
    assert {r.state for r in sched.canceled} == {"canceled"}


def test_router_cancel_lifecycle(eng):
    router = FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8))
    reqs = _reqs(n=4, max_new=8)
    for r in reqs:
        r.arrival = 0
        router.submit(r)
    assert router.cancel(999) is False
    assert router.cancel(reqs[3].rid) is True
    router.step()
    router.step()
    assert router.cancel(reqs[0].rid) is True
    assert router.cancel(reqs[0].rid) is False
    router.run()
    stats = router.stats()
    assert stats["canceled"] == 2 and stats["completed"] == 2
    assert stats["blocks_live"] == 0 and stats["submitted"] == 4


def test_plan_file_is_the_wire_form(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(FaultPlan.chaos(seed=1, n_cells=4).to_json())
    back = FaultPlan.from_json(path.read_text())
    assert back == FaultPlan.chaos(seed=1, n_cells=4)
    assert json.loads(path.read_text())["seed"] == 1
