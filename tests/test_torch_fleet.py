"""PyTorch port: the serving fleet (``serve/fleet``: prefill/decode cells
over one engine, the paged-KV handoff and the mode-aware router), ports of
tests/test_fleet.py (but its sequence-parallel decode, which comes with
the distributed layer) on CPU tensors, where every kernel wrapper runs its
plain version.

Inside the port the contracts are bitwise: fleet streams equal the
continuous scheduler's on the same engine and trace (a request's rows do
not depend on which cell, micro-batch or neighbours it decodes with).
Against the JAX package the router's decisions are compared exactly (they
do not depend on token values when no request stops at EOS), and token
streams where the logit margins allow (tests/test_torch_scheduler.py)."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.fleet import FleetRouter as JRouter
from repro.serve.fleet import make_fleet as jmake_fleet
from repro.serve.scheduler import ScheduledRequest as JRequest
from repro_torch import kernels
from repro_torch.configs import paper_mpfp
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.fleet import (
    DOWNGRADE_CHAIN,
    HEALTH_STATES,
    ROUTER_POLICIES,
    FleetRouter,
    KVHandoff,
    deliver,
    make_fleet,
)
from repro_torch.serve.kv_cache import BlockPoolExhausted, PagedKVPool
from repro_torch.serve.scheduler import ContinuousScheduler, ScheduledRequest
from repro_torch.weights import params_from_jax

CFG = paper_mpfp.SMOKE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(jconfigs.SMOKE, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


@pytest.fixture(scope="module")
def eng(params):
    return ServeEngine(CFG, params, max_batch=4, max_seq=64,
                       policy=PrecisionPolicy.serve_default(), device="cpu")


def _reqs(seed=0, n=6, max_new=6, modes=("M8", "M16", "M23"), cls=None):
    rng = np.random.default_rng(seed)
    return [(cls or ScheduledRequest)(
        rid=i,
        prompt=rng.integers(0, CFG.vocab,
                            size=int(rng.integers(2, 9))).astype(np.int32),
        max_new=int(rng.integers(2, max_new + 1)),
        mode=modes[i % len(modes)] if modes else None,
        arrival=i // 2)
        for i in range(n)]


def _outs(done):
    return {r.rid: r.out for r in done}


def test_fleet_exports_are_jax():
    import repro.serve.fleet as jfleet
    import repro_torch.serve.fleet as pfleet

    assert set(jfleet.__dict__) - set(pfleet.__dict__) <= {
        "__builtins__", "__cached__", "__file__", "__spec__", "__loader__"}
    assert ROUTER_POLICIES == jfleet.ROUTER_POLICIES
    assert DOWNGRADE_CHAIN == jfleet.DOWNGRADE_CHAIN
    assert HEALTH_STATES == jfleet.HEALTH_STATES


# =========================================================================
# KV handoff: fleet tokens bit-identical to the single-engine scheduler
# =========================================================================
@pytest.mark.parametrize("policy", ["round_robin", "least_kv",
                                    "mode_affinity"])
def test_fleet_matches_scheduler_mixed_modes(eng, policy):
    want = _outs(ContinuousScheduler(eng, n_blocks=33, block_size=8).run(
        _reqs()))
    kernels.reset_launch_counts()
    got = _outs(FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8),
                            policy=policy).run(_reqs()))
    assert got == want  # bit-identical token streams
    calls = kernels.plain_call_counts()
    assert calls["mp_paged_attention"] + calls["mp_mixed_paged_attention"]


def test_fleet_matches_scheduler_on_the_ref_backend(params):
    """The JAX suite's second backend case (pallas_interpret there): the
    port's other backend, ``ref``."""
    eng = ServeEngine(CFG, params, max_batch=4, max_seq=64,
                      policy=PrecisionPolicy.serve_default(),
                      matmul_backend="ref", device="cpu")
    want = _outs(ContinuousScheduler(eng, n_blocks=33, block_size=8).run(
        _reqs(n=3, max_new=4)))
    got = _outs(FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8))
                .run(_reqs(n=3, max_new=4)))
    assert got == want


def test_interleaved_cell_matches_scheduler(eng):
    """disaggregate=False reproduces the single-engine discipline (and its
    mixed-lane decode launches)."""
    want = _outs(ContinuousScheduler(eng, n_blocks=33, block_size=8).run(
        _reqs(seed=3)))
    kernels.reset_launch_counts()
    cells = make_fleet(eng, 1, n_blocks=33, block_size=8,
                       disaggregate=False)
    got = _outs(FleetRouter(cells).run(_reqs(seed=3)))
    assert got == want
    assert kernels.plain_call_counts()["mp_mixed_prelimbed_matmul"] > 0


def test_instant_completion_releases_blocks(eng):
    """max_new=1 finishes inside prefill: no handoff, blocks freed."""
    cells = make_fleet(eng, 1, n_blocks=17, block_size=8)
    router = FleetRouter(cells)
    done = router.run([ScheduledRequest(
        rid=0, prompt=np.arange(4, dtype=np.int32), max_new=1)])
    assert len(done) == 1 and len(done[0].out) == 1
    assert cells[0].pool.n_live == 0
    assert router.stats()["pending_handoffs"] == 0


def test_cells_share_the_engine_and_own_pools(eng):
    cells = make_fleet(eng, 3, n_blocks=9, block_size=8)
    assert all(c.prefill.engine is eng and c.decode.engine is eng
               for c in cells)
    assert len({id(c.pool) for c in cells}) == 3
    assert all(c.pool.k.device == eng.device
               and c.pool.k.dtype == torch.float32 for c in cells)
    with pytest.raises(ValueError, match="at least one cell"):
        make_fleet(eng, 0)


# =========================================================================
# cross-pool block transfer
# =========================================================================
def _pool(n_blocks=8, max_per_seq=4, block_size=4):
    return PagedKVPool(2, n_blocks, block_size, CFG.n_kv_heads,
                       CFG.resolved_head_dim, max_blocks_per_seq=max_per_seq,
                       device="cpu")


def test_transfer_blocks_bit_identical():
    src, dst = _pool(), _pool()
    sb = src.alloc(3)
    gen = torch.Generator().manual_seed(0)
    src.k[:, sb] = torch.randn(src.k[:, sb].shape, generator=gen)
    src.v[:, sb] = torch.randn(src.v[:, sb].shape, generator=gen)
    db = dst.alloc(3)
    src.transfer_blocks(dst, sb, db)
    assert torch.equal(dst.k[:, db], src.k[:, sb])
    assert torch.equal(dst.v[:, db], src.v[:, sb])


def test_transfer_rejects_geometry_mismatch():
    with pytest.raises(ValueError, match="geometry"):
        _pool().transfer_blocks(_pool(block_size=2), [1], [1])


def test_deliver_foreign_pool_moves_blocks():
    src, dst = _pool(), _pool()
    req = ScheduledRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=4)
    req.blocks = src.alloc(2)
    src.k[:, req.blocks] = 7.0
    h = KVHandoff(req=req, src_pool=src, src_cell=0)
    assert deliver(h, dst)
    assert src.n_live == 0 and dst.n_live == 2  # free list moved too
    assert h.src_pool is dst
    assert bool((dst.k[:, req.blocks] == 7.0).all())


def test_deliver_same_pool_is_zero_copy():
    pool = _pool()
    req = ScheduledRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=4)
    req.blocks = pool.alloc(2)
    before, k = list(req.blocks), pool.k.clone()
    assert deliver(KVHandoff(req=req, src_pool=pool), pool)
    assert req.blocks == before and pool.n_live == 2
    assert torch.equal(pool.k, k)


def test_deliver_fails_gracefully_when_dst_full():
    src, dst = _pool(), _pool()
    req = ScheduledRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=4)
    req.blocks = src.alloc(2)
    dst.alloc(4)
    dst.alloc(3)  # exhaust dst (7 allocatable + trash)
    assert not deliver(KVHandoff(req=req, src_pool=src), dst)
    assert src.n_live == 2  # handoff untouched, blocks still in src


def test_deliver_injected_transfer_fail_is_side_effect_free():
    """An injected handoff_transfer_fail fires before any allocation: the
    handoff stays valid against its source pool and the next attempt
    (event spent) succeeds."""
    from repro_torch.serve.faults import FaultEvent, FaultInjector, FaultPlan

    src, dst = _pool(), _pool()
    req = ScheduledRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=4)
    req.blocks = src.alloc(2)
    inj = FaultInjector(FaultPlan(events=[
        FaultEvent("handoff_transfer_fail")]))
    h = KVHandoff(req=req, src_pool=src, src_cell=0)
    assert not deliver(h, dst, injector=inj, dst_cell=1)
    assert src.n_live == 2 and dst.n_live == 0  # nothing moved
    assert h.src_pool is src
    assert deliver(h, dst, injector=inj, dst_cell=1)  # one-shot fault
    assert dst.n_live == 2
    assert inj.trace == [(0, "handoff_transfer_fail", 0, 1, None)]


def test_injected_block_corrupt_lands_nan_in_destination():
    """pool_block_corrupt poisons the first transferred block, in K and V
    and in every layer; the second block arrives intact."""
    from repro_torch.serve.faults import FaultEvent, FaultInjector, FaultPlan

    src, dst = _pool(), _pool()
    sb, db = src.alloc(2), dst.alloc(2)
    dst.fault_injector = FaultInjector(FaultPlan(events=[
        FaultEvent("pool_block_corrupt")]))
    src.transfer_blocks(dst, sb, db)
    assert bool(torch.isnan(dst.k[:, db[0]]).all())
    assert bool(torch.isnan(dst.v[:, db[0]]).all())
    assert not bool(torch.isnan(dst.k[:, db[1]]).any())


# =========================================================================
# pool negative paths
# =========================================================================
def test_double_free_and_foreign_free_rejected():
    pool = _pool()
    blocks = pool.alloc(2)
    pool.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        pool.free(blocks)
    with pytest.raises(ValueError, match="double free|foreign"):
        pool.free([5])
    with pytest.raises(ValueError, match="trash"):
        pool.free([0])
    assert pool.n_free == 7 and pool.n_live == 0


def test_transfer_rejects_block_count_mismatch():
    src, dst = _pool(), _pool()
    sb, db = src.alloc(2), dst.alloc(3)
    with pytest.raises(ValueError, match="count mismatch"):
        src.transfer_blocks(dst, sb, db)


def test_try_alloc_respects_per_seq_cap_and_exhaustion():
    pool = _pool(n_blocks=8, max_per_seq=4)
    assert pool.try_alloc(5) is None
    assert pool.try_alloc(4) is not None
    assert pool.try_alloc(4) is None
    assert pool.n_free == 3
    with pytest.raises(BlockPoolExhausted, match="free list has 3"):
        pool.alloc(4)


def test_try_alloc_thread_hammering_never_double_allocates():
    pool = _pool(n_blocks=33, max_per_seq=8)
    seen_twice, lock, held = [], threading.Lock(), set()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            got = pool.try_alloc(int(rng.integers(1, 5)))
            if got is None:
                continue
            with lock:
                seen_twice.extend(b for b in got if b in held)
                held.update(got)
            with lock:
                held.difference_update(got)
            pool.free(got)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not seen_twice
    assert pool.n_free == 32 and pool.n_live == 0


# =========================================================================
# router placement policies
# =========================================================================
def test_mode_affinity_pins_modes_to_home_cells(eng):
    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)
    done = FleetRouter(cells, policy="mode_affinity").run(
        _reqs(n=8, modes=("M8", "M23")))
    homes = {}
    for r in done:
        homes.setdefault(r.mode, set()).add(r.engine_id)
    assert homes["M8"] != homes["M23"]
    assert all(len(v) == 1 for v in homes.values())


def test_round_robin_spreads_across_cells(eng):
    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)
    FleetRouter(cells, policy="round_robin").run(_reqs(n=6, modes=None))
    assert all(c.prefill.prefills > 0 for c in cells)


def test_least_kv_avoids_pressured_cell(eng):
    cells = make_fleet(eng, 2, n_blocks=33, block_size=8)
    hot = [b for n in (8, 8, 4) for b in cells[0].pool.alloc(n)]
    done = FleetRouter(cells, policy="least_kv").run([ScheduledRequest(
        rid=0, prompt=np.arange(4, dtype=np.int32), max_new=2)])
    assert done[0].engine_id == 1
    cells[0].pool.free(hot)


def test_unknown_policy_rejected(eng):
    cells = make_fleet(eng, 1, n_blocks=17, block_size=8)
    with pytest.raises(ValueError, match="unknown router policy"):
        FleetRouter(cells, policy="best_effort")


def test_completion_fanout_by_submitter(eng):
    router = FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8))
    reqs = _reqs(n=4, modes=None)
    for r in reqs:
        r.submitter = "alice" if r.rid % 2 == 0 else "bob"
    router.run(reqs)
    assert sorted(r.rid for r in router.drain("alice")) == [0, 2]
    assert sorted(r.rid for r in router.drain("bob")) == [1, 3]
    assert router.drain("alice") == []


# =========================================================================
# graceful degradation
# =========================================================================
def test_flood_requeues_and_completes_without_leak(eng):
    cells = make_fleet(eng, 2, n_blocks=5, block_size=8)
    router = FleetRouter(cells)
    reqs = _reqs(n=10, max_new=4, modes=None)
    for r in reqs:
        r.arrival = 0
    done = router.run(reqs)
    stats = router.stats()
    assert stats["completed"] == 10 and stats["requeues"] > 0
    assert stats["blocks_live"] == 0 and stats["pending_handoffs"] == 0
    assert all(len(r.out) == r.max_new for r in done)


def test_admission_caps_bound_inflight_per_mode(eng):
    router = FleetRouter(make_fleet(eng, 2, n_blocks=33, block_size=8),
                         admission_caps={"M8": 1})
    done = router.run(_reqs(n=4, max_new=4, modes=("M8",)))
    assert len(done) == 4 and router.stats()["requeues"] > 0
    assert router._inflight["M8"] == 0


def test_downgrade_after_sustained_pressure(eng):
    cells = make_fleet(eng, 1, n_blocks=17, block_size=8)
    router = FleetRouter(cells, downgrade_after=2)
    hold = cells[0].pool.alloc(8) + cells[0].pool.alloc(8)  # starve
    req = ScheduledRequest(rid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new=2, mode="M23")
    router.submit(req)
    for _ in range(8):
        router.step()
    assert req.requeues >= 2 and req.downgraded_from == "M23"
    assert req.mode in DOWNGRADE_CHAIN.values()
    cells[0].pool.free(hold)
    for _ in range(200):
        router.step()
        if router.completed:
            break
    assert router.completed and router.completed[0].rid == 0
    assert router.stats()["downgrades"] >= 1


def test_never_satisfiable_request_still_raises(eng):
    router = FleetRouter(make_fleet(eng, 2, n_blocks=3, block_size=4,
                                    max_blocks_per_seq=2))
    with pytest.raises(BlockPoolExhausted):
        router.submit(ScheduledRequest(
            rid=0, prompt=np.arange(20, dtype=np.int32), max_new=8))


def test_fleet_stats_have_latency_percentiles(eng):
    router = FleetRouter(make_fleet(eng, 1, n_blocks=17, block_size=8))
    router.run(_reqs(n=3, max_new=4, modes=None))
    stats = router.stats()
    for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms", "tpot_p95_ms",
              "itl_p95_ms", "queue_wait_p95_steps"):
        assert k in stats and stats[k] >= 0.0


# =========================================================================
# against the JAX fleet
# =========================================================================
@pytest.fixture(scope="module")
def jeng(jax_params):
    return JEngine(jconfigs.SMOKE, jax_params, max_batch=4, max_seq=64,
                   policy=JPolicy.serve_default(), matmul_backend="ref",
                   prelimb_weights=False)


def _decisions(router, done):
    """What the router decided, without token values or wall clocks."""
    stats = {k: v for k, v in router.stats().items()
             if not k.endswith("_ms")}
    per_req = sorted((r.rid, r.engine_id, r.admitted_step, r.done_step,
                      r.requeues, r.recoveries, r.guard_trips,
                      str(r.mode), len(r.out)) for r in done)
    return stats, per_req


@pytest.mark.parametrize("policy", ["least_kv", "mode_affinity"])
def test_router_decisions_are_jax(jeng, eng, policy):
    """The same trace through both packages' routers: the same placement,
    admission and completion ticks, the same stats (wall-clock latency
    aside) — under pressure, so requeues and cross-pool handoffs occur."""
    kw = dict(n_blocks=5, block_size=8)

    def flood(reqs):
        for r in reqs:
            r.arrival = r.rid // 4
        return reqs

    jr = JRouter(jmake_fleet(jeng, 3, **kw), policy=policy)
    jd = jr.run(flood(_reqs(n=10, max_new=8, cls=JRequest)))
    pr = FleetRouter(make_fleet(eng, 3, **kw), policy=policy)
    pd = pr.run(flood(_reqs(n=10, max_new=8)))
    assert _decisions(pr, pd) == _decisions(jr, jd)
    assert pr.stats()["requeues"] > 0


def test_fleet_streams_match_jax_where_margins_allow(jeng, eng):
    """Fleet streams of both packages on one trace: token for token up to
    the first step whose JAX top-2 logit margin is within M8's error
    budget (tests/test_torch_scheduler.py's rule)."""
    from test_torch_scheduler import M8_BOUND, _jax_rows, _margins

    reqs = _reqs(seed=5, n=4, max_new=5, modes=None)
    jout = _outs(JRouter(jmake_fleet(jeng, 2, n_blocks=17, block_size=8))
                 .run(_reqs(seed=5, n=4, max_new=5, modes=None,
                            cls=JRequest)))
    pout = _outs(FleetRouter(make_fleet(eng, 2, n_blocks=17, block_size=8))
                 .run(reqs))
    compared = 0
    for r in reqs:
        rows = _jax_rows(jeng, r.prompt, jout[r.rid][:-1])
        tol = M8_BOUND * np.abs(rows[0]).max()
        for step, margin in enumerate(_margins(rows)):
            if margin <= tol:
                break
            assert pout[r.rid][step] == jout[r.rid][step], (r.rid, step)
            compared += 1
    assert compared > 0


# =========================================================================
# the serving launcher
# =========================================================================
def test_serve_launcher_fleet_with_a_fault_plan(tmp_path, capsys):
    from repro_torch.serve.faults import FaultPlan

    plan = tmp_path / "plan.json"
    plan.write_text(FaultPlan.chaos(seed=0, n_cells=4, horizon=12).to_json())
    router = launch_serve.main(
        ["--smoke", "--engines", "4", "--requests", "12", "--mixed-modes",
         "--disaggregate", "--router-policy", "mode_affinity",
         "--fault-plan", str(plan), "--device", "cpu", "--max-new", "8"])
    stats = router.stats()
    assert stats["completed"] == 12 and stats["blocks_live"] == 0
    assert stats["fault_events_fired"] >= 1
    out = capsys.readouterr().out
    assert "fault trace:" in out and "req11" in out


def test_serve_launcher_scheduler_and_static_paths(capsys):
    sched = launch_serve.main(["--smoke", "--scheduler", "--requests", "3",
                               "--mixed-modes", "--device", "cpu",
                               "--max-new", "4"])
    assert sched.stats()["completed"] == 3
    outs = launch_serve.main(["--smoke", "--requests", "2", "--device",
                              "cpu", "--max-new", "3"])
    assert len(outs) == 2 and all(len(o) == 3 for o in outs)
    assert "tokens_per_s" in capsys.readouterr().out


def test_serve_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_serve.main(["--smoke"])
