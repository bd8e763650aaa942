"""PyTorch port: the continuous scheduler (port of
``repro.serve.scheduler`` over ``repro.serve.primitives`` and the paged
pool), held against the JAX package and against its own invariants.

The port runs on the CPU (``device="cpu"``), where every kernel wrapper
runs its plain version; the JAX reference runs its ``ref`` backend.

Tolerances: paged decode logits are held like tests/test_torch_serve.py's
engine logits (1e-5 of their scale under ``full_fp32``; M8's
``rel_err_bound`` 2^-6 of it under ``serve_default``, whose M8 activations
round to bf16 where a last-bit f32 difference between the frameworks can
cross a rounding boundary).  Token streams are held equal up to the first
step whose top-2 logit margin is within that tolerance.  Inside the port
the invariants are bitwise: a request's stream does not depend on the
micro-batch it decodes in, on neighbours joining or leaving, or (on the
``ref`` backend, whose dense and paged decode attention are the same
masked einsums) on static versus scheduled serving."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.kv_cache import PagedKVPool as JPool
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import ScheduledRequest as JRequest
from repro_torch import kernels
from repro_torch.configs import paper_mpfp as pconfigs
from repro_torch.core.formats import register_format, resolve, \
    unregister_format
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.serve import primitives as prim
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import TRASH_BLOCK, BlockPoolExhausted, \
    PagedKVPool
from repro_torch.serve.scheduler import ContinuousScheduler, \
    GuardrailConfig, ScheduledRequest
from repro_torch.weights import params_from_jax

CFG_J, CFG_P = jconfigs.SMOKE, pconfigs.SMOKE
M8_BOUND = resolve("M8").rel_err_bound


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(CFG_J, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _engine(params, backend=None, policy=None, max_batch=4):
    return ServeEngine(CFG_P, params, max_batch=max_batch, max_seq=64,
                       policy=policy or PrecisionPolicy.serve_default(),
                       matmul_backend=backend, device="cpu")


def _jengine(jax_params, policy_name="serve_default"):
    return JEngine(CFG_J, jax_params, max_batch=4, max_seq=64,
                   policy=getattr(JPolicy, policy_name)(),
                   matmul_backend="ref", prelimb_weights=False)


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_P.vocab, size=s).astype(np.int32)
            for s in sizes]


def _run(eng, prompts, max_new, n_blocks=32, block_size=8, **kw):
    sched = ContinuousScheduler(eng, n_blocks=n_blocks,
                                block_size=block_size)
    done = sched.run([ScheduledRequest(rid=i, prompt=p, max_new=max_new,
                                       **kw) for i, p in enumerate(prompts)])
    return {r.rid: r.out for r in done}, sched


# =========================================================================
# the paged pool's free list (the five cases of TestPagedPool)
# =========================================================================
def _never_double_allocates(pool):
    seen = set()
    for _ in range(3):
        got = pool.alloc(2)
        assert not (set(got) & seen) and TRASH_BLOCK not in got
        seen |= set(got)
    assert pool.n_live == 6 and pool.n_free == 1


def _exhaustion_raises_and_eviction_reclaims(pool):
    a, b = pool.alloc(4), pool.alloc(3)
    with pytest.raises(BlockPoolExhausted):
        pool.alloc(1)
    assert pool.try_alloc(1) is None
    pool.free(b)
    c = pool.alloc(3)
    assert set(c) == set(b)  # LIFO reuse of the freed blocks
    assert pool.n_free == 0 and pool.n_live == 7
    pool.free(a + c)
    assert pool.n_free == 7 and pool.n_live == 0


def _double_free_and_trash_free_raise(pool):
    got = pool.alloc(1)
    pool.free(got)
    with pytest.raises(ValueError):
        pool.free(got)
    with pytest.raises(ValueError):
        pool.free([TRASH_BLOCK])


def _over_reservation_raises(pool):
    with pytest.raises(BlockPoolExhausted, match="max_blocks_per_seq"):
        pool.alloc(5)


def _table_row_trash_padding(pool):
    blocks = pool.alloc(2)
    row = pool.table_row(blocks)
    assert row.dtype == np.int32 and list(row[:2]) == blocks
    assert (row[2:] == TRASH_BLOCK).all()
    assert (pool.trash_row() == TRASH_BLOCK).all()


@pytest.mark.parametrize("case", [
    _never_double_allocates, _exhaustion_raises_and_eviction_reclaims,
    _double_free_and_trash_free_raise, _over_reservation_raises,
    _table_row_trash_padding], ids=lambda f: f.__name__.strip("_"))
def test_paged_pool_invariants(case):
    pool = PagedKVPool(2, 8, 4, CFG_P.n_kv_heads, CFG_P.resolved_head_dim,
                       max_blocks_per_seq=4, device="cpu")
    assert pool.k.shape == (2, 8, 4, CFG_P.n_kv_heads,
                            CFG_P.resolved_head_dim)
    case(pool)
    with pytest.raises(ValueError, match="shape"):
        pool.update(pool.k[:1], pool.v)
    pool.update(pool.k, pool.v)


def test_paged_pool_defaults_to_the_card(monkeypatch):
    """Like ``ServeEngine``, the pool lives on the card unless asked for the
    CPU: without a card, constructing it without ``device`` raises instead
    of allocating on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        PagedKVPool(2, 8, 4, 2, 8, max_blocks_per_seq=4)
    assert PagedKVPool(2, 8, 4, 2, 8, max_blocks_per_seq=4,
                       device="cpu").k.device.type == "cpu"


def test_transfer_blocks_copies_block_contents():
    src = PagedKVPool(2, 6, 4, 2, 8, max_blocks_per_seq=4, device="cpu")
    dst = PagedKVPool(2, 6, 4, 2, 8, max_blocks_per_seq=4, device="cpu")
    src.k.normal_(generator=torch.Generator().manual_seed(0))
    src.v.normal_(generator=torch.Generator().manual_seed(1))
    src.transfer_blocks(dst, [2, 3], [5, 1])
    assert torch.equal(dst.k[:, [5, 1]], src.k[:, [2, 3]])
    assert torch.equal(dst.v[:, [5, 1]], src.v[:, [2, 3]])
    assert not dst.k[:, [2, 3, 4]].any()
    with pytest.raises(ValueError, match="mismatch"):
        src.transfer_blocks(dst, [2], [1, 2])


# =========================================================================
# against the JAX package
# =========================================================================
def _paged_logits(steps, params, decode_params, prompt, stream, pool_cls,
                  to_dev, n_layers, tok_dev=None):
    """Teacher-forced paged serving of one request: the prefill's last-token
    logits, then one decode step per token of ``stream``.  Returns the list
    of (V,) logit rows as numpy.  ``to_dev`` moves the table and lengths,
    ``tok_dev`` (default ``to_dev``) the tokens."""
    prefill, decode = steps
    tok_dev = tok_dev or to_dev
    hk, dh = CFG_P.n_kv_heads, CFG_P.resolved_head_dim
    pool = pool_cls(n_layers, 16, 8, hk, dh, max_blocks_per_seq=8)
    n = len(prompt)
    blocks = pool.alloc(pool.blocks_for_tokens(n + len(stream)))
    w = prim.table_width(pool, [ScheduledRequest(rid=0, prompt=prompt,
                                                 blocks=blocks)])
    table = pool.table_row(blocks)[None, :w]
    tokens = np.zeros((1, prim.pow2_at_least(n)), np.int32)
    tokens[0, :n] = prompt
    logits, _, k, v = prefill(params, pool.k, pool.v, to_dev(table),
                              to_dev(np.zeros((1,), np.int32)),
                              tok_dev(tokens), n - 1)
    pool.update(k, v)
    rows = [np.asarray(logits)[0, 0]]
    for i, tok in enumerate(stream):
        logits, stat, k, v = decode(
            decode_params, pool.k, pool.v, to_dev(table),
            to_dev(np.asarray([n + i], np.int32)),
            tok_dev(np.asarray([[tok]], np.int32)))
        pool.update(k, v)
        rows.append(np.asarray(logits)[0, -1])
        assert np.asarray(stat)[0] == np.abs(rows[-1]).max()
    return rows


def _jax_rows(je, prompt, stream):
    pol = je.policy
    return _paged_logits(je.paged_steps_for(pol), je.params,
                         je._decode_params_for(pol), prompt, stream, JPool,
                         jnp.asarray, CFG_J.n_layers)


def _port_rows(pe, prompt, stream):
    pol = pe.policy
    return _paged_logits(pe.paged_steps_for(pol), pe.params,
                         pe._decode_params_for(pol), prompt, stream,
                         functools.partial(PagedKVPool, device=pe.device),
                         pe.to_device, CFG_P.n_layers,
                         lambda a: pe.to_device(a.astype(np.int64)))


@pytest.mark.parametrize("policy_name,rel_tol", [
    ("full_fp32", 1e-5), ("serve_default", M8_BOUND)])
def test_teacher_forced_paged_logits_match_jax(jax_params, params,
                                               policy_name, rel_tol):
    """The port's paged prefill and decode steps against JAX's
    ``make_paged_prefill_step`` / ``make_paged_decode_step`` on the same
    token stream (the JAX one): prefill at B=1 into fresh blocks, then
    decode steps over the paged pool."""
    je = _jengine(jax_params, policy_name)
    pe = _engine(params, policy=getattr(PrecisionPolicy, policy_name)())
    prompt = _prompts(3, [11])[0]
    stream = je.generate([prompt], max_new=5)[0]
    kernels.reset_launch_counts()
    jrows = _jax_rows(je, prompt, stream)
    prows = _port_rows(pe, prompt, stream)
    scale = np.abs(jrows[0]).max()
    for j, p in zip(jrows, prows):
        np.testing.assert_allclose(p, j, rtol=0, atol=rel_tol * scale)
    calls = kernels.plain_call_counts()
    for name in ("mp_fused_proj", "mp_flash_attention", "mp_fused_matmul",
                 "mp_prelimbed_matmul", "mp_paged_attention"):
        assert calls[name] > 0, (name, calls)


def _margins(rows):
    top2 = np.sort(np.stack(rows), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_scheduler_streams_match_jax_where_margins_allow(jax_params, params):
    """Both packages' schedulers on the same requests (mixed lengths, a
    late arrival): each stream agrees token for token up to the first step
    whose JAX top-2 margin is within M8's error budget."""
    je = _jengine(jax_params)
    pe = _engine(params)
    prompts = _prompts(4, [5, 3, 9])
    max_new = 5
    jsched = JScheduler(je, n_blocks=32, block_size=8)
    jdone = jsched.run([JRequest(rid=i, prompt=p, max_new=max_new,
                                 arrival=i // 2)
                        for i, p in enumerate(prompts)])
    psched = ContinuousScheduler(pe, n_blocks=32, block_size=8)
    pdone = psched.run([ScheduledRequest(rid=i, prompt=p, max_new=max_new,
                                         arrival=i // 2)
                        for i, p in enumerate(prompts)])
    jout = {r.rid: r.out for r in jdone}
    pout = {r.rid: r.out for r in pdone}
    compared = 0
    for i, p in enumerate(prompts):
        rows = _jax_rows(je, p, jout[i][:-1])
        tol = M8_BOUND * np.abs(rows[0]).max()
        for step, margin in enumerate(_margins(rows)):
            if margin <= tol:
                break  # a near-tie: the streams may part from here on
            assert pout[i][step] == jout[i][step], (i, step)
            compared += 1
    assert compared > 0
    assert psched.stats()["completed"] == jsched.stats()["completed"] == 3


def test_stats_keys_match_jax(jax_params, params):
    je = _jengine(jax_params)
    jsched = JScheduler(je, n_blocks=32, block_size=8)
    jsched.run([JRequest(rid=0, prompt=_prompts(5, [4])[0], max_new=2)])
    _, psched = _run(_engine(params), _prompts(5, [4]), 2)
    jkeys = {k for k in jsched.stats() if "mixed" not in k}
    assert set(psched.stats()) == jkeys


# =========================================================================
# the port's own bitwise invariants
# =========================================================================
def test_equal_length_batch_matches_static_generate(params):
    """Equal prompt lengths, one arrival batch: scheduled tokens == the
    static ``generate`` batch bit for bit (``ref`` backend: dense and paged
    decode attention run the same masked einsums there)."""
    eng = _engine(params, backend="ref")
    prompts = _prompts(0, [6, 6, 6, 6])
    static = eng.generate(prompts, max_new=6)
    got, _ = _run(eng, prompts, 6)
    for i in range(4):
        assert got[i] == static[i], i


@pytest.mark.parametrize("backend", ["ref", None])
def test_mixed_length_batch_matches_solo_runs(params, backend):
    """Mixed lengths decoding together: each stream equals its solo run —
    the solo static ``generate`` on ``ref``; on the kernels' route (plain
    versions here) the solo scheduled run, so micro-batch widths 4 and 1
    give the same bits."""
    eng = _engine(params, backend=backend)
    prompts = _prompts(1, [5, 3, 9, 2])
    if backend == "ref":
        solo = [eng.generate([p], max_new=5)[0] for p in prompts]
    else:
        solo = [_run(eng, [p], 5)[0][0] for p in prompts]
    got, sched = _run(eng, prompts, 5)
    for i in range(4):
        assert got[i] == solo[i], i
    assert sched.pool.n_live == 0
    assert sched.pool.n_free == sched.pool.n_blocks - 1


def test_join_evict_mid_stream_bit_identical(params):
    """A short request joining mid-stream and leaving before the others
    finish does not perturb the survivors' streams."""
    eng = _engine(params)
    long_prompts = _prompts(2, [4, 7])
    base, _ = _run(eng, long_prompts, 6)
    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
    reqs = [ScheduledRequest(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(long_prompts)]
    reqs.append(ScheduledRequest(rid=99, prompt=_prompts(3, [3])[0],
                                 max_new=2, arrival=2))
    got = {r.rid: r for r in sched.run(reqs)}
    assert len(got[99].out) == 2 and got[99].done_step < got[0].done_step
    for i in range(2):
        assert got[i].out == base[i], f"survivor {i} perturbed"


def test_prefill_pad_past_table_capacity_is_harmless(params):
    """prompt 10 + 2 new at block_size 4, 3 blocks per sequence: the pow2
    prefill bucket (16) outruns the table (12 positions); the padded tail
    goes to trash, not into the row's last real block."""
    eng = _engine(params, backend="ref")
    p = _prompts(11, [10])[0]
    solo = eng.generate([p], max_new=2)[0]
    sched = ContinuousScheduler(eng, n_blocks=16, block_size=4,
                                max_blocks_per_seq=3)
    done = sched.run([ScheduledRequest(rid=0, prompt=p, max_new=2)])
    assert done[0].out == solo


@pytest.fixture
def custom_format():
    fmt = register_format("M12QOSPT", mantissa_bits=12, n_limbs=2,
                          max_order=1)
    yield fmt
    unregister_format(fmt.name)


@pytest.mark.parametrize("backend", ["ref", None])
def test_mixed_mode_batch_matches_per_mode_solo(params, custom_format,
                                                backend):
    """M8, M23 and a registered custom format decoding concurrently from
    one engine (one partitioned-lane decode launch per tick): each stream
    equals its per-mode solo run (static ``generate`` at that policy on
    ``ref``, a solo scheduled run on the kernels' route)."""
    modes = ["M8", "M23", custom_format.name]
    prompts = _prompts(6, [5, 4, 6])
    eng = _engine(params, backend=backend)
    solo = []
    for p, m in zip(prompts, modes):
        if backend == "ref":
            e = _engine(params, backend=backend,
                        policy=PrecisionPolicy.serve_default().overlay(m))
            solo.append(e.generate([p], max_new=4)[0])
        else:
            solo.append(_run(eng, [p], 4, mode=m)[0][0])
    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
    done = sched.run([ScheduledRequest(rid=i, prompt=p, max_new=4, mode=m)
                      for i, (p, m) in enumerate(zip(prompts, modes))])
    got = {r.rid: r.out for r in done}
    for i in range(3):
        assert got[i] == solo[i], (i, modes[i])
    # every static-format request rides one launch per tick
    assert sched.stats()["launches_per_tick"] == 1.0


def test_request_policy_resolution():
    base = PrecisionPolicy.serve_default()
    ov = base.overlay("M23")
    for cls in ("qkv", "ffn", "attn_logits", "lm_head", "anything"):
        assert ov.mode(cls).name == "M23"
    pol = PrecisionPolicy.full_fp32()
    from repro_torch.core.context import resolve_request_policy
    assert resolve_request_policy(mode="M8", policy=pol.to_json()) == pol
    assert resolve_request_policy(base=base) == base
    patched = base.overlay({"lm_head": "M36"})
    assert patched.mode("lm_head").name == "M36"
    assert patched.mode("qkv") == base.mode("qkv")


class _M8Sentinel(GuardrailConfig):
    """The ``logit_bound`` sentinel on M8 requests only (bound 0 trips every
    M8 decode step; the escalated M16 steps run unpoliced)."""

    def bound_for(self, policy):
        if policy.mode("lm_head").name != "M8":
            return None
        return super().bound_for(policy)


def test_guardrail_trip_escalates_and_resumes(params):
    """An M8 request whose decode logits trip the sentinel is evicted alone,
    re-queued at M16, re-prefills prompt + out[:-1] and resumes consuming
    out[-1]: its suffix equals a solo M16 run resumed from the same
    prefix; its neighbour is untouched."""
    eng = _engine(params)
    prompts = _prompts(8, [5, 6])
    base, _ = _run(eng, prompts[1:], 5)
    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8,
                                guard=_M8Sentinel(logit_bound=0.0))
    reqs = [ScheduledRequest(rid=0, prompt=prompts[0], max_new=5, mode="M8"),
            ScheduledRequest(rid=1, prompt=prompts[1], max_new=5)]
    got = {r.rid: r for r in sched.run(reqs)}
    v = got[0]
    assert v.guard_trips == 1 and v.escalated_from == "M8"
    assert v.mode == "M16" and len(v.out) == 5
    assert v.recovery_prefixes == [1]
    assert got[1].out == base[0] and got[1].guard_trips == 0
    s = sched.stats()
    assert s["guard_trips"] == 1 and s["escalations"] == 1
    solo = ScheduledRequest(rid=7, prompt=prompts[0], max_new=5, mode="M16")
    solo.out = list(v.out[:1])
    ContinuousScheduler(eng, n_blocks=32, block_size=8).run([solo])
    assert solo.out == v.out
    # a guardrail with the real bound everywhere and no room to climb
    # fails loudly instead of cycling
    loud = ContinuousScheduler(eng, n_blocks=32, block_size=8,
                               guard=GuardrailConfig(
                                   logit_bound=0.0, max_trips_per_request=2))
    with pytest.raises(RuntimeError, match="guardrail"):
        loud.run([ScheduledRequest(rid=0, prompt=prompts[0], max_new=3)])


def test_flood_past_pool_capacity_is_graceful(params):
    """Nine requests at once against a pool that holds two: admission
    queues FIFO behind eviction reclaim, everything completes, no block
    leaks; a request the pool can never hold raises."""
    eng = _engine(params)
    sched = ContinuousScheduler(eng, n_blocks=5, block_size=8)
    done = sched.run([ScheduledRequest(rid=i, prompt=p, max_new=4)
                      for i, p in enumerate(_prompts(11, [3, 5, 7] * 3))])
    assert len(done) == 9 and all(len(r.out) == 4 for r in done)
    assert sched.pool.n_live == 0
    assert sched.pool.n_free == sched.pool.n_blocks - 1
    assert sched.n_active == 0 and sched.n_queued == 0
    tiny = ContinuousScheduler(eng, n_blocks=3, block_size=4,
                               max_blocks_per_seq=2)
    with pytest.raises(BlockPoolExhausted):
        tiny.run([ScheduledRequest(rid=0, prompt=_prompts(8, [20])[0],
                                   max_new=8)])


def test_lifecycle_eos_deadline_cancel_and_stats(params):
    eng = _engine(params)
    p = _prompts(9, [5])[0]
    ref_out = _run(eng, [p], 8)[0][0]
    got, sched = _run(eng, [p], 8, eos_token=ref_out[2])
    assert got[0] == ref_out[:3] and sched.pool.n_live == 0
    sched = ContinuousScheduler(eng, n_blocks=32, block_size=8)
    reqs = [ScheduledRequest(rid=i, prompt=q, max_new=4, arrival=i)
            for i, q in enumerate(_prompts(10, [3, 4, 5]))]
    reqs[1].deadline_ticks, reqs[1].max_new = 2, 40
    sched.submit(ScheduledRequest(rid=50, prompt=p, max_new=4))
    assert sched.cancel(50) and not sched.cancel(50)
    done = sched.run(reqs)
    s = sched.stats()
    assert {r.rid for r in done} == {0, 2}
    assert s["expired"] == 1 and s["canceled"] == 1 and s["completed"] == 2
    assert s["useful_tokens"] == 8 + len(sched.expired[0].out)
    assert s["blocks_live"] == 0
    assert s["prelimb_cache_misses"] == 1
    for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms", "itl_p95_ms",
              "queue_wait_p95_steps"):
        assert s[k] >= 0.0
    with pytest.raises(NotImplementedError, match="item 6"):
        sched.install_faults(None)
