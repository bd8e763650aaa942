"""PyTorch port: partitioned-lane mixed-format decode (port of
``repro.core.lanes``, the masked functions of ``repro.kernels.ref``, the
Pallas ``_mixed_prelimbed_kernel`` and ``_mixed_paged_kernel``, the mixed
dispatch routes and ``ServeEngine.mixed_decode_step_for``), held against
the JAX package on the same numpy inputs and against its own invariants.

The port runs on the CPU (``device="cpu"``), where the kernel wrappers run
their plain versions.  Tolerances: the mixed matmul against JAX's
interpret-mode kernel at tests/test_kernels.py's kernel-vs-oracle tolerance
and the mixed paged attention at tests/test_mp_attention.py's
same-blocking 2e-5 (``torch_parity``): both sides sum the same exact limb
products in another f32 order.  Mixed decode logits are held like
tests/test_torch_scheduler.py's paged decode logits (M8's ``rel_err_bound``
2^-6 of their scale: the M8 lanes round activations to bf16).  Inside the
port the invariants are bitwise, as the JAX suite's
(tests/test_mixed_decode.py): a lane row is its homogeneous row, and a
request's stream does not depend on which formats decode beside it.

Not here: ``test_auto_requests_still_bucket_apart`` of the JAX suite waits
for AUTO, which the port takes up in slice 4 (ROADMAP.md); until then the
port's ops raise ``NotImplementedError`` on AUTO."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mpfp as jconfigs
from repro.core import dispatch as jdispatch
from repro.core import formats as jformats
from repro.core import lanes as jlanes
from repro.core.limbs import prelimb_weight as jprelimb_weight
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.kernels import mp_attention as jattn
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import kernels
from repro_torch.configs import paper_mpfp as pconfigs
from repro_torch.core import dispatch as pdispatch
from repro_torch.core import lanes as planes
from repro_torch.core.formats import register_format, resolve
from repro_torch.core.limbs import prelimb_weight
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.kernels import mp_attention as pattn
from repro_torch.kernels import mp_matmul as pmm
from repro_torch.kernels import ops as pops
from repro_torch.serve import primitives as prim
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kv_cache import TRASH_BLOCK
from repro_torch.serve.scheduler import ContinuousScheduler, \
    ScheduledRequest
from repro_torch.weights import params_from_jax
from torch_parity import assert_attention_close, assert_matmul_close

CFG_J, CFG_P = jconfigs.SMOKE, pconfigs.SMOKE
M8_BOUND = resolve("M8").rel_err_bound
BUILTINS = ("M8", "M16", "M23", "M36", "M52")
# a custom 2-limb format that keeps all four products (M16 keeps three): a
# lane whose limb cut and order cut both bind under a 3-limb envelope
CUSTOM = dict(name="M16FULLQ", mantissa_bits=16, n_limbs=2, max_order=2)


def _custom():
    """The custom format in both registries (registration is idempotent)."""
    spec = dict(CUSTOM)
    name = spec.pop("name")
    jformats.register_format(name, **spec)
    return register_format(name, **spec)


@pytest.fixture(scope="module")
def jax_params():
    return JT.init_params(CFG_J, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _engine(params, backend=None, policy=None, max_batch=8):
    return ServeEngine(CFG_P, params, max_batch=max_batch, max_seq=64,
                       policy=policy or PrecisionPolicy.serve_default(),
                       matmul_backend=backend, device="cpu")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG_P.vocab, size=s).astype(np.int32)
            for s in sizes]


def _run(eng, prompts, modes, *, max_new=3, arrivals=None):
    sched = ContinuousScheduler(eng, n_blocks=48, block_size=8)
    arrivals = arrivals or [0] * len(prompts)
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    done = sched.run([
        ScheduledRequest(rid=i, prompt=p, max_new=n, mode=m, arrival=a)
        for i, (p, m, a, n) in enumerate(
            zip(prompts, modes, arrivals, news))])
    return {r.rid: r.out for r in done}, sched


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lanes(fmts, pad=0):
    """(B,) int32 lane vectors for per-row formats, ``pad`` PAD_LANE rows
    after them."""
    n = [f.n_limbs for f in fmts] + [planes.PAD_LANE[0]] * pad
    o = [f.max_order for f in fmts] + [planes.PAD_LANE[1]] * pad
    return np.asarray(n, np.int32), np.asarray(o, np.int32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# =========================================================================
# lane tables and envelopes against the JAX package
# =========================================================================
@pytest.mark.parametrize("modes", [
    ("M8", "M16"), ("M8", "M36", "M16"), ("M23", CUSTOM["name"]),
    ("M52", "M8", CUSTOM["name"], "M16")], ids="-".join)
def test_lane_tables_and_envelope_match_jax(modes):
    _custom()
    jp = [JPolicy.serve_default().overlay(m) for m in modes]
    pp = [PrecisionPolicy.serve_default().overlay(m) for m in modes]
    assert planes.DECODE_OP_CLASSES == jlanes.DECODE_OP_CLASSES
    assert planes.PAD_LANE == jlanes.PAD_LANE
    for width in (len(modes), 8):
        for p, j in zip(planes.lane_tables(pp, width),
                        jlanes.lane_tables(jp, width)):
            assert p.dtype == j.dtype == np.int32
            np.testing.assert_array_equal(p, j)
    penv, jenv = planes.envelope_of(pp), jlanes.envelope_of(jp)
    assert tuple(penv) == tuple(jenv) and penv.max_limbs == jenv.max_limbs
    for cls in planes.DECODE_OP_CLASSES:
        assert penv.fmt(cls).name == jenv.fmt(cls).name
    assert all(planes.lanes_eligible(p) for p in pp)


# =========================================================================
# the two kernels' plain versions against JAX's interpret-mode kernels
# =========================================================================
@pytest.mark.parametrize("prelimbed", [False, True], ids=["raw", "prelimbed"])
@pytest.mark.parametrize("K,N", [(128, 96), (200, 77)])
def test_mixed_matmul_matches_jax_kernel(prelimbed, K, N):
    """``ops.mp_mixed_matmul`` (the mixed pre-limbed kernel's plain version)
    against JAX ``dispatch_mixed_matmul(backend="pallas_interpret")`` (the
    ``_mixed_prelimbed_kernel``) on lanes M8/M16/M23/M36 plus a pad row."""
    fmts = [resolve(m) for m in ("M8", "M16", "M23", "M36")]
    env = planes.envelope_format(5, 4)
    ln, lo = _lanes(fmts, pad=1)
    x = _rand(K + N, len(ln), 1, K)
    w = _rand(K - N, K, N)
    jw = jnp.asarray(w)
    pw = torch.from_numpy(w)
    if prelimbed:
        pw = prelimb_weight(pw, env.n_limbs)
        jw = jprelimb_weight(jw, env.n_limbs)
    j = jdispatch.dispatch_mixed_matmul(
        jnp.asarray(x), jw, jlanes.envelope_format(5, 4), jnp.asarray(ln),
        jnp.asarray(lo), backend="pallas_interpret")
    before = pmm.mp_mixed_prelimbed_matmul.plain_calls
    p = pops.mp_mixed_matmul(torch.from_numpy(x), pw, env,
                             torch.from_numpy(ln), torch.from_numpy(lo))
    assert pmm.mp_mixed_prelimbed_matmul.plain_calls == before + 1
    assert p.shape == (len(ln), 1, N)
    assert_matmul_close(p, np.asarray(j))


def _paged_inputs(seed, lengths, H=4, Hkv=4, n_blocks=20, bs=4, W=4, Dh=16):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, Hkv, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, Hkv, Dh)).astype(np.float32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    table = np.full((B, W), TRASH_BLOCK, np.int32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // bs)):
            table[b, j] = free.pop()
    return q, kp, vp, table, np.asarray(lengths, np.int32)


# per-slot (qk, pv) formats of the paged cases: every serving builtin, a
# custom format, and a slot at the envelope's own depth
SLOT_FORMATS = [("M16", "M8"), ("M8", "M8"), ("M23", "M16"),
                (CUSTOM["name"], "M23"), ("M16", CUSTOM["name"])]


def _slot_lanes(slot_formats):
    qk = [resolve(a) for a, _ in slot_formats]
    pv = [resolve(b) for _, b in slot_formats]
    env_qk = planes.envelope_format(max(f.n_limbs for f in qk),
                                    max(f.max_order for f in qk))
    env_pv = planes.envelope_format(max(f.n_limbs for f in pv),
                                    max(f.max_order for f in pv))
    return qk, pv, env_qk, env_pv, (*_lanes(qk), *_lanes(pv))


@pytest.mark.parametrize("hkv,lengths", [(4, (5, 0, 13, 16, 2)),
                                         (2, (16, 9, 1, 0, 12))])
def test_mixed_paged_plain_matches_jax_kernel(hkv, lengths):
    _custom()
    _, _, env_qk, env_pv, lanes = _slot_lanes(SLOT_FORMATS)
    q, kp, vp, table, ln = _paged_inputs(hkv + sum(lengths), lengths,
                                         Hkv=hkv)
    j = jattn.mp_mixed_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(ln), jlanes.envelope_format(env_qk.n_limbs,
                                                env_qk.max_order),
        jlanes.envelope_format(env_pv.n_limbs, env_pv.max_order),
        *(jnp.asarray(x) for x in lanes), interpret=True)
    before = pattn.mp_mixed_paged_attention.plain_calls
    p = pattn.mp_mixed_paged_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, table, ln)), env_qk,
        env_pv, *(torch.from_numpy(x) for x in lanes))
    assert pattn.mp_mixed_paged_attention.plain_calls == before + 1
    assert_attention_close(p, np.asarray(j))
    for b, n in enumerate(lengths):
        if n == 0:  # an empty slot flushes exact zeros
            assert not p[b].any()


# =========================================================================
# the slice as a whole: one mixed decode step against JAX's
# =========================================================================
def test_mixed_decode_step_logits_match_jax(jax_params, params):
    """JAX ``mixed_decode_step_for`` (``ref`` backend) and the port's
    (kernels' route, plain versions) on the same pool contents, block
    table, lengths, tokens and lanes (M8, M16, M23, custom): the logits
    agree within M8's budget, and the port's step is the one launch per
    call site of the mixed-lane kernels."""
    _custom()
    modes = ("M8", "M16", "M23", CUSTOM["name"])
    B, L = len(modes), CFG_P.n_layers
    hk, dh = CFG_P.n_kv_heads, CFG_P.resolved_head_dim
    rng = np.random.default_rng(31)
    shape = (L, 24, 8, hk, dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lengths = np.asarray([5, 17, 9, 12], np.int32)
    table = np.full((B, 4), TRASH_BLOCK, np.int32)
    free = list(rng.permutation(np.arange(1, 24)))
    for b, n in enumerate(lengths):
        table[b, :n // 8 + 1] = [free.pop() for _ in range(n // 8 + 1)]
    tokens = rng.integers(0, CFG_P.vocab, size=(B, 1)).astype(np.int32)
    je = JEngine(CFG_J, jax_params, max_batch=4, max_seq=32,
                 matmul_backend="ref", prelimb_weights=False)
    pe = _engine(params, max_batch=4)
    jpols = [JPolicy.serve_default().overlay(m) for m in modes]
    ppols = [PrecisionPolicy.serve_default().overlay(m) for m in modes]
    jenv, penv = jlanes.envelope_of(jpols), planes.envelope_of(ppols)
    jl, _, _, _ = je.mixed_decode_step_for(jenv)(
        je._decode_params_for_limbs(jenv.max_limbs), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(table), jnp.asarray(lengths),
        jnp.asarray(tokens), *map(jnp.asarray, jlanes.lane_tables(jpols, B)))
    kernels.reset_launch_counts()
    pl, pstat, _, _ = pe.mixed_decode_step_for(penv)(
        pe._decode_params_for_limbs(penv.max_limbs),
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(table),
        torch.from_numpy(lengths), torch.from_numpy(tokens.astype(np.int64)),
        *map(torch.from_numpy, planes.lane_tables(ppols, B)))
    jl = np.asarray(jl)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=0,
                               atol=M8_BOUND * np.abs(jl).max())
    np.testing.assert_array_equal(pstat.numpy(),
                                  np.abs(pl.numpy()[:, -1]).max(-1))
    calls = kernels.plain_call_counts()
    assert calls["mp_mixed_prelimbed_matmul"] == 7 * L + 1, calls
    assert calls["mp_mixed_paged_attention"] == L, calls
    assert calls["mp_prelimbed_matmul"] == calls["mp_paged_attention"] == 0


# =========================================================================
# the port's own invariants, bitwise (tests/test_mixed_decode.py)
# =========================================================================
LANE_FORMATS = ("M8", "M16", "M23", "M36", CUSTOM["name"])


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_lane_rows_match_homogeneous(backend):
    """A row at k limbs inside a wide (envelope-depth) launch equals the same
    row of a homogeneous k-limb call, on the raw and the pre-limbed weight;
    on the kernels' route (plain versions) down to the sign of zero."""
    _custom()
    fmts = [resolve(m) for m in LANE_FORMATS]
    env = planes.envelope_format(max(f.n_limbs for f in fmts),
                                 max(f.max_order for f in fmts))
    ln, lo = (torch.from_numpy(x) for x in _lanes(fmts, pad=1))
    a = torch.from_numpy(_rand(7, len(ln), 128))
    a[0, :3] = torch.tensor([0.0, -0.0, 1e-30])
    b = torch.from_numpy(_rand(8, 128, 96))
    for w in (b, prelimb_weight(b, env.n_limbs)):
        mixed = pdispatch.dispatch_mixed_matmul(a, w, env, ln, lo,
                                                backend=backend)
        for i, f in enumerate(fmts):
            homo = pdispatch.dispatch(a, w, f, backend=backend)
            if backend == "cuda":
                assert torch.equal(_bits(mixed[i]), _bits(homo[i])), f.name
            else:
                assert torch.equal(mixed[i], homo[i]), f.name


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_lane_slots_match_homogeneous_paged(backend):
    """A slot of the mixed paged attention equals the homogeneous paged
    attention at the slot's formats (both routes; length-0 slot
    included)."""
    _custom()
    qk, pv, env_qk, env_pv, lanes = _slot_lanes(SLOT_FORMATS)
    q, kp, vp, table, ln = _paged_inputs(11, (5, 0, 13, 16, 2), Hkv=2)
    q4 = torch.from_numpy(q[:, None])
    pools = [torch.from_numpy(x) for x in (kp, vp, table, ln)]
    mixed = pdispatch.dispatch_mixed_paged_attention(
        q4, *pools, env_qk, env_pv, *(torch.from_numpy(x) for x in lanes),
        backend=backend)
    for b, (fq, fp) in enumerate(zip(qk, pv)):
        homo = pdispatch.dispatch_paged_attention(q4, *pools, fq, fp,
                                                  backend=backend)
        assert torch.equal(mixed[b], homo[b]), (b, fq.name, fp.name)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_envelope_depth_lane_is_unmasked(backend):
    """Every lane at the envelope's own depth: the mixed call is the
    homogeneous call."""
    f = resolve("M23")
    a = torch.from_numpy(_rand(9, 4, 128))
    b = torch.from_numpy(_rand(10, 128, 128))
    ln = torch.full((4,), f.n_limbs, dtype=torch.int32)
    lo = torch.full((4,), f.max_order, dtype=torch.int32)
    mixed = pdispatch.dispatch_mixed_matmul(a, b, f, ln, lo, backend=backend)
    assert torch.equal(mixed, pdispatch.dispatch(a, b, f, backend=backend))


def test_envelope_of_is_componentwise_max():
    pols = [PrecisionPolicy.serve_default().overlay(m)
            for m in ("M8", "M36", "M16")]
    env = planes.envelope_of(pols)
    f36 = resolve("M36")
    assert env.max_limbs == f36.n_limbs
    for cls in planes.DECODE_OP_CLASSES:
        assert (env.fmt(cls).n_limbs, env.fmt(cls).max_order) == \
            (f36.n_limbs, f36.max_order)


@pytest.mark.parametrize("backend", ["ref", None])
def test_every_builtin_mode_plus_custom_one_launch(params, backend):
    """All five builtin modes and a custom format decoding together: ONE
    decode launch per tick, each request's tokens equal to its solo run
    (static ``generate`` at its policy on ``ref``; a solo scheduled run on
    the kernels' route)."""
    modes = list(BUILTINS) + [_custom().name]
    prompts = _prompts(20, [5, 4, 6, 3, 5, 4])
    solo = []
    for p, m in zip(prompts, modes):
        if backend == "ref":
            e = _engine(params, backend="ref",
                        policy=PrecisionPolicy.serve_default().overlay(m))
            solo.append(e.generate([p], max_new=3)[0])
        else:
            solo.append(_run(_engine(params), [p], [m])[0][0])
    eng = _engine(params, backend=backend)
    kernels.reset_launch_counts()
    got, sched = _run(eng, prompts, modes)
    for i, m in enumerate(modes):
        assert got[i] == solo[i], m
    s = sched.stats()
    assert s["launches_per_tick"] == 1.0
    assert s["decode_launches"] == sched.decode_ticks
    if backend is None:
        calls = kernels.plain_call_counts()
        assert calls["mp_mixed_paged_attention"] > 0
        assert calls["mp_mixed_prelimbed_matmul"] > 0


@pytest.mark.parametrize("backend", ["ref", None])
def test_mixed_step_bit_identical_to_per_bucket_path(params, backend,
                                                     monkeypatch):
    """The one partitioned-lane launch emits exactly the tokens of the
    one-launch-per-format plan: shape bucketing changes the launch count,
    not the numbers."""
    modes = ["M8", "M23", "M16", "M8"]
    prompts = _prompts(22, [5, 3, 6, 4])
    eng = _engine(params, backend=backend)
    mixed, sched_mixed = _run(eng, prompts, modes, max_new=4)
    assert sched_mixed.stats()["launches_per_tick"] == 1.0

    def per_policy_plan(reqs, base):
        return [("bucket", group)
                for _, group in prim.bucket_by_policy(reqs, base)]

    monkeypatch.setattr(prim, "decode_tick_plan", per_policy_plan)
    bucketed, sched_bucket = _run(eng, prompts, modes, max_new=4)
    assert sched_bucket.stats()["launches_per_tick"] > 1.0
    assert mixed == bucketed


def test_submission_order_invariance(params):
    """Lane assignment is a routing detail: permuting the submission order
    of a fixed mixed workload changes no request's tokens."""
    modes = ["M8", "M16", _custom().name]
    prompts = _prompts(23, [5, 4, 3])
    eng = _engine(params)
    baseline = None
    for perm in itertools.permutations(range(3)):
        sched = ContinuousScheduler(eng, n_blocks=48, block_size=8)
        done = sched.run([ScheduledRequest(rid=i, prompt=prompts[i],
                                           max_new=3, mode=modes[i])
                          for i in perm])
        got = {r.rid: r.out for r in done}
        if baseline is None:
            baseline = got
        assert got == baseline, perm
        assert sched.stats()["launches_per_tick"] == 1.0


def test_mode_join_reuses_batch_max_limb_trace(params):
    """A shallower mode joining a deeper stream mid-flight: the mixed step's
    envelope has the deep mode's limb depth, so the pre-limbed weights and
    the single mixed step are reused (nothing rebuilt, nothing evicted),
    and a repeat run is bit for bit the first."""
    eng = _engine(params)
    misses_cold = eng.prelimb_cache_misses  # __init__ warms the default
    prompts = _prompts(26, [5, 3])
    modes = ["M23", "M16"]
    arrivals = [0, 2]
    news = [6, 2]  # M16 joins and leaves while M23 streams
    got1, _ = _run(eng, prompts, modes, max_new=news, arrivals=arrivals)
    # one new prelimb entry: the mixed step's depth (3 limbs) is the key
    # the homogeneous M23 bucket already made; the M16 join added nothing
    assert eng.prelimb_cache_misses == misses_cold + 1
    assert len(eng._mixed_step_cache) == 1
    traces = eng.trace_events
    step_misses = eng.step_cache_misses
    got2, _ = _run(eng, prompts, modes, max_new=news, arrivals=arrivals)
    assert got2 == got1
    assert eng.trace_events == traces, "a step was rebuilt on the join"
    assert eng.step_cache_misses == step_misses
    assert eng.prelimb_cache_misses == misses_cold + 1
    assert eng.prelimb_cache_hits > 0
