"""Shared serving primitives (port of ``repro.serve.primitives``): the
request record, paged admission / step building blocks, the numerical
guardrail and latency accounting.

The control loop (:class:`~repro_torch.serve.scheduler.ContinuousScheduler`)
is a thin state machine over:

  * :func:`try_reserve` / :func:`release` — all-or-nothing block reservation
    against a :class:`~repro_torch.serve.kv_cache.PagedKVPool` (exhaustion is
    a scheduling event: the caller requeues behind eviction reclaim);
  * :func:`prefill_request` — one B=1 bucketed paged prefill producing the
    request's first output token;
  * :func:`decode_tick_plan` + :func:`decode_bucket_step` /
    :func:`decode_mixed_step` — one decode tick: every request with static
    formats rides ONE decode launch (the engine's paged step for a
    homogeneous group, its partitioned-lane mixed step for a heterogeneous
    one); only AUTO requests would bucket per policy;
  * the **numerical guardrail** — every step returns one max-|logit| scalar
    per slot; :func:`guard_check` turns it into a per-slot verdict and
    :func:`escalate_mode` is the recovery dial (M8 -> M16 -> M23);
  * :func:`latency_stats` — TTFT / TPOT / inter-token-latency / queue-wait
    percentiles over a completed set.

Each decode launch builds its table, lengths and tokens (and, mixed, its
two lane tables) as one small host array each (one device copy each) and
reads back the new tokens and the guard stats in one device-to-host copy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import context as context_lib
from repro_torch.core import lanes as lanes_lib
from repro_torch.core.formats import (
    available_formats, builtin_formats, get_format, is_auto)
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.serve.kv_cache import BlockPoolExhausted, PagedKVPool

# the guardrail's recovery dial: one mode UP on numerical divergence (the
# builtin serving ladder; registered custom formats climb the registry)
ESCALATE_CHAIN = {"M8": "M16", "M16": "M23"}


def _next_rung(cur: str) -> Optional[str]:
    """The next precision rung above ``cur``: the builtin chain when it
    applies, else the registered format with the smallest
    ``mantissa_bits`` strictly above the current one (ties: fewer limbs,
    then name).  None when ``cur`` is unknown, AUTO, or at the top."""
    nxt = ESCALATE_CHAIN.get(cur)
    if nxt is not None:
        return nxt
    if cur in builtin_formats():
        # builtin formats above the chain (M23/M36/M52) are the ceiling
        return None
    try:
        fmt = get_format(cur)
    except Exception:
        return None
    if is_auto(fmt):
        return None
    cands = [f for f in (get_format(n) for n in available_formats())
             if not is_auto(f) and f.mantissa_bits > fmt.mantissa_bits]
    if not cands:
        return None
    return min(cands, key=lambda f: (f.mantissa_bits, f.n_limbs, f.name)).name


@dataclasses.dataclass
class ScheduledRequest:
    """One serving request with its own precision QoS.

    ``mode`` is a single format spelling applied as a whole-network overlay
    on the engine's policy; ``policy`` is a full per-request
    :class:`PrecisionPolicy` (object or JSON wire form) and wins over
    ``mode``.  Leave both None to inherit the engine policy."""

    rid: int
    prompt: np.ndarray                      # (S,) int32
    max_new: int = 16
    mode: Optional[object] = None           # FormatLike QoS overlay
    policy: Optional[object] = None         # PrecisionPolicy | JSON
    eos_token: Optional[int] = None
    arrival: int = 0                        # virtual arrival step
    submitter: str = "default"              # completion fan-out tag
    deadline_ticks: Optional[int] = None    # TTL in virtual ticks from submit

    # runtime state (scheduler-owned)
    out: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"     # queued | running | done | expired | canceled
    slot: Optional[int] = None
    blocks: List[int] = dataclasses.field(default_factory=list)
    length: int = 0                         # tokens in the paged cache
    next_token: int = -1                    # decode input for the next step
    admitted_step: int = -1
    done_step: int = -1
    engine_id: int = -1
    requeues: int = 0
    downgraded_from: Optional[str] = None
    resolved_policy: Optional[PrecisionPolicy] = None  # cached at submit

    # fault-tolerance state
    submitted_tick: int = -1                # deadline epoch (virtual)
    recoveries: int = 0
    guard_trips: int = 0                    # numerical guardrail evictions
    escalated_from: Optional[str] = None    # original mode before escalation
    lost_tick: int = -1
    # len(out) at each re-admission
    recovery_prefixes: List[int] = dataclasses.field(default_factory=list)

    # wall-clock latency accounting (perf_counter seconds; -1 = unset)
    t_submit: float = -1.0
    t_first: float = -1.0
    t_done: float = -1.0
    itl: List[float] = dataclasses.field(default_factory=list)


def pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pow2_at_most(n: int) -> int:
    """Largest power of two <= n (n >= 1): the decode micro-batch width
    cap, so every decode launch runs a pow2-bucketed batch."""
    if n < 1:
        raise ValueError(f"micro-batch cap must be >= 1, got {n}")
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# numerical guardrail
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Per-slot decode-logit policing.  The finite check is always on;
    ``logit_bound`` adds the sentinel ``logit_bound * (1 +
    fmt.rel_err_bound)`` of the request's lm_head format.
    ``max_trips_per_request`` bounds how often one request may trip before
    the loop fails loudly."""

    logit_bound: Optional[float] = None
    max_trips_per_request: int = 5

    def bound_for(self, policy: PrecisionPolicy) -> Optional[float]:
        if self.logit_bound is None:
            return None
        fmt = policy.mode("lm_head")
        if is_auto(fmt):
            return None
        return self.logit_bound * (1.0 + float(fmt.rel_err_bound))


def guard_check(stat: np.ndarray, policy: PrecisionPolicy,
                guard: Optional[GuardrailConfig]) -> np.ndarray:
    """Per-slot verdict over the step's max-|logit| scalars: True =
    healthy (NaN/Inf surface as a non-finite max)."""
    ok = np.isfinite(stat)
    bound = guard.bound_for(policy) if guard is not None else None
    if bound is not None:
        ok &= ~(stat > bound)  # NaN-safe: non-finite rows already False
    return ok


def escalate_mode(req: ScheduledRequest) -> bool:
    """One step UP the precision ladder after a guardrail trip, recording
    the original mode; False when the request has no escalatable mode
    (full-policy or engine-default requests, top-of-ladder formats)."""
    if req.policy is not None or req.mode is None:
        return False
    cur = getattr(req.mode, "name", None) or str(req.mode)
    nxt = _next_rung(cur)
    if nxt is None:
        return False
    if req.escalated_from is None:
        req.escalated_from = cur
    req.mode = nxt
    req.resolved_policy = None  # re-resolve at the new mode
    return True


def deadline_expired(req: ScheduledRequest, tick: int) -> bool:
    """TTL check against the virtual clock (epoch: the submit tick)."""
    return (req.deadline_ticks is not None and req.submitted_tick >= 0
            and tick - req.submitted_tick >= req.deadline_ticks)


def resolve_request(req: ScheduledRequest, base: PrecisionPolicy
                    ) -> PrecisionPolicy:
    """Resolve + cache a request's effective policy (wire policies must not
    re-parse in the hot loop)."""
    if req.resolved_policy is None:
        req.resolved_policy = context_lib.resolve_request_policy(
            mode=req.mode, policy=req.policy, base=base)
    return req.resolved_policy


def blocks_needed(pool: PagedKVPool, req: ScheduledRequest) -> int:
    return pool.blocks_for_tokens(len(req.prompt) + req.max_new)


def validate_request(pool: PagedKVPool, req: ScheduledRequest) -> None:
    """Fail unschedulable requests now, not after the rest of the batch
    has run."""
    req.prompt = np.asarray(req.prompt, np.int32)
    if req.prompt.ndim != 1 or req.prompt.size == 0:
        raise ValueError("prompt must be a non-empty 1-D int32 array")
    if req.max_new < 1:
        raise ValueError("max_new must be >= 1")
    need = blocks_needed(pool, req)
    capacity = min(pool.max_blocks_per_seq, pool.n_blocks - 1)
    if need > capacity:
        raise BlockPoolExhausted(
            f"request {req.rid} needs {need} blocks "
            f"({len(req.prompt)} prompt + {req.max_new} new tokens) but "
            f"the pool can hold at most {capacity} per request")


def try_reserve(pool: PagedKVPool, req: ScheduledRequest) -> bool:
    """All-or-nothing reservation of a request's full block budget; False
    (never an exception, never a partial reservation) when the pool cannot
    meet it now."""
    blocks = pool.try_alloc(blocks_needed(pool, req))
    if blocks is None:
        return False
    req.blocks = blocks
    return True


def release(pool: PagedKVPool, req: ScheduledRequest) -> None:
    """Return a request's blocks to the free list (eviction / rollback)."""
    if req.blocks:
        pool.free(req.blocks)
        req.blocks = []


def table_width(pool: PagedKVPool, reqs: Sequence[ScheduledRequest]) -> int:
    """The block table a step gets is sliced to the group's maximum used
    block count (pow2-bucketed) instead of all ``max_blocks_per_seq``
    trash-padded columns.  Positions past the width still go to the trash
    block on write (models/attention._paged_write)."""
    used = max(len(r.blocks) for r in reqs)
    return min(pow2_at_least(used), pool.max_blocks_per_seq)


def prefill_tokens(req: ScheduledRequest) -> np.ndarray:
    """The sequence a prefill must write: the prompt for a fresh request;
    for a recovery re-prefill (``req.out`` non-empty) the prompt plus every
    emitted token but the last (the newest token's KV is written by the
    decode step that consumes it)."""
    if not req.out:
        return req.prompt
    return np.concatenate([req.prompt, np.asarray(req.out[:-1], np.int32)])


def prefill_request(engine, pool: PagedKVPool, req: ScheduledRequest) -> int:
    """One B=1 bucketed paged prefill: writes the request's K/V blocks into
    ``pool`` and returns the first output token (argmax of the true-last-
    position logits).  For a recovery re-prefill the caller discards the
    returned token (the emitted ``out[-1]`` stays the decode input)."""
    policy = resolve_request(req, engine.policy)
    prefill_fn, _ = engine.paged_steps_for(policy)
    seq = prefill_tokens(req)
    n = len(seq)
    tokens = np.zeros((1, pow2_at_least(n)), np.int64)
    tokens[0, :n] = seq
    table = pool.table_row(req.blocks)[None, :table_width(pool, [req])]
    lengths = np.zeros((1,), np.int32)
    logits, _stat, new_k, new_v = prefill_fn(
        engine.params, pool.k, pool.v, engine.to_device(table),
        engine.to_device(lengths), engine.to_device(tokens), n - 1)
    pool.update(new_k, new_v)
    req.length = n
    tok = int(logits[0, 0].argmax())
    if req.t_first < 0:
        req.t_first = time.perf_counter()
    return tok


def bucket_by_policy(reqs: Sequence[ScheduledRequest],
                     base: PrecisionPolicy
                     ) -> List[Tuple[PrecisionPolicy,
                                     List[ScheduledRequest]]]:
    """Group active requests by resolved policy: one micro-batch per
    bucket, each routed through its policy's paged decode step."""
    buckets: Dict[PrecisionPolicy, List[ScheduledRequest]] = {}
    for req in reqs:
        buckets.setdefault(resolve_request(req, base), []).append(req)
    return list(buckets.items())


def decode_tick_plan(reqs: Sequence[ScheduledRequest],
                     base: PrecisionPolicy
                     ) -> List[Tuple[str, List[ScheduledRequest]]]:
    """Partition one tick's active requests into decode launches: shape
    bucketing, not format bucketing.

    Every lane-eligible request (all decode op classes at static formats)
    joins ONE group whatever its format: a homogeneous group keeps the
    per-policy step (``("bucket", reqs)``, no lane tables to carry), a
    heterogeneous group becomes one partitioned-lane launch
    (``("mixed", reqs)``, :func:`decode_mixed_step`).  Only AUTO-policy
    requests bucket per policy (their formats are chosen per operand inside
    the step, so there is no static lane).  Under any non-AUTO traffic mix
    the plan is one launch per tick."""
    eligible: List[ScheduledRequest] = []
    rest: List[ScheduledRequest] = []
    for r in reqs:
        pol = resolve_request(r, base)
        (eligible if lanes_lib.lanes_eligible(pol) else rest).append(r)
    plan: List[Tuple[str, List[ScheduledRequest]]] = []
    if eligible:
        pols = {resolve_request(r, base) for r in eligible}
        plan.append(("bucket" if len(pols) == 1 else "mixed", eligible))
    for _, group in bucket_by_policy(rest, base):
        plan.append(("bucket", group))
    return plan


def decode_bucket_step(engine, pool: PagedKVPool,
                       reqs: Sequence[ScheduledRequest], *,
                       max_slots: int, guard=None, injector=None,
                       cell_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One decode launch for one policy bucket: builds the pow2-padded
    (table, lengths, tokens) micro-batch, runs the step, advances each
    request's cache length, and returns ``(tokens, ok)`` — one new token
    and one guardrail verdict per request.  A False verdict means the
    slot's logits are poisoned: the caller discards that token and evicts
    only that slot (its length and ITL do not advance)."""
    cap = pow2_at_most(max_slots)
    if len(reqs) > cap:
        return _chunked_steps(
            lambda part: decode_bucket_step(
                engine, pool, part, max_slots=cap, guard=guard,
                injector=injector, cell_id=cell_id), reqs, cap)
    mb = min(pow2_at_least(len(reqs)), cap)
    table, lengths, tokens, _ = _micro_batch(pool, reqs, mb)
    policy = resolve_request(reqs[0], engine.policy)
    _, decode_fn = engine.paged_steps_for(policy)
    params = engine._decode_params_for(policy)
    logits, stat, new_k, new_v = decode_fn(
        params, pool.k, pool.v, engine.to_device(table),
        engine.to_device(lengths), engine.to_device(tokens))
    pool.update(new_k, new_v)
    toks, stat_np = _tokens_and_stats(logits, stat, len(reqs))
    ok = guard_check(stat_np, policy, guard)
    _finish_decode_rows(reqs, ok, injector, cell_id)
    return toks, ok


def decode_mixed_step(engine, pool: PagedKVPool,
                      reqs: Sequence[ScheduledRequest], *,
                      max_slots: int, guard=None, injector=None,
                      cell_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """ONE partitioned-lane decode launch over a heterogeneous group: every
    request runs at its own resolved (non-AUTO) format inside a single
    step, the paper's run-time reconfigurable datapath partitioned over the
    micro-batch instead of bucketed into one launch per format.

    The group's lane envelope (per-op-class max limbs / order) keys the
    engine's step; the per-slot formats travel as (C, B) int32 lane tables
    (one device copy each), so any format mix under the envelope reuses one
    step.  Weights come from the pre-limb cache at the envelope's batch-max
    limb depth: decomposition is depth-stable, so a shallow lane reads the
    same limbs as its homogeneous bucket.  Guardrail verdicts are
    per-request (each request's own lm_head bound).  Same return contract,
    padding and ITL accounting as :func:`decode_bucket_step`."""
    cap = pow2_at_most(max_slots)
    if len(reqs) > cap:
        return _chunked_steps(
            lambda part: decode_mixed_step(
                engine, pool, part, max_slots=cap, guard=guard,
                injector=injector, cell_id=cell_id), reqs, cap)
    mb = min(pow2_at_least(len(reqs)), cap)
    table, lengths, tokens, _ = _micro_batch(pool, reqs, mb)
    policies = [resolve_request(r, engine.policy) for r in reqs]
    env = lanes_lib.envelope_of(policies)
    lane_n, lane_ord = lanes_lib.lane_tables(policies, mb)
    decode_fn = engine.mixed_decode_step_for(env)
    params = engine._decode_params_for_limbs(env.max_limbs)
    logits, stat, new_k, new_v = decode_fn(
        params, pool.k, pool.v, engine.to_device(table),
        engine.to_device(lengths), engine.to_device(tokens),
        engine.to_device(lane_n), engine.to_device(lane_ord))
    pool.update(new_k, new_v)
    toks, stat_np = _tokens_and_stats(logits, stat, len(reqs))
    ok = np.asarray([bool(guard_check(stat_np[i:i + 1], pol, guard)[0])
                     for i, pol in enumerate(policies)])
    _finish_decode_rows(reqs, ok, injector, cell_id)
    return toks, ok


def _tokens_and_stats(logits: torch.Tensor, stat: torch.Tensor, n: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The greedy tokens and guard stats of a decode launch's first ``n``
    rows, in one device-to-host copy."""
    host = torch.stack([logits[:, -1].argmax(dim=-1).double(),
                        stat.double()]).cpu().numpy()
    return host[0][:n].astype(np.int64), host[1][:n]


def _micro_batch(pool: PagedKVPool, reqs: Sequence[ScheduledRequest],
                 mb: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The pow2-padded (table, lengths, tokens) host arrays of one decode
    launch; padded rows are (trash row, length 0, token 0) so they read
    nothing and write to trash."""
    w = table_width(pool, reqs)
    table = np.stack(
        [pool.table_row(r.blocks) for r in reqs]
        + [pool.trash_row()] * (mb - len(reqs)))[:, :w]
    lengths = np.asarray([r.length for r in reqs]
                         + [0] * (mb - len(reqs)), np.int32)
    tokens = np.asarray([[r.next_token] for r in reqs]
                        + [[0]] * (mb - len(reqs)), np.int64)
    return table, lengths, tokens, w


def _finish_decode_rows(reqs: Sequence[ScheduledRequest], ok: np.ndarray,
                        injector, cell_id: int) -> None:
    """Post-step bookkeeping: injected-fault verdicts, cache-length
    advance, per-token ITL accounting (rows that tripped advance
    nothing)."""
    if injector is not None:
        for i, r in enumerate(reqs):
            if ok[i] and injector.step_nan(cell_id, r.slot, r.rid):
                ok[i] = False
    now = time.perf_counter()
    for r, good in zip(reqs, ok):
        if not good:
            continue
        r.length += 1
        prev = r.t_first if not r.itl else r.t_first + sum(r.itl)
        r.itl.append(now - prev)


def _chunked_steps(step_fn, reqs: Sequence[ScheduledRequest], cap: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    parts = [step_fn(list(reqs[i:i + cap]))
             for i in range(0, len(reqs), cap)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


# ---------------------------------------------------------------------------
# latency accounting
# ---------------------------------------------------------------------------
def _pcts(values: List[float], unit: float = 1.0) -> Tuple[float, float]:
    if not values:
        return 0.0, 0.0
    arr = np.asarray(values, np.float64) * unit
    return (round(float(np.percentile(arr, 50)), 3),
            round(float(np.percentile(arr, 95)), 3))


def latency_stats(completed: Sequence[ScheduledRequest]) -> Dict[str, float]:
    """Per-request latency percentiles over a completed set: TTFT (submit
    -> first token) and TPOT (mean decode time per output token after the
    first) in wall-clock ms, ITL the pooled per-token intervals in ms,
    queue-wait in virtual steps (admitted - arrival)."""
    ttft = [r.t_first - r.t_submit for r in completed
            if r.t_first >= 0 and r.t_submit >= 0]
    tpot = [(r.t_done - r.t_first) / (len(r.out) - 1) for r in completed
            if r.t_done >= 0 and r.t_first >= 0 and len(r.out) > 1]
    itl = [dt for r in completed for dt in r.itl]
    qwait = [float(r.admitted_step - r.arrival) for r in completed
             if r.admitted_step >= 0]
    out: Dict[str, float] = {}
    for name, vals, unit in (("ttft_ms", ttft, 1e3), ("tpot_ms", tpot, 1e3),
                             ("itl_ms", itl, 1e3),
                             ("queue_wait_steps", qwait, 1.0)):
        metric, suffix = name.rsplit("_", 1)
        out[f"{metric}_p50_{suffix}"], out[f"{metric}_p95_{suffix}"] = \
            _pcts(vals, unit)
    return out
