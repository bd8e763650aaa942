"""Serving engine (port of ``repro.serve.engine``): the static-batch
``generate`` path and the paged prefill / decode steps the continuous
scheduler (``serve/scheduler.py``) drives.

``generate`` left-pads a batch of prompts to one length (with token 0; causal
attention attends to those pads, as in the JAX package), prefills a dense
KV cache in one forward over the padded batch, then runs ``max_new`` greedy
decode steps, one token per slot each.  Precision follows the engine's
``PrecisionPolicy`` (``serve_default`` unless given), hot-swappable with
:meth:`ServeEngine.set_policy`.  Kernels run on the device the engine was
built for: ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version.

Weight pre-limbing (on by default, as in the JAX package): decode is
matmul-bound at tiny M (one token per slot), so the engine decomposes the
dense-path weights ONCE per (policy limb count, params) with the decompose
kernel (``kernels/ops.decompose_weights``, one launch per matrix) and runs
decode steps against :class:`~repro_torch.core.limbs.PrelimbedWeight`
operands, which dispatch routes to the pre-limbed matmul kernel.  Prefill
keeps the raw weights (the fused projection kernels limb a whole group's
operand once).  AUTO policies skip pre-limbing.

Mixed-format decode (:meth:`ServeEngine.mixed_decode_step_for`): a decode
micro-batch whose slots carry different static formats runs as ONE step,
each slot at its own format through the partitioned-lane kernels
(``core/lanes.py``), on weights pre-limbed at the batch's deepest limb
count.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import context as context_lib
from repro_torch.core import lanes as lanes_lib
from repro_torch.core.formats import is_auto
from repro_torch.core.limbs import PrelimbedWeight
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models import transformer as T

# op classes whose weights sit on the decode dense path (the pre-limb set)
_PRELIMB_CLASSES = ("qkv", "attn_out", "ffn", "lm_head")

# params groups -> weight leaves that feed mp_dense 1:1 (safe to carry as
# limb stacks)
_PRELIMB_LEAVES = {"mlp": ("w_gate", "w_up", "w_down"),
                   "attn": ("wq", "wk", "wv", "wo")}


def _policy_prelimb_limbs(policy: PrecisionPolicy) -> Optional[int]:
    """Max limb count any decode-path forward format needs, or None when an
    AUTO rule makes pre-limbing unusable (AUTO analyzes raw values)."""
    n = 1
    for c in _PRELIMB_CLASSES:
        mode = policy.mode(c)
        if is_auto(mode):
            return None
        n = max(n, mode.n_limbs)
    return n


def prelimb_dense_params(params: dict, n_limbs: int) -> dict:
    """Decompose the dense-path weight matrices of a params tree into
    :class:`PrelimbedWeight` limb stacks (one-time, per policy limb count):
    one decompose launch per matrix, 7 per layer plus ``lm_head``.  Other
    leaves pass through untouched (shared, not copied)."""
    from repro_torch.kernels import ops

    def leaf(w):
        return PrelimbedWeight(ops.decompose_weights(w, n_limbs))

    def layer(lp):
        out = dict(lp)
        for group, keys in _PRELIMB_LEAVES.items():
            if isinstance(lp.get(group), dict):
                out[group] = {k: leaf(w) if k in keys else w
                              for k, w in lp[group].items()}
        return out

    out = dict(params)
    out["layers"] = [layer(lp) for lp in params["layers"]]
    if isinstance(out.get("lm_head"), dict) and "w" in out["lm_head"]:
        out["lm_head"] = {**out["lm_head"], "w": leaf(out["lm_head"]["w"])}
    return out


def make_prefill_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """(params, inputs, cache) -> (last-position logits (B, 1, V), cache)."""
    def prefill_step(params, inputs, cache):
        logits, new_cache = T.forward(params, inputs, cfg, policy, cache=cache)
        return logits[:, -1:, :], new_cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """(params, cache, tokens (B, 1)) -> (logits (B, 1, V), cache)."""
    def serve_step(params, cache, tokens):
        return T.forward(params, {"tokens": tokens}, cfg, policy, cache=cache)

    return serve_step


def make_paged_prefill_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """Prefill one (micro-batch of) fresh request(s) into the paged pool.

    ``table`` (B, W) / ``lengths`` (B,) int32 are the scheduler's slot state
    (lengths are 0: paged prefill targets fresh slots); ``last_idx`` is the
    true prompt length minus one: prompts are padded to a shape bucket, the
    padded tail's writes land past the reservation (trash, or positions
    rewritten before any read) and the returned logits row is the real last
    token's.  The pool is written in place.

    Returns ``(last_logits (B, 1, V), guard_stat (B,), pool_k, pool_v)``:
    ``guard_stat`` is the per-slot max |logit| the numerical guardrail
    polices (``amax`` propagates NaN, so non-finite logits surface as a
    non-finite stat)."""
    def step(params, pool_k, pool_v, table, lengths, tokens, last_idx: int):
        cache = T.paged_cache(pool_k, pool_v, table, lengths)
        logits, _ = T.forward(params, {"tokens": tokens}, cfg, policy,
                              cache=cache)
        last = logits[:, last_idx:last_idx + 1]
        stat = last[:, 0].abs().amax(dim=-1)
        return last, stat, pool_k, pool_v

    return step


def make_paged_decode_step(cfg: ModelConfig, policy: PrecisionPolicy):
    """One decode step over a compacted micro-batch of active slots.

    Padded / inactive rows are (all-trash row, length 0): their reads mask
    to nothing and their writes land in the trash block.  Returns
    ``(logits (B, 1, V), guard_stat (B,), pool_k, pool_v)``."""
    def step(params, pool_k, pool_v, table, lengths, tokens):
        cache = T.paged_cache(pool_k, pool_v, table, lengths)
        logits, _ = T.forward(params, {"tokens": tokens}, cfg, policy,
                              cache=cache)
        stat = logits[:, -1].abs().amax(dim=-1)
        return logits, stat, pool_k, pool_v

    return step


def make_mixed_decode_step(cfg: ModelConfig,
                           envelope: lanes_lib.LaneEnvelope):
    """One partitioned-lane decode step: a micro-batch whose slots run at
    different (non-AUTO) formats inside ONE step.

    ``envelope`` is the static per-op-class (n_limbs, max_order) ceiling
    and keys the step cache, so any batch that fits under it shares the
    step whichever formats sit in which lane.  ``lane_n`` / ``lane_ord``
    are (C, B) int32 device tensors (C = ``lanes.DECODE_OP_CLASSES``): a
    slot changing format between ticks is new data, not a new step.  The
    lane context rides a contextvar around the forward, so the model's call
    sites find it with ``lanes.current_lanes()``.

    The policy given to the model (``serve_default``) only carries the
    non-lane ops, all format-free at S == 1; every format-sensitive
    contraction reads the lane tables.  Same ``(logits, guard_stat,
    pool_k, pool_v)`` return as :func:`make_paged_decode_step`."""
    carrier = PrecisionPolicy.serve_default()

    def step(params, pool_k, pool_v, table, lengths, tokens, lane_n,
             lane_ord):
        cache = T.paged_cache(pool_k, pool_v, table, lengths)
        ctx = lanes_lib.LaneCtx(envelope, lane_n, lane_ord)
        with lanes_lib.lane_scope(ctx):
            logits, _ = T.forward(params, {"tokens": tokens}, cfg, carrier,
                                  cache=cache)
        stat = logits[:, -1].abs().amax(dim=-1)
        return logits, stat, pool_k, pool_v

    return step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


class ServeEngine:
    """Batched greedy generation over a dense KV cache of ``max_batch``
    slots x ``max_seq`` positions, and the paged prefill / decode steps of
    the continuous scheduler.

    ``prelimb_weights`` (default True, as in the JAX package): decode steps
    run on the pre-limbed params of the active policy (decomposed once per
    (limb count, params), eagerly at construction and on
    :meth:`set_policy`); False decodes on the raw weights.
    ``matmul_backend`` names the dispatch backend (``"cuda"``, the kernels,
    unless the active context says otherwise; ``"ref"`` for the oracle)."""

    # distinct policies whose step pairs stay resident (LRU beyond this)
    MAX_POLICY_CACHE = 8

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_seq: int = 512, policy: Optional[PrecisionPolicy] = None,
                 matmul_backend: Optional[str] = None,
                 prelimb_weights: bool = True, device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run the plain "
                               "versions on the CPU")
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prelimb_weights = prelimb_weights
        self.matmul_backend = (matmul_backend
                               or context_lib.current_context().backend)
        self._step_cache: Dict[PrecisionPolicy, Tuple] = {}
        self._paged_step_cache: Dict[PrecisionPolicy, Tuple] = {}
        self._mixed_step_cache: Dict[lanes_lib.LaneEnvelope, Tuple] = {}
        # observability: step pairs built (the JAX engine counts jit traces
        # here; PyTorch runs eagerly, so a step built is the analogue) and
        # step / prelimb cache reuse, folded into the scheduler's stats()
        self.trace_events = 0
        self.step_cache_hits = 0
        self.step_cache_misses = 0
        self.prelimb_cache_hits = 0
        self.prelimb_cache_misses = 0
        # (n_limbs, id(params)) -> prelimbed params: the id guards against a
        # live params swap leaving decode on stale limb stacks
        self._prelimb_cache: Dict[Tuple[int, int], dict] = {}
        self.set_policy(policy or context_lib.current_context().policy
                        or PrecisionPolicy.serve_default())

    def set_policy(self, policy: Union[PrecisionPolicy, str, bytes, dict]
                   ) -> PrecisionPolicy:
        """Hot-swap the precision policy for all subsequent steps (accepts a
        ``PrecisionPolicy`` or its JSON wire form).  Returns it."""
        if not isinstance(policy, PrecisionPolicy):
            policy = PrecisionPolicy.from_json(policy)
        self.policy = policy
        self._prefill, self._decode = self._steps_for(policy)
        self._decode_params_for(policy)  # warm the prelimb cache eagerly
        return policy

    # ---- step caches -------------------------------------------------------
    def _pinned(self, fn):
        """Run a step without autograd under the engine's backend."""
        def wrapped(*args):
            with torch.no_grad(), \
                    context_lib.context(backend=self.matmul_backend):
                return fn(*args)

        return wrapped

    def _cached_steps(self, cache: Dict, key, factories: Tuple) -> Tuple:
        """LRU discipline for the step caches: touch on hit, evict the
        oldest past MAX_POLICY_CACHE, build (backend pinned) on miss."""
        if key in cache:
            cache[key] = cache.pop(key)  # LRU touch
            self.step_cache_hits += 1
        else:
            self.step_cache_misses += 1
            while len(cache) >= self.MAX_POLICY_CACHE:
                cache.pop(next(iter(cache)))
            self.trace_events += len(factories)
            cache[key] = tuple(self._pinned(make(self.cfg, key))
                               for make in factories)
        return cache[key]

    def _steps_for(self, policy: PrecisionPolicy) -> Tuple:
        """(prefill, decode) pair of the static path for one policy."""
        return self._cached_steps(self._step_cache, policy,
                                  (make_prefill_step, make_serve_step))

    def paged_steps_for(self, policy: PrecisionPolicy) -> Tuple:
        """(paged_prefill, paged_decode) pair for one policy: the continuous
        scheduler resolves a policy per request and routes each decode
        bucket through its policy's pair.  Dense GQA models only."""
        if self.cfg.family != "dense" or self.cfg.mla is not None:
            raise NotImplementedError(
                f"paged serving supports dense GQA models only "
                f"(family={self.cfg.family!r})")
        return self._cached_steps(
            self._paged_step_cache, policy,
            (make_paged_prefill_step, make_paged_decode_step))

    def mixed_decode_step_for(self, envelope: lanes_lib.LaneEnvelope):
        """The partitioned-lane decode step for one lane envelope.  The
        envelope, not the format mix, keys the cache, so a mode joining
        mid-stream reuses the batch-max step instead of building (and
        perhaps evicting) per-policy entries.  Dense GQA models only."""
        if self.cfg.family != "dense" or self.cfg.mla is not None:
            raise NotImplementedError(
                f"paged serving supports dense GQA models only "
                f"(family={self.cfg.family!r})")
        return self._cached_steps(self._mixed_step_cache, envelope,
                                  (make_mixed_decode_step,))[0]

    @property
    def _decode_params(self):
        """Decode-step params, resolved lazily so a live ``eng.params`` swap
        can never leave decode on stale limb stacks."""
        return self._decode_params_for(self.policy)

    def _decode_params_for(self, policy: PrecisionPolicy):
        """Decode-step params: the dense-path weights as limb stacks,
        decomposed ONCE per (policy limb count, params) and cached; the raw
        params under AUTO policies or when pre-limbing is off."""
        return self._decode_params_for_limbs(_policy_prelimb_limbs(policy))

    def _decode_params_for_limbs(self, n: Optional[int]):
        """Pre-limbed decode params at an explicit limb depth, keyed by
        (n_limbs, id(params)); a miss drops entries of older params."""
        if not self.prelimb_weights or n is None:
            return self.params
        key = (n, id(self.params))
        if key in self._prelimb_cache:
            self.prelimb_cache_hits += 1
        else:
            self.prelimb_cache_misses += 1
            for k in [k for k in self._prelimb_cache
                      if k[1] != id(self.params)]:
                del self._prelimb_cache[k]
            with torch.no_grad():
                self._prelimb_cache[key] = prelimb_dense_params(
                    self.params, n)
        return self._prelimb_cache[key]

    def cache_stats(self) -> Dict[str, int]:
        """Step / prelimb cache counters (merged into the scheduler's
        ``stats()``)."""
        return {
            "trace_events": self.trace_events,
            "step_cache_hits": self.step_cache_hits,
            "step_cache_misses": self.step_cache_misses,
            "prelimb_cache_hits": self.prelimb_cache_hits,
            "prelimb_cache_misses": self.prelimb_cache_misses,
        }

    def to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host array to the engine's device (one copy)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def make_cache(self) -> T.ModelCache:
        return T.make_cache(self.cfg, self.max_batch, self.max_seq,
                            dtype=torch.float32, device=self.device)

    def prefill(self, tokens: np.ndarray, cache: T.ModelCache):
        """Run the prefill step on (max_batch, L) tokens under the engine's
        backend (raw weights)."""
        toks = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self._prefill(self.params, {"tokens": toks}, cache)

    def decode(self, cache: T.ModelCache, tokens: torch.Tensor):
        """Run one decode step on (max_batch, 1) tokens (on the pre-limbed
        params unless pre-limbing is off)."""
        return self._decode(self._decode_params, cache, tokens)

    def pad_prompts(self, prompts: List[np.ndarray]) -> np.ndarray:
        """Left-pad prompts with token 0 into a (max_batch, L) batch."""
        B = len(prompts)
        if not 1 <= B <= self.max_batch:
            raise ValueError(f"{B} prompts for {self.max_batch} slots")
        L = max(len(p) for p in prompts)
        toks = np.zeros((self.max_batch, L), np.int64)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p
        return toks

    def generate(self, prompts: List[np.ndarray], max_new: int = 16
                 ) -> List[List[int]]:
        """Batched greedy generation: pads prompts to one bucket, prefills
        the cache, then runs ``max_new`` decode steps."""
        B = len(prompts)
        toks = self.pad_prompts(prompts)
        if toks.shape[1] + max_new > self.max_seq:
            raise ValueError(f"prompt {toks.shape[1]} + {max_new} new tokens "
                             f"exceed max_seq {self.max_seq}")
        cache = self.make_cache()
        logits, cache = self.prefill(toks, cache)
        cur = logits[:, -1, :].argmax(dim=-1)[:, None]
        outs: List[List[int]] = [[] for _ in range(B)]
        for _ in range(max_new):
            host = cur[:B, 0].tolist()
            for i in range(B):
                outs[i].append(int(host[i]))
            logits, cache = self.decode(cache, cur)
            cur = logits[:, -1, :].argmax(dim=-1)[:, None]
        return outs

    def decode_throughput_probe(self, steps: int = 8) -> Dict[str, float]:
        """Timing probe: decode tokens/s at the full slot batch."""
        cache = self.make_cache()
        tok = torch.zeros((self.max_batch, 1), dtype=torch.long,
                          device=self.device)
        logits, cache = self.decode(cache, tok)  # warm-up (kernel builds)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = self.decode(cache, tok)
        self._sync()
        dt = time.perf_counter() - t0
        return {"tokens_per_s": self.max_batch * steps / dt,
                "ms_per_step": dt / steps * 1e3}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
