"""Partitioned-lane mixed-format decode: one launch, per-slot precision
(port of ``repro.core.lanes``).

The paper's datapath reconfigures per *operand* at run time; the serving
analogue is a decode micro-batch whose slots carry different precision
policies.  Instead of splitting the batch into per-format buckets (one
decode launch each), the mixed path runs every slot ("lane") inside ONE
launch at the batch-max limb depth, and each lane leaves out the limb
products outside its own format.

Three pieces live here:

* :class:`LaneEnvelope` — the static per-op-class ``(n_limbs, max_order)``
  ceiling of a batch.  It keys the engine's mixed-step cache: two batches
  with the same envelope share a step whichever formats sit in which lane,
  so a mode joining mid-stream builds nothing new while it fits under the
  envelope.
* the lane tables — ``(C, B)`` int32 arrays of per-slot ``n_limbs`` /
  ``max_order`` per op class, built on the host with numpy and copied to
  the device once per tick (one copy each).
* :class:`LaneCtx` + the ``lane_scope`` contextvar — how the per-lane data
  reaches the model's projection and attention call sites without a new
  argument through every layer signature.

The masking arithmetic (which limb products a lane keeps, and the two
accumulation disciplines) is in ``kernels/ref.py`` (:func:`lane_keep`,
:func:`masked_matmul_limbs`); the CUDA kernels apply the same predicate.
This module imports only numpy and the port's format registry.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from functools import lru_cache
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.formats import MPFormat, is_auto, resolve

# Op classes a decode step resolves per lane: the row order of the lane
# tables.  ``attn_qk``/``attn_pv`` resolve through the policy's aliases
# (``attn_logits``/``attn_out``) as the homogeneous path does.
DECODE_OP_CLASSES: Tuple[str, ...] = (
    "qkv", "attn_qk", "attn_pv", "attn_out", "ffn", "lm_head")

_CLASS_INDEX = {c: i for i, c in enumerate(DECODE_OP_CLASSES)}

# Lane value for padded (trash) slots: 1 limb, order 0, the cheapest legal
# format.  Padded rows compute values nobody reads either way.
PAD_LANE = (1, 0)


@lru_cache(maxsize=None)
def envelope_format(n_limbs: int, max_order: int) -> MPFormat:
    """The (unregistered) format a mixed launch computes at.

    Two incomparable lane formats, say (3 limbs, order 1) and (2 limbs,
    order 2), have a componentwise envelope that matches no registered
    format, so the envelope is minted directly.  Only ``n_limbs`` and
    ``max_order`` (the product set) matter to the kernels;
    ``mantissa_bits`` is nominal."""
    return MPFormat(f"LANE_ENV_{n_limbs}_{max_order}",
                    mantissa_bits=8 * n_limbs, n_limbs=n_limbs,
                    max_order=max_order)


class LaneEnvelope(NamedTuple):
    """Per-op-class componentwise max of (n_limbs, max_order) over a batch.

    Hashable and static: it keys the mixed decode step cache
    (``ServeEngine.mixed_decode_step_for``).  Every lane's product set
    ``{(i, j): i, j < n, i + j <= ord}`` is a subset of its envelope's, and
    in the envelope's product order the lane's products keep their own
    relative order — what the masked accumulation relies on."""

    limbs: Tuple[int, ...]    # len == len(DECODE_OP_CLASSES)
    orders: Tuple[int, ...]

    def fmt(self, op_class: str) -> MPFormat:
        i = _CLASS_INDEX[op_class]
        return envelope_format(self.limbs[i], self.orders[i])

    @property
    def max_limbs(self) -> int:
        """Batch-max limb depth: the key of the pre-limbed weight cache."""
        return max(self.limbs)


class LaneCtx(NamedTuple):
    """The lane context of one mixed decode step: the static envelope and
    the device lane tables.

    ``lane_n`` / ``lane_ord`` are (C, B) int32 tensors on the step's device
    (C indexes :data:`DECODE_OP_CLASSES`, B is the micro-batch); a class's
    row is a contiguous (B,) view, handed to the kernels in place."""

    env: LaneEnvelope
    lane_n: Any      # (C, B) int32
    lane_ord: Any    # (C, B) int32

    def for_class(self, op_class: str):
        """(envelope format, per-slot n_limbs (B,), per-slot max_order (B,))."""
        i = _CLASS_INDEX[op_class]
        return self.env.fmt(op_class), self.lane_n[i], self.lane_ord[i]


_ACTIVE: ContextVar[Optional[LaneCtx]] = ContextVar("repro_torch_lanes",
                                                    default=None)


def current_lanes() -> Optional[LaneCtx]:
    """The active lane context, or None outside a mixed decode step."""
    return _ACTIVE.get()


@contextmanager
def lane_scope(ctx: LaneCtx):
    """Install ``ctx`` for the dynamic extent of a mixed decode step."""
    token = _ACTIVE.set(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.reset(token)


def lanes_eligible(policy) -> bool:
    """True when every decode op class resolves to a static (non-AUTO)
    format; AUTO lanes need per-operand analysis and stay on the per-policy
    bucket path."""
    return all(not is_auto(policy.mode(c)) for c in DECODE_OP_CLASSES)


def lane_format(policy, op_class: str) -> MPFormat:
    return resolve(policy.mode(op_class))


def lane_tables(policies: Sequence, width: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (C, width) int32 lane tables for a resolved-policy batch.

    Rows beyond ``len(policies)`` are padding slots at :data:`PAD_LANE`."""
    C = len(DECODE_OP_CLASSES)
    lane_n = np.full((C, width), PAD_LANE[0], np.int32)
    lane_ord = np.full((C, width), PAD_LANE[1], np.int32)
    for b, pol in enumerate(policies):
        for ci, cls in enumerate(DECODE_OP_CLASSES):
            f = lane_format(pol, cls)
            lane_n[ci, b] = f.n_limbs
            lane_ord[ci, b] = f.max_order
    return lane_n, lane_ord


def envelope_of(policies: Sequence) -> LaneEnvelope:
    """Componentwise per-class envelope of a batch's resolved policies."""
    limbs, orders = [], []
    for cls in DECODE_OP_CLASSES:
        fmts = [lane_format(p, cls) for p in policies]
        limbs.append(max((f.n_limbs for f in fmts), default=PAD_LANE[0]))
        orders.append(max((f.max_order for f in fmts), default=PAD_LANE[1]))
    return LaneEnvelope(tuple(limbs), tuple(orders))
