"""Dispatch-level work accounting (the port's counterpart of
``repro.analysis.hlo_parser``, which reads FLOPs and bytes from XLA's HLO).

The port has no compiled program to read, so it counts the work its own
code runs: inside ``with count_work() as w:`` every call of

  ``core.dispatch.dispatch``            kind ``matmul``
  ``core.dispatch.dispatch_fused``      kind ``fused`` (one activation,
                                        n_out weights, the epilogue)
  ``core.dispatch.dispatch_attention``  kind ``attention``
  ``core.mpmatmul._wgrad``'s one-product weight gradient
                                        kind ``wgrad`` (``ref.mp_wgrad_ref``,
                                        which runs outside dispatch)
  ``kernels.mp_matmul.mp_decompose``    kind ``decompose``

reports its shapes and formats, on every backend (``cuda``, ``ref``,
``sharded``) and every device (the card, the CPU, ``meta``), so the same
forward counts the same integers wherever it runs.  Under ``sharded`` a
call reports the part this rank runs: a K-sharded matmul its K-slice
(``dispatch._sharded_2d``), a sequence-parallel decode attention its
T-slice (``dist.attention.sp_decode_attention``).  The paged and mixed-lane
decode routes (the scheduler's) do not report: their work depends on the
slots' lengths, which live on the device.

What one call counts:

* FLOPs: ``2 * batch * M * N * K * n_products`` for a matmul (every kept
  limb product is one bf16 tensor-core product), summed over the weights of
  a fused call; zero for a decompose.  Attention counts its two products,
  ``QK^T`` at the QK format and ``P V`` at the PV format, over the (query,
  key) pairs a row can see: all ``S * T`` without ``causal``; with it, row
  ``s`` sees ``min(T, q_offset + s + 1)`` positions.  So a causal call counts
  the work the kernel must do, not the masked rectangle.  Softmax, norms and
  the other elementwise work are not counted (as ``hlo_parser`` counts dots
  only).
* Bytes: each operand read once and each output written once, at the
  dtype it has (a pre-limbed weight: the limb planes the format reads; a
  two-float operand: both halves); the model the kernels' bound column in
  PERF.md uses.
* Collective bytes by kind: the difference of ``dist.collectives.counts()``
  over the counted region (``all_reduce``, ``all_gather``, ...).

Counters are process-wide (the training backward runs on the autograd
engine's thread), so count one region at a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.formats import resolve

# the base collectives of dist/collectives.py (the composed psums call them)
COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                    "all_to_all", "broadcast", "send", "recv")


@dataclasses.dataclass(frozen=True)
class Call:
    """One reported call: its kind, shape (``N`` summed over a fused call's
    weights), formats and work."""

    kind: str
    batch: int
    M: int
    K: int
    N: int
    formats: Tuple[str, ...]
    flops: int
    bytes: int


@dataclasses.dataclass
class Work:
    """The work of one counted region."""

    calls: List[Call] = dataclasses.field(default_factory=list)
    collective_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> int:
        return sum(c.flops for c in self.calls)

    @property
    def bytes(self) -> int:
        return sum(c.bytes for c in self.calls)

    @property
    def coll_bytes(self) -> int:
        return sum(self.collective_bytes.values())

    def by_kind(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for c in self.calls:
            d = out.setdefault(c.kind, {"calls": 0, "flops": 0, "bytes": 0})
            d["calls"] += 1
            d["flops"] += c.flops
            d["bytes"] += c.bytes
        return out

    def summary(self) -> dict:
        """The integers a dry-run record and the card's check compare."""
        return {"calls": len(self.calls), "flops": self.flops,
                "bytes": self.bytes, "by_kind": self.by_kind(),
                "collective_bytes": dict(self.collective_bytes),
                "collective_calls": dict(self.collective_calls)}


_ACTIVE: List[Work] = []
_LOCK = threading.Lock()
_PAUSE = threading.local()


def _collective_counts() -> Dict[str, Dict[str, int]]:
    from repro_torch.dist import collectives

    got = collectives.counts()
    return {k: got[k] for k in COLLECTIVE_KINDS}


@contextlib.contextmanager
def count_work():
    """Count the work of every dispatch call (and collective) in the
    scope; yields the :class:`Work`, complete when the scope ends."""
    work = Work()
    before = _collective_counts()
    with _LOCK:
        _ACTIVE.append(work)
    try:
        yield work
    finally:
        with _LOCK:
            _ACTIVE.remove(work)
        after = _collective_counts()
        for k in COLLECTIVE_KINDS:
            db = after[k]["bytes"] - before[k]["bytes"]
            dc = after[k]["calls"] - before[k]["calls"]
            if dc:
                work.collective_bytes[k] = db
                work.collective_calls[k] = dc


@contextlib.contextmanager
def paused():
    """A scope of this thread whose calls are already counted by the call
    that runs them (a registered backend's fused call, run per branch)."""
    depth = getattr(_PAUSE, "depth", 0)
    _PAUSE.depth = depth + 1
    try:
        yield
    finally:
        _PAUSE.depth = depth


def _record(call: Call) -> None:
    if getattr(_PAUSE, "depth", 0):
        return
    with _LOCK:
        for w in _ACTIVE:
            w.calls.append(call)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _operand(x, n_limbs: int) -> Tuple[Tuple[int, ...], int]:
    """(logical shape, bytes read) of a matmul operand."""
    from repro_torch.core.limbs import DD, PrelimbedWeight

    if isinstance(x, PrelimbedWeight):
        planes = min(int(x.limbs.shape[-3]), n_limbs)
        shape = tuple(x.shape)
        return shape, planes * _numel(shape) * x.limbs.element_size()
    if isinstance(x, DD):
        return tuple(x.shape), 2 * _numel(x.shape) * x.hi.element_size()
    return tuple(x.shape), x.numel() * x.element_size()


def record_matmul(a, b, mode, *, out_planes: int = 1) -> None:
    """One ``dispatch`` call: a (..., M, K) @ b (..., K, N).  A 2-D ``b``
    folds ``a``'s leading dims into M (one matmul, as the kernels run it);
    a batched ``b`` broadcasts the batch dims.  Under ``sharded`` the call
    is this rank's K-slice, whose output is ``out_planes`` (the orders)
    f32 planes."""
    if not _ACTIVE:
        return
    fmt = resolve(mode)
    sa, ba = _operand(a, fmt.n_limbs)
    sb, bb = _operand(b, fmt.n_limbs)
    K, N = sb[-2], sb[-1]
    if len(sb) == 2:
        batch, M = 1, _numel(sa[:-1])
    else:
        batch = _numel(torch.broadcast_shapes(sa[:-2], sb[:-2]))
        M = sa[-2]
    flops = 2 * batch * M * N * K * fmt.n_products
    _record(Call("matmul", batch, M, K, N, (fmt.name,), flops,
                 ba + bb + 4 * out_planes * batch * M * N))


def record_fused(x, ws: Sequence, mode, *, gate: str = "none", biases=None,
                 residual=None) -> None:
    """One ``dispatch_fused`` call: x (..., K) against n_out (K, N_t)
    weights; the epilogue's bias / residual reads and its outputs (one
    (M, N) tensor when gated, else one per weight)."""
    if not _ACTIVE:
        return
    fmt = resolve(mode)
    sx, bx = _operand(x, fmt.n_limbs)
    M, K = _numel(sx[:-1]), sx[-1]
    nbytes, flops, n_sum = bx, 0, 0
    for w in ws:
        sw, bw = _operand(w, fmt.n_limbs)
        nbytes += bw
        flops += 2 * M * sw[-1] * K * fmt.n_products
        n_sum += sw[-1]
    for t in tuple(biases or ()) + ((residual,) if residual is not None
                                    else ()):
        nbytes += t.numel() * t.element_size()
    out_cols = ws[0].shape[-1] if gate != "none" else n_sum
    nbytes += 4 * M * out_cols
    _record(Call("fused", 1, M, K, n_sum, (fmt.name,), flops, nbytes))


def visible_pairs(S: int, T: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs of one head: row s sees min(T, q_offset + s + 1)
    positions under ``causal``, all T without."""
    if not causal:
        return S * T
    n1 = max(0, min(S, T - q_offset))   # rows whose window ends inside T
    return n1 * q_offset + n1 * (n1 + 1) // 2 + (S - n1) * T


def record_attention(q, k, v, mode_qk, mode_pv, *, causal: bool,
                     q_offset: int = 0) -> None:
    """One ``dispatch_attention`` call: q (B, S, H, Dh) against k / v
    (B, T, H, Dh)."""
    if not _ACTIVE:
        return
    fq, fp = resolve(mode_qk), resolve(mode_pv)
    B, S, H, Dh = (int(d) for d in q.shape)
    T = int(k.shape[1])
    pairs = B * H * visible_pairs(S, T, causal, int(q_offset))
    flops = 2 * pairs * Dh * (fq.n_products + fp.n_products)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + 4 * B * S * H * Dh
    _record(Call("attention", B * H, S, Dh, T, (fq.name, fp.name), flops,
                 nbytes))


def record_wgrad(x, dr, mode) -> None:
    """One weight gradient as one product over every token
    (``ref.mp_wgrad_ref``): x (..., K) and dr (..., N) -> (K, N)."""
    if not _ACTIVE:
        return
    fmt = resolve(mode)
    tokens, K, N = _numel(x.shape[:-1]), int(x.shape[-1]), int(dr.shape[-1])
    flops = 2 * tokens * K * N * fmt.n_products
    nbytes = (x.numel() * x.element_size() + dr.numel() * dr.element_size()
              + 4 * K * N)
    _record(Call("wgrad", 1, K, tokens, N, (fmt.name,), flops, nbytes))


def record_decompose(w, n_limbs: int) -> None:
    """One decompose: (..., C) f32 read, n_limbs bf16 planes written."""
    if not _ACTIVE:
        return
    n = w.numel()
    _record(Call("decompose", 1, n, 0, int(n_limbs), (f"L{n_limbs}",), 0,
                 4 * n + 2 * n_limbs * n))

