"""AUTO mode (paper mode 1; port of ``repro.core.auto``): the controller
analyzes both operands and selects the cheapest adequate precision, then runs
exactly one static format.

Paper: "The optimum mode is selected by counting the number of zeroes after a
leading 1", i.e. how many significant mantissa bits the operands carry.
Tensor analogue: the smallest limb count whose rounding residual is
negligible (``limbs.significant_limbs``).  Both operands are analyzed and the
wider requirement wins (the paper's both-operands-must-agree rule).

The analysis runs on the operands' device.  Where the JAX package traces
every candidate into one ``lax.switch``, the port reads the selected index
back to the host once per AUTO call and launches the one selected format's
kernel: a device-to-host sync per call, counted in
``mp_matmul_auto.host_reads``.  A selection that stays on the device is later
work (ROADMAP.md).

Under autograd the selected format runs as the static differentiable
``mp_matmul`` with the caller's backward formats, so the gradient is the
chosen branch's at that branch's dgrad / wgrad formats, as in the JAX
package.  A rematerialized layer analyzes its operands again when the
backward recomputes it (on the autograd engine's thread): a
:class:`SelectionLog` records the forward's selections and the recompute
must make the same ones, or it raises.

The candidate set and analysis tolerance default to the active
:class:`~repro_torch.core.context.PrecisionContext` (``auto_candidates`` /
``auto_tol``); candidates may include run-time-registered formats.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import context as context_lib
from repro_torch.core import limbs as limbs_lib
from repro_torch.core.context import DEFAULT_AUTO_CANDIDATES
from repro_torch.core.formats import FormatLike, resolve

# the JAX package's back-compat alias (its v1 exposed the default candidate
# set from this module)
DEFAULT_CANDIDATES: Tuple = DEFAULT_AUTO_CANDIDATES


def _candidates_and_tol(candidates, tol) -> Tuple[tuple, float]:
    ctx = context_lib.current_context()
    if candidates is None:
        candidates = ctx.auto_candidates
    if tol is None:
        tol = ctx.auto_tol
    return tuple(candidates), float(tol)


def select_mode_index(a: torch.Tensor, b: torch.Tensor,
                      candidates: Optional[Sequence[FormatLike]] = None, *,
                      tol: Optional[float] = None) -> torch.Tensor:
    """0-d int32 index into ``candidates`` (the caller's order), computed on
    the operands' device: the mode-select controller.  The cheapest adequate
    candidate wins however the caller ordered the sequence."""
    candidates, tol = _candidates_and_tol(candidates, tol)
    specs = [resolve(c) for c in candidates]
    max_limbs = max(s.n_limbs for s in specs)
    ka = limbs_lib.significant_limbs(a, tol=tol, max_limbs=max_limbs)
    kb = limbs_lib.significant_limbs(b, tol=tol, max_limbs=max_limbs)
    k = torch.maximum(ka, kb)  # consensus: the wider requirement wins
    # scan candidates from most to least expensive, keeping the last (=
    # cheapest) adequate one; ``by_cost`` holds the caller's indices
    by_cost = sorted(range(len(specs)),
                     key=lambda i: (specs[i].n_limbs, specs[i].n_products))
    idx = torch.full((), by_cost[-1], dtype=torch.int32, device=k.device)
    for i in reversed(by_cost):
        idx = torch.where(specs[i].n_limbs >= k,
                          torch.full_like(idx, i), idx)
    return idx


class SelectionLog:
    """The AUTO selections of one rematerialized region: the forward
    records the index of each AUTO call in order (:meth:`recording`); the
    recompute in the backward must select the same index at each call
    (:meth:`replaying`), or :meth:`note` raises."""

    def __init__(self):
        self.indices: List[int] = []
        self._pos: Optional[int] = None  # None while recording

    @contextlib.contextmanager
    def recording(self):
        self.indices.clear()
        self._pos = None
        token = _active_log.set(self)
        try:
            yield self
        finally:
            _active_log.reset(token)

    @contextlib.contextmanager
    def replaying(self):
        self._pos = 0
        token = _active_log.set(self)
        try:
            yield self
            if self._pos != len(self.indices):
                raise RuntimeError(
                    f"AUTO recompute made {self._pos} selections, the "
                    f"forward {len(self.indices)}")
        finally:
            _active_log.reset(token)

    def note(self, idx: int) -> None:
        if self._pos is None:
            self.indices.append(idx)
            return
        want = (self.indices[self._pos] if self._pos < len(self.indices)
                else None)
        if idx != want:
            raise RuntimeError(
                f"AUTO recompute selected candidate {idx} at call "
                f"{self._pos}, the forward {want}")
        self._pos += 1


_active_log: contextvars.ContextVar[Optional[SelectionLog]] = \
    contextvars.ContextVar("repro_torch_auto_log", default=None)
_reads_lock = threading.Lock()  # the forward's thread and autograd's


def mp_matmul_auto(a: torch.Tensor, b: torch.Tensor,
                   candidates: Optional[Sequence[FormatLike]] = None, *,
                   backend: Optional[str] = None,
                   bwd_mode: Optional[FormatLike] = None,
                   dgrad_mode: Optional[FormatLike] = None,
                   wgrad_mode: Optional[FormatLike] = None,
                   tol: Optional[float] = None) -> torch.Tensor:
    """Run-time reconfigurable matmul: analyze on the device, read the
    selected index back once, run the one selected format (differentiable,
    at the given backward formats; each defaults to the selected one)."""
    from repro_torch.core import mpmatmul  # mpmatmul imports this module

    candidates, tol = _candidates_and_tol(candidates, tol)
    idx = select_mode_index(a, b, candidates, tol=tol)
    i = int(idx)  # the one host read of this call
    with _reads_lock:
        mp_matmul_auto.host_reads += 1
    log = _active_log.get()
    if log is not None:
        log.note(i)
    return mpmatmul.mp_matmul(a, b, resolve(candidates[i]), bwd_mode=bwd_mode,
                              dgrad_mode=dgrad_mode, wgrad_mode=wgrad_mode,
                              backend=backend)


mp_matmul_auto.host_reads = 0  # selected indices read back to the host


def auto_report(a: torch.Tensor, b: torch.Tensor,
                candidates: Optional[Sequence[FormatLike]] = None, *,
                tol: Optional[float] = None) -> dict:
    """Which mode AUTO would pick and why (observability helper).  ``tol``
    flows through to the same analysis the selection used."""
    candidates, tol = _candidates_and_tol(candidates, tol)
    idx = int(select_mode_index(a, b, candidates, tol=tol))
    mode = candidates[idx]
    fmt = resolve(mode)
    max_limbs = max(resolve(c).n_limbs for c in candidates)
    return {
        "selected_mode": mode,
        "selected_format": fmt.name,
        "mode_bits": fmt.mode_bits,
        "tol": tol,
        "sig_limbs_a": int(limbs_lib.significant_limbs(
            a, tol=tol, max_limbs=max_limbs)),
        "sig_limbs_b": int(limbs_lib.significant_limbs(
            b, tol=tol, max_limbs=max_limbs)),
        "residual_a_1limb": float(limbs_lib.residual_scale(a, 1)),
        "residual_b_1limb": float(limbs_lib.residual_scale(b, 1)),
    }
