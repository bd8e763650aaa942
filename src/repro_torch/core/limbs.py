"""bf16 limb decomposition (PyTorch port of ``repro.core.limbs``).

``decompose(x, k)`` splits an fp32 tensor into ``k`` bf16 limbs with
``x ~= sum_i limbs[i]`` where limb ``i`` carries mantissa bits ``[8i, 8(i+1))``.
Rounding the input to ``k`` limbs *is* the paper's "rounding of bits before
multiplication".  ``Tensor.to(torch.bfloat16)`` rounds to nearest even, the
same rounding XLA applies, so the cascade is bitwise equal to the JAX one.

For operands wider than fp32 (the paper's modes 5 and 6) a two-float
("double-double", DD) operand ``(hi, lo)`` with ``value = hi + lo`` carries
about 49 mantissa bits; ``decompose_dd`` extracts up to 7 limbs from it.
``significant_limbs`` is the AUTO controller's operand analysis.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import numpy as np
import torch


class DD(NamedTuple):
    """Two-float operand: value = hi + lo, |lo| <= ulp(hi)/2, both f32."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.hi.shape

    @property
    def ndim(self) -> int:
        return self.hi.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.hi.dtype

    @property
    def device(self) -> torch.device:
        return self.hi.device


def dd_from_f64(x64: np.ndarray,
                device: Union[str, torch.device] = "cuda") -> DD:
    """Split a float64 numpy array into a DD pair on ``device`` (the card
    unless the caller asks for ``"cpu"``)."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return DD(torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def dd_to_f64(d: DD) -> np.ndarray:
    return (d.hi.detach().cpu().numpy().astype(np.float64)
            + d.lo.detach().cpu().numpy().astype(np.float64))


class PrelimbedWeight(NamedTuple):
    """A weight operand carried as its pre-extracted bf16 limb stack.

    ``limbs`` has shape (..., L, K, N): the last three dims are the limb
    stack of one (K, N) matrix.  Serving decomposes each decode weight ONCE
    per (policy, params); decode matmuls then read the stored limbs instead
    of re-limbing the weight every step.  Inference only.  A format needing
    more limbs than were stored computes at the stored precision (missing
    limbs are zero); extra stored limbs are ignored."""

    limbs: torch.Tensor  # (..., L, K, N) bf16

    @property
    def shape(self) -> torch.Size:
        """Shape of the weight *value* the limb stack represents."""
        return self.limbs.shape[:-3] + self.limbs.shape[-2:]

    @property
    def ndim(self) -> int:
        return self.limbs.ndim - 1

    @property
    def n_limbs(self) -> int:
        return self.limbs.shape[-3]


def prelimb_weight(w: torch.Tensor, n_limbs: int) -> PrelimbedWeight:
    """Plain-PyTorch prelimb of a (..., K, N) weight: the oracle of the
    decompose kernel (``kernels/ops.decompose_weights``)."""
    stacked = decompose(w, n_limbs)  # (L, ..., K, N)
    return PrelimbedWeight(stacked.movedim(0, -3).contiguous())


def decompose(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """fp32 -> stacked bf16 limbs, shape (n_limbs, *x.shape).

    The round-to-nearest cascade ``l0 = bf16(x); l1 = bf16(x - l0); ...``.
    Each subtraction is exact in fp32 (the high bits cancel)."""
    r = x.to(torch.float32)
    limbs = []
    for _ in range(n_limbs):
        li = r.to(torch.bfloat16)
        limbs.append(li)
        r = r - li.to(torch.float32)
    return torch.stack(limbs)


def decompose_dd(x: DD, n_limbs: int) -> torch.Tensor:
    """DD -> stacked bf16 limbs, shape (n_limbs, *x.shape).

    The high word's cascade, with the low word folded in once the high
    word's residual has decayed to its magnitude (after 3 limbs, ~2^-24
    relative, matching |lo|)."""
    r = x.hi.to(torch.float32)
    limbs = []
    for i in range(n_limbs):
        li = r.to(torch.bfloat16)
        limbs.append(li)
        r = r - li.to(torch.float32)
        if i == 2:  # residual of hi has decayed to lo's scale: fold lo in
            r = r + x.lo.to(torch.float32)
    return torch.stack(limbs)


def reconstruct(limbs: torch.Tensor) -> torch.Tensor:
    """Sum limbs back to fp32 (ascending magnitude for accuracy)."""
    acc = torch.zeros(limbs.shape[1:], dtype=torch.float32,
                      device=limbs.device)
    for i in range(limbs.shape[0] - 1, -1, -1):
        acc = acc + limbs[i].to(torch.float32)
    return acc


def round_to_limbs(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Round x to an 8*n_limbs-bit mantissa (the paper's pre-multiply
    rounding)."""
    return reconstruct(decompose(x, n_limbs))


def _max_abs_scale(x: torch.Tensor) -> torch.Tensor:
    """max|x|, floored at the smallest normal f32 (a 0-d tensor)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp(x.abs().amax(), min=tiny)


def residual_scale(x: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """max|x - round_to_limbs(x)| / max|x|: the tensor-level analogue of the
    paper's 'count zeros after the leading 1' operand analysis.  A 0-d f32
    tensor; 0 means x is exactly representable in ``n_limbs`` limbs (small
    integers in M8)."""
    x = x.to(torch.float32)
    r = x
    for _ in range(n_limbs):
        r = r - r.to(torch.bfloat16).to(torch.float32)
    return r.abs().amax() / _max_abs_scale(x)


def significant_limbs(x: torch.Tensor, *, tol: float = 2.0**-13,
                      max_limbs: int = 3) -> torch.Tensor:
    """Number of limbs needed so the rounding residual is <= tol (relative):
    the AUTO controller's operand analyzer.  Small integers (few significant
    mantissa bits) need 1 limb; generic f32 data needs 2 or 3.

    Returns a 0-d int32 tensor in [1, max_limbs] on x's device, computed
    there without a read back to the host."""
    x = x.to(torch.float32)
    limit = tol * _max_abs_scale(x)
    one = torch.ones((), dtype=torch.int32, device=x.device)
    needed = one
    r = x
    for k in range(1, max_limbs):  # after k limbs, is the residual too big?
        r = r - r.to(torch.bfloat16).to(torch.float32)
        too_big = r.abs().amax() > limit
        needed = torch.maximum(needed, torch.where(too_big, one * (k + 1),
                                                   one))
    return needed


def neumaier_sum(terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """Compensated (Neumaier) summation of fp32 terms — the carry-save-adder
    analogue: per-term rounding errors are captured in a compensation register
    (picking the larger-magnitude operand, the ``|s| >= |t|`` branch, as the
    JAX package and the CUDA kernels do) and applied once at the end."""
    if len(terms) == 1:
        return terms[0]
    s = terms[0]
    c = torch.zeros_like(s)
    for t in terms[1:]:
        tmp = s + t
        c = c + torch.where(s.abs() >= t.abs(), (s - tmp) + t, (t - tmp) + s)
        s = tmp
    return s + c
