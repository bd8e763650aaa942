"""bf16 limb decomposition (PyTorch port of ``repro.core.limbs``).

``decompose(x, k)`` splits an fp32 tensor into ``k`` bf16 limbs with
``x ~= sum_i limbs[i]`` where limb ``i`` carries mantissa bits ``[8i, 8(i+1))``.
Rounding the input to ``k`` limbs *is* the paper's "rounding of bits before
multiplication".  ``Tensor.to(torch.bfloat16)`` rounds to nearest even, the
same rounding XLA applies, so the cascade is bitwise equal to the JAX one.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


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


def reconstruct(limbs: torch.Tensor) -> torch.Tensor:
    """Sum limbs back to fp32 (ascending magnitude for accuracy)."""
    acc = torch.zeros(limbs.shape[1:], dtype=torch.float32,
                      device=limbs.device)
    for i in range(limbs.shape[0] - 1, -1, -1):
        acc = acc + limbs[i].to(torch.float32)
    return acc


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
