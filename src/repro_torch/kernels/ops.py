"""Shape handling around the CUDA matmul kernels (port of the
``mp_matmul_pallas`` / ``mp_fused_proj_pallas`` / ``mp_mixed_matmul_pallas``
wrappers of ``repro.kernels.ops``): batch folding, the both-batched case,
the concatenation along N for unequal (GQA) projection widths, and the
per-row lanes of the mixed-format decode matmul.

These are the ``cuda`` backend of ``core/dispatch.py``.  The kernel wrappers
they call run their plain versions for CPU tensors, so the same shape logic
runs in the CPU tests.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import FormatLike, resolve
from repro_torch.core.limbs import PrelimbedWeight
from repro_torch.kernels.mp_matmul import MAX_OUT, mp_decompose, \
    mp_fused_matmul, mp_fused_proj, mp_mixed_prelimbed_matmul, \
    mp_prelimbed_matmul


def mp_matmul_cuda(a: torch.Tensor, b: torch.Tensor, mode: FormatLike = "M16"
                   ) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) -> (..., M, N).  When only ``a`` is
    batched the batch folds into M (one large matmul); when both are, the
    kernel takes the broadcast batch dims with their strides in ONE launch
    (decode attention's (B, H, 1, Dh) x (B, H, Dh, T))."""
    fmt = resolve(mode)
    if b.ndim == 2:
        lead = a.shape[:-1]
        out = mp_fused_matmul(a.reshape(-1, a.shape[-1]), b, fmt)
        return out.reshape(lead + (b.shape[-1],))
    return mp_fused_matmul(a, b, fmt)


def mp_fused_proj_cuda(x: torch.Tensor, ws, mode: FormatLike = "M16", *,
                       gate: str = "none", biases=None,
                       residual: Optional[torch.Tensor] = None):
    """Fused projection: x (..., K) against n_out (K, N_t) weights.

    Equal widths run the multi-output kernel, each weight from its own
    buffer (groups of at most three per launch).  Unequal widths (GQA: wq
    wider than wk/wv) concatenate along N into ONE wide contraction — x is
    still read and limbed once — and the outputs are sliced back apart; only
    valid without a gate combine.  Returns the tuple of (..., N_t) outputs,
    or one tensor when gated or n_out == 1."""
    fmt = resolve(mode)
    ws = tuple(ws)
    Ns = [w.shape[-1] for w in ws]
    K = x.shape[-1]
    lead = x.shape[:-1]
    a = x.reshape(-1, K)
    M = a.shape[0]
    res2 = None if residual is None else residual.reshape(M, -1)
    if len(set(Ns)) == 1:
        if gate != "none":
            out = mp_fused_proj(a, ws, fmt, gate=gate, biases=biases,
                                residual=res2)
            return out.reshape(lead + (Ns[0],))
        outs = []
        for g in range(0, len(ws), MAX_OUT):
            grp_b = None if biases is None else tuple(biases[g:g + MAX_OUT])
            outs += list(mp_fused_proj(a, ws[g:g + MAX_OUT], fmt,
                                       biases=grp_b, residual=res2))
        outs = tuple(o.reshape(lead + (Ns[0],)) for o in outs)
        return outs[0] if len(outs) == 1 else outs
    if gate != "none":
        raise ValueError("gate combine needs equal-width weights")
    if residual is not None:
        raise ValueError("residual epilogue needs a single final output")
    w_cat = torch.cat([w.float() for w in ws], dim=-1)      # (K, sum N)
    b_cat = None if biases is None else (torch.cat(
        [b.float() for b in biases], dim=-1),)
    out = mp_fused_proj(a, (w_cat,), fmt, biases=b_cat)[0]
    parts = torch.split(out, Ns, dim=-1)
    return tuple(p.reshape(lead + (p.shape[-1],)) for p in parts)


def mp_matmul_prelimbed_weights(x: torch.Tensor, w_limbs: torch.Tensor,
                                mode: FormatLike) -> torch.Tensor:
    """Serving fast path: x (..., K) @ W (K, N), W given as its (L, K, N)
    bf16 limb stack (``decompose_weights``), x limbed inside the kernel.

    A format needing more limbs than were stored computes at the stored
    precision (missing limbs are zero); extra stored limbs are ignored.
    Unlike the JAX wrapper, nothing is padded or sliced in memory: the
    kernel takes the stored count and reads only the planes it needs."""
    lead = x.shape[:-1]
    out = mp_prelimbed_matmul(x.reshape(-1, x.shape[-1]), w_limbs,
                              resolve(mode))
    return out.reshape(lead + (w_limbs.shape[-1],))


def _row_lanes(lane: torch.Tensor, rows: int) -> torch.Tensor:
    """A (B,) lane vector as the lanes of the flattened rows: one row per
    slot (the decode micro-batch's (B, 1, K))."""
    lane = lane.reshape(-1)
    if lane.numel() != rows:
        raise ValueError(f"{lane.numel()} lanes for {rows} rows")
    return lane


def mp_mixed_matmul(x: torch.Tensor, w, env: FormatLike,
                    lane_n: torch.Tensor, lane_ord: torch.Tensor
                    ) -> torch.Tensor:
    """Partitioned-lane matmul (port of ``ops.mp_mixed_matmul_pallas``):
    x (..., K) @ W (K, N) with row m of the flattened leading dims at its
    own lane format (``lane_n[m]`` limbs, order cut ``lane_ord[m]``, int32)
    under the envelope ``env`` -> (..., N).  The decode micro-batch is
    (B, 1, K): one row, and one lane, per slot.  ``w`` is a 2-D
    :class:`PrelimbedWeight` on the serving path; a raw 2-D weight is
    pre-limbed here at the envelope depth (the limbs the kernels would cut
    from it, so the numbers are the same)."""
    env = resolve(env)
    if w.ndim != 2:
        raise ValueError(f"mixed matmul weights must be 2-D, got "
                         f"{tuple(w.shape)}")
    limbs = w.limbs if isinstance(w, PrelimbedWeight) \
        else decompose_weights(w, env.n_limbs)
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    out = mp_mixed_prelimbed_matmul(a, limbs, env,
                                    _row_lanes(lane_n, a.shape[0]),
                                    _row_lanes(lane_ord, a.shape[0]))
    return out.reshape(lead + (limbs.shape[-1],))


def decompose_weights(w: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Pre-limb a (R, C) weight matrix with the decompose kernel ->
    (n_limbs, R, C) bf16."""
    if w.ndim != 2:
        raise ValueError(f"decompose_weights takes a 2-D weight, got "
                         f"{tuple(w.shape)}")
    return mp_decompose(w, n_limbs)
