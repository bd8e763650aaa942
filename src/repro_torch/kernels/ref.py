"""Pure-PyTorch oracle for the multi-precision limb matmul and attention
(port of ``repro.kernels.ref``).

Semantics: C = A @ B computed as the sum of kept limb products
    C = sum_{(i,j) in fmt.products} A_limb[i] @ B_limb[j]
Every limb product multiplies bf16 limbs *upcast to f32*: ``torch.matmul``
of two bf16 tensors returns bf16, while a bf16 x bf16 product is exact in
f32 (and in TF32), so the upcast product is the exact one.

This module is the ``ref`` backend of ``core/dispatch.py`` and the shared
attention math the flash kernel's plain version runs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import limbs as limbs_lib
from repro_torch.core.formats import FormatLike, resolve
from repro_torch.core.limbs import PrelimbedWeight

ATTN_NEG_INF = -1e30


def _limbs_of(x, n_limbs: int) -> torch.Tensor:
    """(n_limbs, ..., K, N) bf16 limbs of an operand.  A
    :class:`PrelimbedWeight` gives its stored planes: missing ones are zero
    (the value carries no bits beyond its stored precision), extra ones are
    ignored."""
    if not isinstance(x, PrelimbedWeight):
        return limbs_lib.decompose(x, n_limbs)
    planes = x.limbs.movedim(-3, 0)
    have = planes.shape[0]
    if have >= n_limbs:
        return planes[:n_limbs]
    pad = torch.zeros((n_limbs - have,) + planes.shape[1:],
                      dtype=torch.bfloat16, device=planes.device)
    return torch.cat([planes, pad])


def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The f32-accumulating product of two bf16 limbs (exact products)."""
    return torch.matmul(x.float(), y.float())


def _matmul_limbs(al: torch.Tensor, bl: torch.Tensor, s, dot=None
                  ) -> torch.Tensor:
    """Limb-product contraction from pre-extracted limb stacks, with the
    JAX oracle's two accumulation disciplines:

    * <= 3 limbs: one product per kept (i, j), PLAIN adds in ``products``
      order (highest order first);
    * > 3 limbs: per-order sums, then a Neumaier combine over the orders,
      highest order first.

    ``dot`` is the product of one limb pair (default: standard matmul
    orientation; the attention helpers pass the untransposed QK form)."""
    dot = dot or _mm
    if s.n_limbs <= 3:
        out = None
        for (i, j) in s.products:
            p = dot(al[i], bl[j])
            out = p if out is None else out + p
        return out
    by_order: dict[int, list[torch.Tensor]] = {}
    for (i, j) in s.products:
        by_order.setdefault(i + j, []).append(dot(al[i], bl[j]))
    order_sums = []
    for o in sorted(by_order, reverse=True):  # smallest magnitude first
        terms = by_order[o]
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        order_sums.append(acc)
    return limbs_lib.neumaier_sum(order_sums)


def lane_keep(i: int, j: int, lane_n, lane_ord):
    """Which lanes keep limb product ``(i, j)``: the partitioned-lane
    predicate every realization (this oracle, the plain versions and the
    CUDA kernels) shares.  A lane at ``k`` limbs and order cut ``c`` keeps
    exactly its own format's product set, so its masked cascade is its
    homogeneous cascade.  ``lane_n`` / ``lane_ord`` are int32 tensors that
    broadcast against one limb product."""
    return (i < lane_n) & (j < lane_n) & (i + j <= lane_ord)


def masked_matmul_limbs(al: torch.Tensor, bl: torch.Tensor, env, lane_n,
                        lane_ord, dot=None) -> torch.Tensor:
    """Per-lane masked limb contraction at the envelope format ``env``.

    The product loop runs the envelope's product sequence (highest order
    first); each lane masks the products outside its own format to +0.0
    with ``torch.where`` (never by multiplying: 0·Inf is NaN).  A lane's
    products keep their relative order in the envelope's sequence and the
    masked entries add exact zeros, so every lane's result equals its
    homogeneous run bit for bit up to the sign of a zero (-0 -> +0, which
    cannot move a token).

    Both disciplines of :func:`_matmul_limbs` are realized, and each lane
    takes its own format's: plain adds in ``products`` order for <= 3
    limbs, per-order sums joined by a Neumaier combine above that (the
    all-zero leading orders of a shallow lane are exact no-ops there).
    When the envelope has <= 3 limbs no lane needs the compensated branch
    and it is skipped."""
    dot = dot or _mm
    masked = []
    for (i, j) in env.products:  # highest order first: small terms first
        p = dot(al[i], bl[j])
        masked.append(((i, j), torch.where(
            lane_keep(i, j, lane_n, lane_ord), p, 0.0)))
    seq = None
    for _, p in masked:
        seq = p if seq is None else seq + p
    if env.n_limbs <= 3:
        return seq
    by_order: dict[int, list[torch.Tensor]] = {}
    for (i, j), p in masked:
        by_order.setdefault(i + j, []).append(p)
    order_sums = []
    for o in sorted(by_order, reverse=True):  # smallest magnitude first
        terms = by_order[o]
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        order_sums.append(acc)
    return torch.where(lane_n <= 3, seq, limbs_lib.neumaier_sum(order_sums))


def masked_matmul_ref(a: torch.Tensor, b, env, lane_n, lane_ord
                      ) -> torch.Tensor:
    """Mixed-lane matmul oracle: a (..., M, K) x b (..., K, N) at per-lane
    depth -> (..., M, N) f32.  ``lane_n`` / ``lane_ord`` broadcast against
    the product (a decode micro-batch passes (B, 1, 1) for (B, S, N));
    ``b`` may be a :class:`PrelimbedWeight`."""
    return masked_matmul_limbs(_limbs_of(a, env.n_limbs),
                               _limbs_of(b, env.n_limbs), env, lane_n,
                               lane_ord)


def mp_matmul_ref(a: torch.Tensor, b, mode: FormatLike = "M16"
                  ) -> torch.Tensor:
    """Multi-precision matmul oracle: a (..., M, K) @ b (..., K, N) with
    ``torch.matmul`` broadcasting -> (..., M, N) f32.  ``b`` may be a
    :class:`PrelimbedWeight`."""
    s = resolve(mode)
    if s.n_limbs == 1:
        # M8: one bf16 x bf16 product, f32 accumulation
        return _mm(a.to(torch.bfloat16), _limbs_of(b, 1)[0])
    return _matmul_limbs(limbs_lib.decompose(a, s.n_limbs),
                         _limbs_of(b, s.n_limbs), s)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x / (1 + exp(-x))`` in f32 — the form the CUDA epilogue computes."""
    return x / (1.0 + torch.exp(-x))


def apply_epilogue(raws, *, gate: str = "none", biases=None, residual=None):
    """The epilogue lattice on raw projection outputs: per-branch bias add,
    gate combine (``silu(raws[0]) * raws[1]``), then residual add.  Returns
    the combined tensor, the lone output (n_out == 1 unwraps), or the output
    tuple."""
    raws = list(raws)
    if biases is not None:
        raws = [r if b is None else r + b.float() for r, b in zip(raws, biases)]
    if gate == "swiglu":
        if len(raws) != 2:
            raise ValueError(f"swiglu gate needs 2 outputs, got {len(raws)}")
        out = silu(raws[0].float()) * raws[1].float()
    elif gate == "none":
        out = None
    else:
        raise ValueError(f"unknown gate {gate!r}")
    if residual is not None:
        if out is None and len(raws) != 1:
            raise ValueError("residual epilogue needs a single final output")
        out = (raws[0] if out is None else out) + residual.float()
    if out is None:
        return raws[0] if len(raws) == 1 else tuple(raws)
    return out


def mp_fused_proj_ref(x: torch.Tensor, ws, mode: FormatLike, *,
                      gate: str = "none", biases=None, residual=None):
    """Operand-shared fused projection oracle: ``n_out`` contractions of one
    activation ``x`` (..., K) against (K, N_t) weights, decomposing x's limbs
    ONCE.  Returns the tuple of outputs, or one tensor when the epilogue
    combines them / n_out == 1."""
    s = resolve(mode)
    al = limbs_lib.decompose(x, s.n_limbs)
    raws = []
    for w in ws:
        if s.n_limbs == 1:
            raws.append(_mm(al[0], _limbs_of(w, 1)[0]))
        else:
            raws.append(_matmul_limbs(al, _limbs_of(w, s.n_limbs), s))
    return apply_epilogue(raws, gate=gate, biases=biases, residual=residual)


def matmul_golden_f64(a, b) -> np.ndarray:
    """Host-side float64 golden product (numpy) — the accuracy yardstick."""
    a64 = np.asarray(torch.as_tensor(a).detach().cpu(), np.float64)
    b64 = np.asarray(torch.as_tensor(b).detach().cpu(), np.float64)
    return a64 @ b64


# ---------------------------------------------------------------------------
# attention: the shared online-softmax core (the flash kernel's plain
# version and the ref backend both run these)
# ---------------------------------------------------------------------------
def _dot_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, D) x (..., T, D) -> (..., M, T) on untransposed operands."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2))


def attn_qk_logits(q: torch.Tensor, k: torch.Tensor, mode: FormatLike
                   ) -> torch.Tensor:
    """Logits for one block pair at the QK format: q (..., M, D) f32
    (pre-scaled), k (..., T, D) f32 -> (..., M, T) f32, through
    :func:`_matmul_limbs`' discipline."""
    s = resolve(mode)
    return _matmul_limbs(limbs_lib.decompose(q, s.n_limbs),
                         limbs_lib.decompose(k, s.n_limbs), s, dot=_dot_nt)


def attn_pv(p: torch.Tensor, v: torch.Tensor, mode: FormatLike
            ) -> torch.Tensor:
    """p (..., M, T) f32 @ v (..., T, D) f32 at the PV format (P itself is
    limbed: at M8 it is rounded to bf16)."""
    s = resolve(mode)
    return _matmul_limbs(limbs_lib.decompose(p, s.n_limbs),
                         limbs_lib.decompose(v, s.n_limbs), s)


def _online_step(m, d, acc, logits, p_mask, pv):
    """One kv-block step of the running (max, denom, accum) softmax; ``pv``
    is the P·V contraction of the probabilities.

    ``p_mask`` re-zeroes probabilities explicitly (a fully-masked row has
    max == ATTN_NEG_INF, so exp(logit - max) == 1, not 0)."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if p_mask is not None:
        p = torch.where(p_mask, p, torch.zeros((), device=p.device))
    alpha = torch.exp(m - m_new)
    d_new = d * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + pv(p)
    return m_new, d_new, acc_new


def online_softmax_update(m, d, acc, logits, v, mode_pv, *, p_mask=None):
    """One kv-block step of the running softmax with P·V at ``mode_pv``."""
    return _online_step(m, d, acc, logits, p_mask,
                        lambda p: attn_pv(p, v, mode_pv))


def masked_attn_qk_logits(q: torch.Tensor, k: torch.Tensor, env, lane_n,
                          lane_ord) -> torch.Tensor:
    """Per-lane :func:`attn_qk_logits`: the same untransposed contraction
    through the masked cascade (the mixed paged kernel's plain version)."""
    return masked_matmul_limbs(limbs_lib.decompose(q, env.n_limbs),
                               limbs_lib.decompose(k, env.n_limbs), env,
                               lane_n, lane_ord, dot=_dot_nt)


def masked_attn_pv(p: torch.Tensor, v: torch.Tensor, env, lane_n,
                   lane_ord) -> torch.Tensor:
    """Per-lane :func:`attn_pv`."""
    return masked_matmul_limbs(limbs_lib.decompose(p, env.n_limbs),
                               limbs_lib.decompose(v, env.n_limbs), env,
                               lane_n, lane_ord)


def masked_online_softmax_update(m, d, acc, logits, v, env_pv, lane_n,
                                 lane_ord, *, p_mask=None):
    """:func:`online_softmax_update` with the P·V contraction at per-lane
    depth; the softmax bookkeeping is format-free and unchanged."""
    return _online_step(
        m, d, acc, logits, p_mask,
        lambda p: masked_attn_pv(p, v, env_pv, lane_n, lane_ord))


def mp_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mode_qk: FormatLike = "M16",
                     mode_pv: Optional[FormatLike] = None, *,
                     causal: bool = True, scale: Optional[float] = None,
                     q_offset: int = 0, block_q: Optional[int] = None,
                     block_kv: Optional[int] = None) -> torch.Tensor:
    """Multi-precision flash-attention oracle.

    q (B, S, H, Dh); k/v (B, T, H, Dh) with H already GQA-repeated.  QK^T at
    ``mode_qk``, P·V at ``mode_pv`` (defaults to ``mode_qk``).
    ``block_q``/``block_kv`` default to the full sequence (the unchunked
    oracle); ``q_offset`` shifts the causal query positions."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dh))
    dev = q.device
    bq = S if block_q is None else max(1, min(block_q, S))
    bkv = T if block_kv is None else max(1, min(block_kv, T))
    nq, nkv = -(-S // bq), -(-T // bkv)
    S_pad, T_pad = nq * bq, nkv * bkv

    def heads_first(x, pad):
        x = x.permute(0, 2, 1, 3).float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad))

    qh = heads_first(q, S_pad - S) * scale
    kh = heads_first(k, T_pad - T)
    vh = heads_first(v, T_pad - T)

    outs = []
    for qi in range(nq):
        q_blk = qh[:, :, qi * bq:(qi + 1) * bq]
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), ATTN_NEG_INF, dtype=torch.float32,
                       device=dev)
        d = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, Dh), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            if causal and ki * bkv > q_offset + (qi + 1) * bq - 1:
                continue  # block entirely above the causal diagonal
            k_blk = kh[:, :, ki * bkv:(ki + 1) * bkv]
            v_blk = vh[:, :, ki * bkv:(ki + 1) * bkv]
            k_pos = ki * bkv + torch.arange(bkv, device=dev)
            valid = k_pos[None, :] < T
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            logits = attn_qk_logits(q_blk, k_blk, fmt_qk)
            logits = torch.where(valid, logits,
                                 torch.full((), ATTN_NEG_INF, device=dev))
            m, d, acc = online_softmax_update(m, d, acc, logits, v_blk,
                                              fmt_pv, p_mask=valid)
        outs.append(acc / torch.clamp(d[..., None], min=1e-30))
    out = torch.cat(outs, dim=2)[:, :, :S]
    return out.permute(0, 2, 1, 3).contiguous()
