"""Backend dispatch for the multi-precision ops (port of
``repro.core.dispatch``, the routes the serving slice runs).

Two backends:

  cuda  the hand-written CUDA kernels (kernels/ops.py, kernels/mp_attention.py)
        — the default.  Their wrappers run the kernels' plain PyTorch
        versions for CPU tensors.
  ref   the pure-PyTorch oracle (kernels/ref.py), chosen only when a caller
        asks for it.

Pre-limbed weights (:class:`~repro_torch.core.limbs.PrelimbedWeight`) route
to the pre-limbed kernel on ``cuda`` and to the oracle on ``ref``; two-float
operands (:class:`~repro_torch.core.limbs.DD`) to the both-prelimbed kernel
on ``cuda`` and to the oracle on ``ref``; paged decode attention routes to
the paged kernel on ``cuda`` and to the ``pool[table]`` gather plus
:func:`masked_decode_attention` on ``ref``, and under AUTO formats to that
gather on every backend.
The partitioned-lane (mixed-format decode) routes go to the mixed kernels
on ``cuda`` and to the lane-masked oracle on ``ref``.  The sharded route of
the JAX package is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import context as context_lib
from repro_torch.core.formats import FormatLike, is_auto, resolve
from repro_torch.core.limbs import DD, PrelimbedWeight
from repro_torch.kernels import ref as ref_backend

BACKENDS = ("cuda", "ref")


def available_backends() -> Tuple[str, ...]:
    return BACKENDS


def _backend(backend: Optional[str]) -> str:
    name = backend or context_lib.current_context().backend
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {BACKENDS}")
    return name


def dispatch(a, b, mode: FormatLike, *,
             backend: Optional[str] = None) -> torch.Tensor:
    """Route one static-format matmul a (..., M, K) @ b (..., K, N); ``b``
    may be a 2-D :class:`PrelimbedWeight`, and either operand a 2-D
    :class:`DD` pair."""
    fmt = resolve(mode)
    if _backend(backend) == "ref":
        return ref_backend.mp_matmul_ref(a, b, fmt)
    from repro_torch.kernels import ops

    if isinstance(a, DD) or isinstance(b, DD):
        return ops.mp_matmul_dd(a, b, fmt)
    if isinstance(b, PrelimbedWeight):
        if b.ndim != 2:
            raise ValueError("prelimbed weights must be 2-D per matmul")
        return ops.mp_matmul_prelimbed_weights(a, b.limbs, fmt)
    return ops.mp_matmul_cuda(a, b, fmt)


def dispatch_fused(x: torch.Tensor, ws, mode: FormatLike, *,
                   gate: str = "none", biases=None, residual=None,
                   backend: Optional[str] = None):
    """Route one fused projection group (one activation, ``n_out``
    weights, epilogue lattice)."""
    fmt = resolve(mode)
    ws = tuple(ws)
    if _backend(backend) == "ref":
        return ref_backend.mp_fused_proj_ref(x, ws, fmt, gate=gate,
                                             biases=biases, residual=residual)
    from repro_torch.kernels import ops

    return ops.mp_fused_proj_cuda(x, ws, fmt, gate=gate, biases=biases,
                                  residual=residual)


def dispatch_attention(q, k, v, mode_qk: FormatLike,
                       mode_pv: Optional[FormatLike] = None, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0, backend: Optional[str] = None
                       ) -> torch.Tensor:
    """Route one fused attention call (q (B, S, H, Dh), k/v (B, T, H, Dh),
    H already GQA-repeated): the flash kernel on ``cuda``, the unblocked
    oracle on ``ref``."""
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if _backend(backend) == "ref":
        return ref_backend.mp_attention_ref(
            q, k, v, fmt_qk, fmt_pv, causal=causal, scale=scale,
            q_offset=q_offset)
    from repro_torch.kernels import mp_attention as attn_kernels

    return attn_kernels.mp_flash_attention(q, k, v, fmt_qk, fmt_pv,
                                           causal=causal, scale=scale,
                                           q_offset=q_offset)


def masked_decode_attention(q, k, v, length, mode_qk: FormatLike,
                            mode_pv: Optional[FormatLike] = None, *,
                            scale: Optional[float] = None,
                            backend: Optional[str] = None) -> torch.Tensor:
    """Decode attention: q (B, 1, H, Dh) against k/v (B, T, H, Dh) (H already
    repeated), masked to the first ``length`` positions (an int, or a (B,)
    tensor of per-slot lengths).  Both contractions route through
    ``mp_matmul`` at the ``attn_qk`` / ``attn_pv`` formats; q is scaled
    *before* the contraction so the limb cascade decomposes the same operand
    the fused kernels do.  k/v are read through transposed views (no
    copies): the batched kernel takes their strides."""
    from repro_torch.core.mpmatmul import mp_einsum_qk, mp_matmul

    T = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    mode_pv = mode_pv if mode_pv is not None else mode_qk
    qh = q.permute(0, 2, 1, 3).float() * scale             # (B, H, 1, Dh)
    kh = k.permute(0, 2, 1, 3).float()                     # (B, H, T, Dh)
    vh = v.permute(0, 2, 1, 3).float()
    logits = mp_einsum_qk(qh, kh, mode_qk, backend=backend)  # (B, H, 1, T)
    if torch.is_tensor(length) and length.ndim:
        length = length.reshape(-1, 1, 1, 1)
    mask = torch.arange(T, device=q.device) < length
    neg = torch.full((), ref_backend.ATTN_NEG_INF, device=q.device)
    logits = torch.where(mask, logits, neg)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    out = mp_matmul(p, vh, mode_pv, backend=backend)       # (B, H, 1, Dh)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def dispatch_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_table: torch.Tensor,
                             lengths: torch.Tensor, mode_qk: FormatLike,
                             mode_pv: Optional[FormatLike] = None, *,
                             scale: Optional[float] = None,
                             backend: Optional[str] = None) -> torch.Tensor:
    """Route one paged-decode attention step: q (B, 1, H, Dh) against the
    block pool (n_blocks, bs, Hkv, Dh) through the slot block tables
    (B, W) int32 and per-slot lengths (B,) int32.

    ``cuda`` runs the paged kernel: pool blocks are read straight through
    the table, the contiguous ``pool[table]`` gather never materializes.
    ``ref`` gathers the table's columns (bounded: the scheduler slices the
    table to its used width) and runs :func:`masked_decode_attention`.
    AUTO formats analyze raw operand values, so they take that gather on
    every backend (its contractions run AUTO through ``mp_matmul``)."""
    B, S1, H, Dh = q.shape
    mode_pv = mode_pv if mode_pv is not None else mode_qk
    name = _backend(backend)
    if name == "cuda" and not (is_auto(mode_qk) or is_auto(mode_pv)):
        from repro_torch.kernels import mp_attention as attn_kernels

        out = attn_kernels.mp_paged_attention(
            q.reshape(B, H, Dh), k_pool, v_pool, block_table, lengths,
            resolve(mode_qk), resolve(mode_pv), scale=scale)
        return out.reshape(B, S1, H, Dh).to(q.dtype)
    kk, vv = _gather_pages(k_pool, v_pool, block_table, H)
    return masked_decode_attention(q, kk, vv, lengths, mode_qk, mode_pv,
                                   scale=scale, backend=name)


def _gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor, H: int):
    """The ``ref`` routes' K/V: the table's pool blocks gathered into
    (B, W * bs, H, Dh), kv heads repeated to the H query heads."""
    B, W = block_table.shape
    _, bs, hk, Dh = k_pool.shape
    idx = block_table.long()
    kk = k_pool[idx].reshape(B, W * bs, hk, Dh)
    vv = v_pool[idx].reshape(B, W * bs, hk, Dh)
    n_rep = H // hk
    if n_rep > 1:
        kk = torch.repeat_interleave(kk, n_rep, dim=2)
        vv = torch.repeat_interleave(vv, n_rep, dim=2)
    return kk, vv


# ---------------------------------------------------------------------------
# partitioned-lane mixed-format decode (one launch, per-slot formats)
# ---------------------------------------------------------------------------
def _lane_cols(lane: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-slot (B,) lane tensor shaped to broadcast over a (B, ..., N)
    operand: every row of a slot shares the slot's format."""
    lane = lane.reshape(-1)
    return lane.reshape((lane.shape[0],) + (1,) * (ndim - 1))


def dispatch_mixed_matmul(a: torch.Tensor, b, env: FormatLike,
                          lane_n: torch.Tensor, lane_ord: torch.Tensor, *,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Route one partitioned-lane matmul: ``a`` (B, 1, K), one decode row
    per slot, each at its slot's ``(n_limbs, max_order)`` ((B,) int32
    ``lane_n`` / ``lane_ord``) at or below the envelope ``env``, against
    one 2-D weight (raw or pre-limbed).  ``cuda`` runs the mixed pre-limbed
    kernel (``ops.mp_mixed_matmul``); ``ref`` runs the masked oracle.  Both
    apply ``kernels/ref.lane_keep``.  Inference only."""
    env = resolve(env)
    if _backend(backend) == "ref":
        return ref_backend.masked_matmul_ref(
            a, b, env, _lane_cols(lane_n, a.ndim),
            _lane_cols(lane_ord, a.ndim))
    from repro_torch.kernels import ops

    return ops.mp_mixed_matmul(a, b, env, lane_n, lane_ord)


def mixed_fused_proj(x: torch.Tensor, ws, env: FormatLike,
                     lane_n: torch.Tensor, lane_ord: torch.Tensor, *,
                     epilogue: str = "none", biases=None, residual=None,
                     backend: Optional[str] = None):
    """Partitioned-lane projection group: per-branch mixed matmuls plus the
    shared epilogue, the lane form of ``mpmatmul._sequential_fused``
    (decode projections hit pre-limbed weights, which run per branch in
    the homogeneous path too)."""
    raws = [dispatch_mixed_matmul(x, w, env, lane_n, lane_ord,
                                  backend=backend) for w in ws]
    return ref_backend.apply_epilogue(raws, gate=epilogue, biases=biases,
                                      residual=residual)


def mixed_masked_decode_attention(q, k, v, lengths, env_qk: FormatLike,
                                  env_pv: FormatLike, lane_qk_n, lane_qk_ord,
                                  lane_pv_n, lane_pv_ord, *,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Lane-masked :func:`masked_decode_attention` (the ``ref`` route): q
    (B, 1, H, Dh) against k/v (B, T, H, Dh) (H already repeated), each slot
    running both contractions at its own formats under the envelopes.  The
    same mask / softmax / re-zero steps as the homogeneous path, and the
    same operands limbed (QK on the transposed k, as ``mp_einsum_qk``
    takes it)."""
    T = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    qh = q.permute(0, 2, 1, 3).float() * scale             # (B, H, 1, Dh)
    kh = k.permute(0, 2, 1, 3).float()                     # (B, H, T, Dh)
    vh = v.permute(0, 2, 1, 3).float()
    logits = ref_backend.masked_matmul_ref(
        qh, kh.transpose(-1, -2), resolve(env_qk), _lane_cols(lane_qk_n, 4),
        _lane_cols(lane_qk_ord, 4))                         # (B, H, 1, T)
    if torch.is_tensor(lengths) and lengths.ndim:
        lengths = lengths.reshape(-1, 1, 1, 1)
    mask = torch.arange(T, device=q.device) < lengths
    neg = torch.full((), ref_backend.ATTN_NEG_INF, device=q.device)
    logits = torch.where(mask, logits, neg)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    out = ref_backend.masked_attn_pv(
        p, vh, resolve(env_pv), _lane_cols(lane_pv_n, 4),
        _lane_cols(lane_pv_ord, 4))                        # (B, H, 1, Dh)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def dispatch_mixed_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_table: torch.Tensor,
                                   lengths: torch.Tensor, env_qk: FormatLike,
                                   env_pv: FormatLike, lane_qk_n, lane_qk_ord,
                                   lane_pv_n, lane_pv_ord, *,
                                   scale: Optional[float] = None,
                                   backend: Optional[str] = None
                                   ) -> torch.Tensor:
    """Route one partitioned-lane paged-decode attention step: q
    (B, 1, H, Dh) against the block pool through the slot block tables,
    with per-slot QK / PV formats ((B,) int32 lanes) under the envelopes.
    ``cuda`` runs the mixed paged kernel (one launch for every format in
    the batch); ``ref`` gathers the table's columns and runs
    :func:`mixed_masked_decode_attention`.  AUTO never reaches here:
    ``lanes.lanes_eligible`` keeps AUTO policies on the bucket path."""
    B, S1, H, Dh = q.shape
    lanes = (lane_qk_n, lane_qk_ord, lane_pv_n, lane_pv_ord)
    if _backend(backend) == "cuda":
        from repro_torch.kernels import mp_attention as attn_kernels

        out = attn_kernels.mp_mixed_paged_attention(
            q.reshape(B, H, Dh), k_pool, v_pool, block_table, lengths,
            env_qk, env_pv, *lanes, scale=scale)
        return out.reshape(B, S1, H, Dh).to(q.dtype)
    kk, vv = _gather_pages(k_pool, v_pool, block_table, H)
    return mixed_masked_decode_attention(q, kk, vv, lengths, env_qk, env_pv,
                                         *lanes, scale=scale)
