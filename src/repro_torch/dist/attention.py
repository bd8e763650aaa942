"""Sequence-parallel decode attention — the sharded backend's decode path
(port of ``repro.dist.attention``).

Decode attention is one query position against a long KV prefix, so the
dimension worth sharding is the cache sequence (T): each rank takes a
contiguous T-slice of K/V, computes its local policy-obeying logits and
partial softmax statistics, and three collectives combine them exactly —

    all-reduce MAX of the local row maxima   -> the global softmax max,
    all-reduce SUM of the local exp-sums     -> the global denominator,
    all-reduce SUM of the local P @ V        -> the global numerator,

the distributed form of the online-softmax identity the flash kernels use.
Both contractions run through the limb cascade at the resolved ``attn_qk``
/ ``attn_pv`` formats (``ref.attn_qk_logits`` / ``ref.attn_pv``), so the
multi-rank path keeps the single-rank path's precision policy.

:func:`sp_decode_attention` slices a K/V replicated on every rank (the
``sharded`` backend's path); its local math is torch ops, as the JAX
package computes it in XLA outside any Pallas kernel.
:func:`sp_decode_block` attends over a rank's own block of the cache (the
decode layout, ``dist/decode_layout.py``); its QK and PV are the one-rank
decode's ``mp_matmul`` calls, fused-matmul launches on ``cuda``.  Both
combine through :func:`combine_block`.  Masking follows
``masked_decode_attention``: positions ``>= lengths`` go to
``ATTN_NEG_INF`` before the max and their probabilities are re-zeroed
after the exp, so zero-padded slices add nothing and fully-masked rows
(length-0 slots) flush exact zeros.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.formats import FormatLike, is_auto, resolve
from repro_torch.kernels import ref as ref_backend


def usable_mesh(mesh=None, axis: str = "data"):
    """(mesh, axis) the way the sharded matmul backend resolves them, or
    None where sequence parallelism cannot run: no mesh of several ranks,
    a multi-D mesh without ``axis``, or a scope that already owns the
    ranks."""
    from repro_torch.core import dispatch

    if dispatch._bound_axis_names():
        return None
    try:
        resolved = dispatch.resolve_mesh(mesh, axis)
    except ValueError:
        return None
    if resolved is None:
        return None
    mesh, axis = resolved
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh, axis


def sp_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths, mode_qk: FormatLike,
                        mode_pv: Optional[FormatLike] = None, *,
                        scale: Optional[float] = None, mesh=None,
                        axis: str = "data",
                        dot: Optional[Callable] = None) -> torch.Tensor:
    """Sequence-parallel masked decode attention: q (B, 1, H, Dh) against
    k/v (B, T, H, Dh) (H already GQA-repeated, replicated on every rank),
    valid prefix per slot given by ``lengths`` (an int or a (B,) tensor).
    Each rank attends over its T-slice; the result is the sequence-parallel
    regrouping of ``masked_decode_attention`` (same masking, same
    per-format contractions, reassociated accumulation), equal on every
    rank.  ``dot`` is the QK limb product (``ref.dot_nt_in_order`` sums
    each logit in the kernels' order).

    AUTO formats need whole-operand value analysis, and a mesh of one rank
    has nothing to shard: both run ``masked_decode_attention`` on the
    ``cuda`` backend (the JAX package runs its ``ref``)."""
    from repro_torch.analysis import accounting

    mode_pv = mode_pv if mode_pv is not None else mode_qk
    resolved = usable_mesh(mesh, axis)
    if resolved is None or is_auto(mode_qk) or is_auto(mode_pv):
        from repro_torch.core.dispatch import masked_decode_attention

        return masked_decode_attention(q, k, v, lengths, mode_qk, mode_pv,
                                       scale=scale, backend="cuda")
    mesh, axis = resolved
    fmt_qk, fmt_pv = resolve(mode_qk), resolve(mode_pv)
    B, S1, H, Dh = q.shape
    if S1 != 1:
        raise ValueError(f"decode attention expects S == 1, got {S1}")
    T = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dh))
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    t_loc = -(-T // n)
    t0, t1 = min(r * t_loc, T), min((r + 1) * t_loc, T)
    k_loc, v_loc = k[:, t0:t1], v[:, t0:t1]
    if t1 - t0 < t_loc:
        # zero T-padding is exact: padded positions sit past every slot's
        # length, so the position mask sends their logits to ATTN_NEG_INF
        pad = (0, 0, 0, 0, 0, t_loc - (t1 - t0))
        k_loc = torch.nn.functional.pad(k_loc, pad)
        v_loc = torch.nn.functional.pad(v_loc, pad)
    accounting.record_attention(q, k_loc, v_loc, fmt_qk, fmt_pv,
                                causal=False)
    qh = q.permute(0, 2, 1, 3).float() * scale                 # (B, H, 1, Dh)
    kh = k_loc.permute(0, 2, 1, 3).float()                    # (B, H, t, Dh)
    vh = v_loc.permute(0, 2, 1, 3).float()
    logits = ref_backend.attn_qk_logits(qh, kh, fmt_qk,
                                        dot=dot or ref_backend._dot_nt)
    out = combine_block(logits, lengths, r * t_loc, group,
                        lambda p: ref_backend.attn_pv(p, vh, fmt_pv))
    return out.permute(0, 2, 1, 3).to(q.dtype)              # (B, 1, H, Dh)


def combine_block(logits: torch.Tensor, lengths, offset: int, group,
                  pv: Callable) -> torch.Tensor:
    """The exact softmax-weighted sum over a sequence split into blocks,
    one a rank of ``group``: ``logits`` (B, H, 1, t) are this rank's
    block's, at global positions ``offset ..``; ``pv(p)`` contracts the
    block's unnormalized probabilities with its values.  Positions at or
    past ``lengths`` (an int or a (B,) tensor) go to ``ATTN_NEG_INF``
    before the max and their probabilities are re-zeroed after the exp, so
    a block with no valid position adds exact zeros; then

        all-reduce MAX of the row maxima, SUM of the exp-sums, SUM of pv,

    and the sum over the denominator, equal on every rank of the group."""
    from repro_torch.dist import collectives

    dev = logits.device
    ln = torch.as_tensor(lengths, device=dev).reshape(-1, 1, 1, 1)
    pos = offset + torch.arange(logits.shape[-1], device=dev)
    mask = pos < ln                                           # (B, 1, 1, t)
    neg = torch.full((), ref_backend.ATTN_NEG_INF, device=dev)
    logits = torch.where(mask, logits, neg)
    m = collectives.all_reduce(logits.amax(dim=-1, keepdim=True), group,
                               op="max")
    # exp(NEG_INF - NEG_INF) == 1 on fully-masked rows: the explicit
    # re-zero (not underflow) is what guarantees exact-0 outputs there
    p = torch.where(mask, torch.exp(logits - m),
                    torch.zeros((), device=dev))
    denom = collectives.all_reduce(p.sum(dim=-1, keepdim=True), group)
    acc = collectives.all_reduce(pv(p), group)
    return acc / torch.clamp(denom, min=1e-30)


def sp_decode_block(q: torch.Tensor, k_blk: torch.Tensor,
                    v_blk: torch.Tensor, lengths, offset: int, group,
                    mode_qk: FormatLike,
                    mode_pv: Optional[FormatLike] = None, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel masked decode attention over this rank's own
    block of the cache (the decode layout's, ``dist.decode_layout``): q
    (B, 1, H, Dh) against k_blk / v_blk (B, t, H, Dh) (H already
    GQA-repeated) holding global positions ``offset .. offset + t``; the
    valid prefix per slot is ``lengths`` (global).  The block's QK and PV
    are the calls ``masked_decode_attention`` makes on one rank
    (``mp_einsum_qk`` and ``mp_matmul``: a fused-matmul launch each on
    ``cuda``), the softmax is combined over ``group``
    (:func:`combine_block`); the result is equal on every rank of the
    group.  AUTO formats raise: their value analysis needs the whole
    operand, which no rank holds."""
    from repro_torch.core.mpmatmul import mp_einsum_qk, mp_matmul

    mode_pv = mode_pv if mode_pv is not None else mode_qk
    if is_auto(mode_qk) or is_auto(mode_pv):
        raise ValueError(
            "AUTO attention formats under a decode layout: AUTO analyzes "
            "the values of the whole K / V operand, and a rank holds one "
            "block of the cache sequence; pin attn_qk / attn_pv to a "
            "static format")
    B, S1, H, Dh = q.shape
    if S1 != 1:
        raise ValueError(f"decode attention expects S == 1, got {S1}")
    if scale is None:
        scale = 1.0 / float(np.sqrt(Dh))
    qh = q.permute(0, 2, 1, 3).float() * scale                 # (B, H, 1, Dh)
    kh = k_blk.permute(0, 2, 1, 3).float()                    # (B, H, t, Dh)
    vh = v_blk.permute(0, 2, 1, 3).float()
    logits = mp_einsum_qk(qh, kh, mode_qk)                     # (B, H, 1, t)
    out = combine_block(logits, lengths, offset, group,
                        lambda p: mp_matmul(p, vh, mode_pv))
    return out.permute(0, 2, 1, 3).to(q.dtype)              # (B, 1, H, Dh)
