"""Multi-precision flash attention and paged decode attention: wrappers,
plain versions and launch counters (port of the Pallas ``_flash_kernel``,
``_paged_kernel`` and ``_mixed_paged_kernel`` of
``repro.kernels.mp_attention``).

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/mp_attention.cu``) for CUDA tensors — there is no
fallback from one to the other.  The flash plain version is the oracle
``ref.mp_attention_ref`` blocked as the kernel blocks: kv tiles of
``BLOCK_KV`` positions, each folded into the running (max, denominator,
accumulator) by the shared online-softmax update.  (The q tile size does not
change the numbers: a kv tile that is processed for a q tile but lies above
a row's diagonal is an exact no-op for that row.)
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import FormatLike, resolve
from repro_torch.kernels import build, ref
from repro_torch.kernels.mp_matmul import _cuda_stream, _f32, _on_cpu

BLOCK_Q = 32    # csrc BQ
BLOCK_KV = 32   # csrc BKV: the online-softmax granularity both versions use
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int64


def flash_attention_plain(q, k, v, fmt_qk, fmt_pv, *, causal=True,
                          scale: Optional[float] = None, q_offset: int = 0
                          ) -> torch.Tensor:
    """Plain version of :func:`mp_flash_attention`."""
    return ref.mp_attention_ref(q, k, v, fmt_qk, fmt_pv, causal=causal,
                                scale=scale, q_offset=q_offset,
                                block_q=BLOCK_Q, block_kv=BLOCK_KV)


def _set_argtypes(lib) -> None:
    if getattr(lib, "_mp_attention_typed", False):
        return
    lib.mp_flash_attention_launch.argtypes = (
        [_P, _I, _I, _I] * 4 + [_I] * 7 + [ctypes.c_double] + [_I] * 4 + [_P])
    lib.mp_flash_attention_launch.restype = ctypes.c_int
    lib.mp_paged_attention_launch.argtypes = (
        [_P, _I, _I] + [_P, _I, _I, _I] * 2 + [_P, _I, _P, _P] + [_I] * 6
        + [ctypes.c_double] + [_I] * 4 + [_P])
    lib.mp_paged_attention_launch.restype = ctypes.c_int
    lib.mp_mixed_paged_attention_launch.argtypes = (
        list(lib.mp_paged_attention_launch.argtypes[:-1]) + [_P] * 5)
    lib.mp_mixed_paged_attention_launch.restype = ctypes.c_int
    lib._mp_attention_typed = True


def launch_flash_attention(lib, stream: int, q, k, v, fmt_qk, fmt_pv, *,
                           causal: bool, scale: float, q_offset: int
                           ) -> torch.Tensor:
    """Marshal one ``mp_flash_attention_launch`` call.  q (B, S, H, Dh),
    k/v (B, T, H, Dh), read in place through their strides (the head dim
    must be unit-stride, else that operand is copied)."""
    _set_argtypes(lib)
    B, S, H, Dh = q.shape
    T = k.shape[1]
    if k.shape != (B, T, H, Dh) or v.shape != (B, T, H, Dh):
        raise ValueError(f"k/v must be ({B}, T, {H}, {Dh}), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous()
               for x in (_f32(q), _f32(k), _f32(v)))
    o = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    args = []
    for x in (q, k, v, o):
        args += [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]
    err = lib.mp_flash_attention_launch(
        *args, B, S, T, H, Dh, int(causal), q_offset, float(scale),
        fmt_qk.n_limbs, fmt_qk.max_order, fmt_pv.n_limbs, fmt_pv.max_order,
        stream)
    build.check(err, "mp_flash_attention")
    return o


def mp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mode_qk: FormatLike = "M16",
                       mode_pv: Optional[FormatLike] = None, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """Flash attention: q (B, S, H, Dh), k/v (B, T, H, Dh) with H already
    GQA-repeated -> (B, S, H, Dh) f32.  QK^T at ``mode_qk``, P·V at
    ``mode_pv`` (defaults to ``mode_qk``)."""
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if _on_cpu(q, k, v):
        mp_flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, fmt_qk, fmt_pv, causal=causal,
                                     scale=scale, q_offset=q_offset)
    stream = _cuda_stream(q, k, v)
    out = launch_flash_attention(build.load("mp_attention"), stream, q, k, v,
                                 fmt_qk, fmt_pv, causal=causal, scale=scale,
                                 q_offset=q_offset)
    mp_flash_attention.launches += 1
    return out


mp_flash_attention.launches = 0
mp_flash_attention.plain_calls = 0


# ---------------------------------------------------------------------------
# paged decode attention (port of the Pallas ``_paged_kernel``)
# ---------------------------------------------------------------------------
def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor, fmt_qk, fmt_pv, *,
                          scale: float) -> torch.Tensor:
    """Plain version of :func:`mp_paged_attention`: the JAX kernel's steps
    in PyTorch.  Table column j folds pool block ``table[b, j]`` into each
    slot's running (max, denominator, accumulator) through
    ``ref.attn_qk_logits`` / ``ref.online_softmax_update``, for the slots
    with ``j * bs < length`` (the others keep their state, as the kernel
    skips the column)."""
    return _paged_steps(
        q, k_pool, v_pool, block_table, lengths, scale,
        lambda qh, kb: ref.attn_qk_logits(qh, kb, fmt_qk),
        lambda m, d, acc, logits, vb, valid: ref.online_softmax_update(
            m, d, acc, logits, vb, fmt_pv, p_mask=valid))


def mixed_paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_table: torch.Tensor,
                                lengths: torch.Tensor, env_qk, env_pv,
                                lane_qk_n: torch.Tensor,
                                lane_qk_ord: torch.Tensor,
                                lane_pv_n: torch.Tensor,
                                lane_pv_ord: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Plain version of :func:`mp_mixed_paged_attention`: the steps of
    :func:`paged_attention_plain` with each slot's contractions at its own
    lane formats under the envelopes, through the masked cascade of
    ``ref.masked_attn_qk_logits`` / ``ref.masked_online_softmax_update``
    (what the JAX kernel runs).  A slot's output equals
    :func:`paged_attention_plain`'s at the slot's formats up to the sign of
    a zero."""
    env_qk, env_pv = resolve(env_qk), resolve(env_pv)

    def slot_lanes(lane):
        return lane.reshape(-1, 1, 1, 1)

    qn, qo = slot_lanes(lane_qk_n), slot_lanes(lane_qk_ord)
    pn, po = slot_lanes(lane_pv_n), slot_lanes(lane_pv_ord)
    return _paged_steps(
        q, k_pool, v_pool, block_table, lengths, scale,
        lambda qh, kb: ref.masked_attn_qk_logits(qh, kb, env_qk, qn, qo),
        lambda m, d, acc, logits, vb, valid:
            ref.masked_online_softmax_update(m, d, acc, logits, vb, env_pv,
                                             pn, po, p_mask=valid))


def _paged_steps(q, k_pool, v_pool, block_table, lengths, scale, qk,
                 update) -> torch.Tensor:
    """The column walk the paged plain versions share: ``qk`` gives a
    block's logits, ``update`` folds them into the running softmax."""
    B, H, Dh = q.shape
    _, bs, hk, _ = k_pool.shape
    n_rep = H // hk
    W = block_table.shape[1]
    dev = q.device
    qh = (q.float() * scale).reshape(B, hk, n_rep, Dh)
    m = torch.full((B, hk, n_rep), ref.ATTN_NEG_INF, dtype=torch.float32,
                   device=dev)
    d = torch.zeros((B, hk, n_rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, hk, n_rep, Dh), dtype=torch.float32, device=dev)
    lengths = lengths.long()
    table = block_table.long()
    n_cols = min(W, -(-int(lengths.max()) // bs)) if B else 0
    neg = torch.full((), ref.ATTN_NEG_INF, device=dev)
    for j in range(n_cols):
        blk = table[:, j]
        kb = k_pool[blk].float().permute(0, 2, 1, 3)       # (B, hk, bs, Dh)
        vb = v_pool[blk].float().permute(0, 2, 1, 3)
        pos = j * bs + torch.arange(bs, device=dev)
        valid = (pos[None, :] < lengths[:, None])[:, None, None, :]
        logits = torch.where(valid, qk(qh, kb), neg)
        m_new, d_new, acc_new = update(m, d, acc, logits, vb, valid)
        live = (j * bs < lengths)[:, None, None]
        m = torch.where(live, m_new, m)
        d = torch.where(live, d_new, d)
        acc = torch.where(live[..., None], acc_new, acc)
    out = acc / torch.clamp(d[..., None], min=1e-30)
    return out.reshape(B, H, Dh)


def launch_paged_attention(lib, stream: int, q, k_pool, v_pool, block_table,
                           lengths, fmt_qk, fmt_pv, *, scale: float,
                           lanes=None) -> torch.Tensor:
    """Marshal one ``mp_paged_attention_launch`` call: q (B, H, Dh), pools
    (n_blocks, bs, Hkv, Dh) read in place through their strides (head dim
    unit-stride), table (B, W) and lengths (B,) int32.  With ``lanes``
    (the four (B,) int32 lane vectors, read in place) the call is
    ``mp_mixed_paged_attention_launch`` and the formats are envelopes."""
    _set_argtypes(lib)
    B, H, Dh = q.shape
    _, bs, hk, dh = k_pool.shape
    W = block_table.shape[1]
    if v_pool.shape != k_pool.shape or dh != Dh or H % hk:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")
    if block_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"table {tuple(block_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {B} slots")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block table and lengths must be int32")
    if block_table.stride(-1) != 1 or not lengths.is_contiguous():
        raise ValueError("block table rows and lengths must be contiguous")
    for x in (q, k_pool, v_pool):
        if x.dtype != torch.float32 or x.stride(-1) != 1:
            raise ValueError("q and the pools must be f32 with a unit-stride "
                             "head dim")
    lane_ptrs = []
    if lanes is not None:
        for lane in lanes:
            if (lane.dtype != torch.int32 or lane.shape != (B,)
                    or not lane.is_contiguous()):
                raise ValueError(f"lanes must be contiguous ({B},) int32, "
                                 f"got {tuple(lane.shape)} {lane.dtype}")
        lane_ptrs = [lane.data_ptr() for lane in lanes]
    o = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    fn = (lib.mp_paged_attention_launch if lanes is None
          else lib.mp_mixed_paged_attention_launch)
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_pool.data_ptr(), k_pool.stride(0), k_pool.stride(1),
        k_pool.stride(2), v_pool.data_ptr(), v_pool.stride(0),
        v_pool.stride(1), v_pool.stride(2), block_table.data_ptr(),
        block_table.stride(0), lengths.data_ptr(), o.data_ptr(), B, H, hk,
        Dh, bs, W, float(scale), fmt_qk.n_limbs, fmt_qk.max_order,
        fmt_pv.n_limbs, fmt_pv.max_order, *lane_ptrs, stream)
    build.check(err, "mp_paged_attention" if lanes is None
                else "mp_mixed_paged_attention")
    return o


def mp_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_table: torch.Tensor,
                       lengths: torch.Tensor, mode_qk: FormatLike = "M16",
                       mode_pv: Optional[FormatLike] = None, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Paged-decode attention: one query per slot, q (B, H, Dh) against the
    pools (n_blocks, bs, Hkv, Dh) through ``block_table`` (B, W) int32 and
    ``lengths`` (B,) int32 -> (B, H, Dh) f32.  The GQA ratio is H // Hkv.
    CPU tensors run :func:`paged_attention_plain`; CUDA tensors launch the
    kernel."""
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    tensors = (q, k_pool, v_pool, block_table, lengths)
    if _on_cpu(*tensors):
        mp_paged_attention.plain_calls += 1
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths,
                                     fmt_qk, fmt_pv, scale=scale)
    stream = _cuda_stream(*tensors)
    out = launch_paged_attention(build.load("mp_attention"), stream, q,
                                 k_pool, v_pool, block_table, lengths,
                                 fmt_qk, fmt_pv, scale=scale)
    mp_paged_attention.launches += 1
    return out


mp_paged_attention.launches = 0
mp_paged_attention.plain_calls = 0


def mp_mixed_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_table: torch.Tensor,
                             lengths: torch.Tensor, env_qk: FormatLike,
                             env_pv: FormatLike, lane_qk_n: torch.Tensor,
                             lane_qk_ord: torch.Tensor,
                             lane_pv_n: torch.Tensor,
                             lane_pv_ord: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Partitioned-lane paged decode: :func:`mp_paged_attention` for a
    micro-batch whose slots run different formats, in one launch.  Slot b
    runs QK at (``lane_qk_n[b]`` limbs, order cut ``lane_qk_ord[b]``) and PV
    at (``lane_pv_n[b]``, ``lane_pv_ord[b]``), (B,) int32 each, at or below
    the envelopes ``env_qk`` / ``env_pv``; its output is
    :func:`mp_paged_attention`'s at its own formats.  CPU tensors run
    :func:`mixed_paged_attention_plain`; CUDA tensors launch the kernel."""
    env_qk, env_pv = resolve(env_qk), resolve(env_pv)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    lanes = (lane_qk_n, lane_qk_ord, lane_pv_n, lane_pv_ord)
    tensors = (q, k_pool, v_pool, block_table, lengths) + lanes
    if _on_cpu(*tensors):
        mp_mixed_paged_attention.plain_calls += 1
        return mixed_paged_attention_plain(
            q, k_pool, v_pool, block_table, lengths, env_qk, env_pv, *lanes,
            scale=scale)
    stream = _cuda_stream(*tensors)
    out = launch_paged_attention(build.load("mp_attention"), stream, q,
                                 k_pool, v_pool, block_table, lengths,
                                 env_qk, env_pv, scale=scale, lanes=lanes)
    mp_mixed_paged_attention.launches += 1
    return out


mp_mixed_paged_attention.launches = 0
mp_mixed_paged_attention.plain_calls = 0
