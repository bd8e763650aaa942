"""GQA / MHA attention (port of ``repro.models.attention``: the no-cache,
dense-KV-cache and paged-KV-cache paths): fused multi-precision flash
attention via ``mp_attention``, the chunk-scan fallback for long sequences,
single-token decode against the dense cache, and the paged pool's write and
decode attention (the continuous scheduler's path).

All projections and both attention contractions run through the
multi-precision ops, so the block obeys the run-time precision policy; the
attention contractions resolve the ``attn_qk`` / ``attn_pv`` op classes
(aliases of ``attn_logits`` / ``attn_out``).  Inside a mixed decode step
(``core/lanes.py``) the projections and the paged decode attention run each
slot at its own formats, in one launch per call site.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core import lanes as lanes_lib
from repro_torch.core.formats import is_auto
from repro_torch.core.mpmatmul import mp_attention, mp_dense, mp_matmul, \
    mp_qkv_proj
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.serve.kv_cache import TRASH_BLOCK, PagedKVCache

NEG_INF = -1e30

# ceiling on the probability matrix (B·H·S·T f32 elements) the fused path
# may form in the JAX package's backward; longer sequences take the
# chunk-scan there, and the port routes them the same way
FUSED_P_MAX_ELEMENTS = 1 << 24


@dataclasses.dataclass
class KVCache:
    """Dense per-layer cache.  Unlike the JAX package's immutable cache, the
    port writes new positions into ``k``/``v`` in place (no per-step copy of
    the whole cache); ``length`` is the valid prefix."""

    k: torch.Tensor     # (B, S_max, Hkv, Dh)
    v: torch.Tensor     # (B, S_max, Hkv, Dh)
    length: int = 0


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    causal: bool = True


def init_attn_params(gen: torch.Generator, dims: AttnDims, device=None
                     ) -> dict:
    d, h, hk, dh = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "wq": dense_init(gen, d, h * dh, device=device),
        "wk": dense_init(gen, d, hk * dh, device=device),
        "wv": dense_init(gen, d, hk * dh, device=device),
        "wo": dense_init(gen, h * dh, d, device=device),
    }


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hkv*n_rep, Dh) — GQA head sharing."""
    if n_rep == 1:
        return x
    b, s, hk, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, n_rep, dh).reshape(
        b, s, hk * n_rep, dh)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      policy: PrecisionPolicy, *, causal: bool = True,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Chunk-scan attention: loop over query chunks and, inside, kv chunks
    with a running (max, denom, accum); one ``mp_matmul`` per chunk pair.
    Memory O(q_chunk x kv_chunk) per head instead of O(S·T)."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    dev = q.device
    # divisible lengths keep their exact chunking; ragged lengths cap the
    # chunk at q_chunk/kv_chunk and pad-and-mask the tail chunk
    nq = max(1, S // q_chunk)
    nk = max(1, T // kv_chunk)
    if S % nq:
        qc = max(1, min(q_chunk, S))
        nq = -(-S // qc)
    else:
        qc = S // nq
    if T % nk:
        kc = max(1, min(kv_chunk, T))
        nk = -(-T // kc)
    else:
        kc = T // nk
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh)))

    S_pad, T_pad = nq * qc, nk * kc
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, S_pad - S))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, T_pad - T))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, T_pad - T))

    mode_l = policy.mode("attn_qk")    # alias: attn_logits
    mode_o = policy.mode("attn_pv")    # alias: attn_out

    # (B, S_pad, H, Dh) -> (nq, B, H, qc, Dh)
    qr = q.reshape(B, nq, qc, H, Dh).permute(1, 0, 3, 2, 4) * scale.to(dev)
    kr = k.reshape(B, nk, kc, H, Dh).permute(1, 0, 3, 2, 4)
    vr = v.reshape(B, nk, kc, H, Dh).permute(1, 0, 3, 2, 4)
    q_pos = (q_offset + torch.arange(S_pad, device=dev)).reshape(nq, qc)
    k_pos = torch.arange(T_pad, device=dev).reshape(nk, kc)
    neg = torch.full((), NEG_INF, device=dev)

    outs = []
    for qi in range(nq):
        m_run = torch.full((B, H, qc), NEG_INF, device=dev)
        d_run = torch.zeros((B, H, qc), device=dev)
        acc = torch.zeros((B, H, qc, Dh), device=dev)
        for ki in range(nk):
            logits = mp_matmul(qr[qi], kr[ki].transpose(-1, -2), mode_l)
            if causal:
                mask = q_pos[qi][:, None] >= k_pos[ki][None, :]
                if T_pad != T:  # padded tail keys are not real positions
                    mask = mask & (k_pos[ki][None, :] < T)
                logits = torch.where(mask, logits, neg)
            elif T_pad != T:
                logits = torch.where(k_pos[ki][None, :] < T, logits, neg)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            d_run = d_run * alpha + p.sum(dim=-1)
            pv = mp_matmul(p.float(), vr[ki], mode_o)
            acc = acc * alpha[..., None] + pv
            m_run = m_new
        outs.append(acc / torch.clamp(d_run[..., None], min=1e-30))
    # (nq, B, H, qc, Dh) -> (B, S_pad, H, Dh); drop padded query rows
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S_pad, H, Dh)
    return out[:, :S]


def _self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    policy: PrecisionPolicy, *, causal: bool = True,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Route full self-attention: the fused flash path (``mp_attention``)
    when eligible, else the chunk-scan — AUTO formats and sequences with
    B·H·S·T > FUSED_P_MAX_ELEMENTS take the chunk-scan, as in the JAX
    package."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    fmt_qk = policy.mode("attn_qk")
    fmt_pv = policy.mode("attn_pv")
    if (is_auto(fmt_qk) or is_auto(fmt_pv)
            or B * H * S * T > FUSED_P_MAX_ELEMENTS):
        return chunked_attention(q, k, v, policy, causal=causal,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    return mp_attention(q, k, v, fmt_qk, fmt_pv, causal=causal)


def gqa_forward(params: dict, x: torch.Tensor, dims: AttnDims,
                policy: PrecisionPolicy, *,
                positions: Optional[torch.Tensor] = None,
                cache=None, q_chunk: int = 1024, kv_chunk: int = 1024
                ) -> Tuple[torch.Tensor, object]:
    """Full attention block.  Prefill when cache is None or S > 1;
    single-token decode writes the cache in place and attends over it.
    ``cache`` is a dense :class:`KVCache` or one layer's
    :class:`PagedKVCache` view."""
    B, S, D = x.shape
    h, hk, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    lanes = lanes_lib.current_lanes()
    if lanes is not None:
        # mixed decode: per-branch lane matmuls at each slot's qkv format
        env, ln, lo = lanes.for_class("qkv")
        q, k, v = dispatch_lib.mixed_fused_proj(
            x, (params["wq"], params["wk"], params["wv"]), env, ln, lo)
    else:
        # one fused projection group: x is read and limbed once for all
        q, k, v = mp_qkv_proj(x, params["wq"], params["wk"], params["wv"],
                              policy.mode("qkv"))
    q = q.reshape(B, S, h, dh)
    k = k.reshape(B, S, hk, dh)
    v = v.reshape(B, S, hk, dh)

    if positions is None:
        base = cache.length if cache is not None else 0
        if torch.is_tensor(base) and base.ndim:  # paged per-slot (B,)
            base = base[:, None]
        positions = (base + torch.arange(S, device=x.device)[None, :])
        positions = positions.expand(B, S)

    if dims.rope_theta > 0:
        q = apply_rope(q, positions, dims.rope_theta, dims.rope_fraction)
        k = apply_rope(k, positions, dims.rope_theta, dims.rope_fraction)

    new_cache = None
    if isinstance(cache, PagedKVCache):
        new_cache = _paged_write(cache, k, v, positions)
        if S == 1:
            out = _paged_decode_attention(q, new_cache, dims, policy)
        else:
            # paged prefill is always into a fresh slot (per-slot length 0),
            # so attention is plain self-attention over the new K/V
            out = _self_attention(q, _repeat_kv(k, h // hk),
                                  _repeat_kv(v, h // hk), policy,
                                  causal=dims.causal, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
    elif cache is not None:
        start = cache.length
        cache.k[:, start:start + S] = k.to(cache.k.dtype)
        cache.v[:, start:start + S] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, start + S)
        if S == 1:
            out = _decode_attention(q, cache.k, cache.v, new_cache.length,
                                    dims, policy)
        else:  # prefill into an empty cache: attend over the written prefix
            out = _self_attention(q, _repeat_kv(k, h // hk),
                                  _repeat_kv(v, h // hk), policy,
                                  causal=dims.causal, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
    else:
        out = _self_attention(q, _repeat_kv(k, h // hk),
                              _repeat_kv(v, h // hk), policy,
                              causal=dims.causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    out = out.reshape(B, S, h * dh)
    if lanes is not None:
        env, ln, lo = lanes.for_class("attn_out")
        return (dispatch_lib.dispatch_mixed_matmul(out, params["wo"], env,
                                                   ln, lo), new_cache)
    return mp_dense(out, params["wo"], policy.mode("attn_out")), new_cache


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, length: int, dims: AttnDims,
                      policy: PrecisionPolicy) -> torch.Tensor:
    """One-token attention against the whole cache, masked by ``length``.
    Both contractions route through ``mp_matmul`` at the policy-resolved
    ``attn_qk`` / ``attn_pv`` formats (``masked_decode_attention``)."""
    n_rep = dims.n_heads // dims.n_kv_heads
    kk = _repeat_kv(k_cache.float(), n_rep)   # (B, T, H, Dh)
    vv = _repeat_kv(v_cache.float(), n_rep)
    return dispatch_lib.masked_decode_attention(
        q, kk, vv, length, policy.mode("attn_qk"), policy.mode("attn_pv"))


def _paged_write(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor) -> PagedKVCache:
    """Scatter S new K/V tokens per slot into the layer's pool blocks, in
    place (one ``index_put_`` per pool).

    ``positions`` (B, S) are absolute token positions; each lands at
    ``(block_table[pos // bs], pos % bs)``.  Positions past the table's
    width go to the trash block (clamping them into the last column could
    overwrite a full row's last real block); positions past a slot's
    reservation land in trash through the trash-padded table, or in the
    row's own reserved tail, which is rewritten before any read
    (serve/kv_cache.py).  Two writes of one step meet only in the trash
    block, which is never read.  Returns the view with lengths + S."""
    B, S = positions.shape
    bs = cache.block_size
    W = cache.block_table.shape[1]
    col = torch.div(positions, bs, rounding_mode="floor")
    blk = torch.gather(cache.block_table, 1,
                       torch.clamp(col, 0, W - 1).to(torch.long))
    blk = torch.where(col < W, blk, torch.full_like(blk, TRASH_BLOCK))
    off = positions % bs
    hk, dh = k.shape[2], k.shape[3]
    idx = (blk.reshape(-1).long(), off.reshape(-1).long())
    cache.k.index_put_(idx, k.reshape(B * S, hk, dh).to(cache.k.dtype))
    cache.v.index_put_(idx, v.reshape(B * S, hk, dh).to(cache.v.dtype))
    return PagedKVCache(cache.k, cache.v, cache.block_table,
                        cache.length + S)


def _paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                            dims: AttnDims, policy: PrecisionPolicy
                            ) -> torch.Tensor:
    """One-token attention against the paged pool through the dispatch
    layer: the paged kernel on ``cuda`` (pool blocks read through the
    table, no gather), the gather + masked einsums on ``ref``; inside a
    mixed decode step their lane forms, each slot at its own formats."""
    lanes = lanes_lib.current_lanes()
    if lanes is not None:
        env_qk, ln_qk, lo_qk = lanes.for_class("attn_qk")
        env_pv, ln_pv, lo_pv = lanes.for_class("attn_pv")
        return dispatch_lib.dispatch_mixed_paged_attention(
            q, cache.k, cache.v, cache.block_table, cache.length,
            env_qk, env_pv, ln_qk, lo_qk, ln_pv, lo_pv)
    return dispatch_lib.dispatch_paged_attention(
        q, cache.k, cache.v, cache.block_table, cache.length,
        policy.mode("attn_qk"), policy.mode("attn_pv"))


def make_kv_cache(batch: int, max_seq: int, dims: AttnDims,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_seq, dims.n_kv_heads, dims.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), length=0)
