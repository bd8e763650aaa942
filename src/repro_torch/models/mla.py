"""Multi-head Latent Attention (port of ``repro.models.mla``; DeepSeek-V2,
arXiv:2405.04434) with the compressed-latent KV cache and the
weight-absorbed decode path.

Prefill: the latent is up-projected to per-head K/V and attention runs
through the flash kernel at the QK head dim (qk_nope + qk_rope: 192 for
DeepSeek-V2), with V padded up to it so one kernel serves both
contractions.  Decode: the cache stores only ``c_kv`` (kv_lora dims) and
the shared ``k_rope`` (qk_rope dims) per token, and the K up-projection is
absorbed into the query so attention runs in latent space (under a decode
layout, ``dist/decode_layout.py``, over this rank's block of the latent,
the softmax and the context ``p @ c_kv`` combined over the sequence group
before ``w_uv``, which every rank of the group applies alike).  Under the
Ulysses layout (``dist/seq_layout.py``) the prefill runs on this rank's
block of the sequence: the per-head K and padded V take the layout's
heads or seq mode, and the latent cache's block is the rank's.  The absorbed
einsums run in f32 outside the multiplier, as in the JAX package (which
computes them in XLA, outside any Pallas kernel); every projection routes
through the multi-precision ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.mpmatmul import mp_dense, mp_fused_proj
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import decode_layout as decode_layout_lib
from repro_torch.dist import seq_layout as seq_layout_lib
from repro_torch.models.attention import _self_attention, laid_out_attention
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


@dataclasses.dataclass
class MLACache:
    """Per-layer latent cache, written in place like ``KVCache``; ``length``
    is the valid prefix."""

    c_kv: torch.Tensor     # (B, S_max, kv_lora)
    k_rope: torch.Tensor   # (B, S_max, qk_rope)
    length: int = 0


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    kv_lora: int           # latent width (512 for DeepSeek-V2)
    q_lora: int = 0        # 0 = no query compression
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla_params(gen: torch.Generator, dims: MLADims, device=None) -> dict:
    d, h = dims.d_model, dims.n_heads
    p = {
        # KV path: down to latent, up to per-head K(nope)/V
        "w_dkv": dense_init(gen, d, dims.kv_lora, device=device),
        "w_uk": dense_init(gen, dims.kv_lora, h * dims.qk_nope_dim,
                           device=device),
        "w_uv": dense_init(gen, dims.kv_lora, h * dims.v_head_dim,
                           device=device),
        # decoupled shared rope key (one per token, shared across heads)
        "w_kr": dense_init(gen, d, dims.qk_rope_dim, device=device),
        "w_o": dense_init(gen, h * dims.v_head_dim, d, device=device),
    }
    if dims.q_lora > 0:
        p["w_dq"] = dense_init(gen, d, dims.q_lora, device=device)
        p["w_uq"] = dense_init(gen, dims.q_lora, h * dims.qk_head_dim,
                               device=device)
    else:
        p["w_q"] = dense_init(gen, d, h * dims.qk_head_dim, device=device)
    return p


def _input_projections(params: dict, x: torch.Tensor, dims: MLADims,
                       policy: PrecisionPolicy):
    """The projections that consume ``x`` as ONE fused group: q (or its
    LoRA down-projection), the KV latent and the shared rope key (three
    unequal widths, which the fused projection concatenates along N: x is
    read and limbed once).  Returns (q_nope, q_rope, c_kv, k_rope), rope
    not yet applied."""
    B, S, _ = x.shape
    mode, bwd = policy.mode("qkv"), policy.bwd_kwargs("qkv")
    wq = params["w_dq"] if dims.q_lora > 0 else params["w_q"]
    q, c_kv, k_rope = mp_fused_proj(
        x, (wq, params["w_dkv"], params["w_kr"]), mode, **bwd)
    if dims.q_lora > 0:
        q = mp_dense(q, params["w_uq"], mode, **bwd)
    q = q.reshape(B, S, dims.n_heads, dims.qk_head_dim)
    return (q[..., :dims.qk_nope_dim], q[..., dims.qk_nope_dim:],
            c_kv, k_rope)


def mla_forward(params: dict, x: torch.Tensor, dims: MLADims,
                policy: PrecisionPolicy, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[MLACache] = None, q_chunk: int = 1024,
                kv_chunk: int = 1024
                ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    B, S, _ = x.shape
    h = dims.n_heads
    mode, bwd = policy.mode("qkv"), policy.bwd_kwargs("qkv")

    if positions is None:
        base = cache.length if cache is not None else 0
        positions = (base + torch.arange(S, device=x.device)[None, :]
                     ).expand(B, S)

    q_nope, q_rope, c_kv, k_rope = _input_projections(params, x, dims,
                                                      policy)
    q_rope = apply_rope(q_rope, positions, dims.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        dims.rope_theta)[:, :, 0, :]

    new_cache = None
    seq = seq_layout_lib.current_seq_layout()
    if seq is not None and cache is not None:
        # a prefill under the Ulysses layout: this rank's block of the
        # latent cache
        seq_layout_lib.cache_block_write(cache.c_kv, cache.length, c_kv,
                                         seq)
        seq_layout_lib.cache_block_write(cache.k_rope, cache.length,
                                         k_rope, seq)
        new_cache = MLACache(cache.c_kv, cache.k_rope, seq.seq_len)
    elif cache is not None:
        start = cache.length
        layout = decode_layout_lib.current_decode_layout()
        if layout is not None:   # on the rank whose block holds start
            decode_layout_lib.block_write(cache.c_kv, start, c_kv, layout)
            decode_layout_lib.block_write(cache.k_rope, start, k_rope,
                                          layout)
        else:
            cache.c_kv[:, start:start + S] = c_kv.to(cache.c_kv.dtype)
            cache.k_rope[:, start:start + S] = k_rope.to(cache.k_rope.dtype)
        new_cache = MLACache(cache.c_kv, cache.k_rope, start + S)
        if S == 1:
            out = _absorbed_decode(params, q_nope, q_rope, cache.c_kv,
                                   cache.k_rope, new_cache.length, dims)
            out = mp_dense(out.reshape(B, S, h * dims.v_head_dim),
                           params["w_o"], policy.mode("attn_out"),
                           **policy.bwd_kwargs("attn_out"))
            return out, new_cache

    # prefill: up-project the latent to per-head K, V (unabsorbed); both
    # contract c_kv, so they share one fused A decomposition too
    k_nope, v = mp_fused_proj(c_kv, (params["w_uk"], params["w_uv"]), mode,
                              **bwd)
    k_nope = k_nope.reshape(B, S, h, dims.qk_nope_dim)
    v = v.reshape(B, S, h, dims.v_head_dim)
    k_rope_h = k_rope[:, :, None, :].expand(B, S, h, dims.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    # pad V's head dim up to the QK head dim so one attention kernel serves
    # both (values ignore the pad after the contraction)
    pad = dims.qk_head_dim - dims.v_head_dim
    v_p = torch.nn.functional.pad(v, (0, pad)) if pad > 0 else v
    if seq is not None:   # the block's queries: heads or seq mode
        out = laid_out_attention(q, k, v_p, policy, seq, causal=True,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    else:
        out = _self_attention(q, k, v_p, policy, causal=True,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out[..., :dims.v_head_dim].reshape(B, S, h * dims.v_head_dim)
    out = mp_dense(out, params["w_o"], policy.mode("attn_out"),
                   **policy.bwd_kwargs("attn_out"))
    return out, new_cache


def _absorbed_decode(params: dict, q_nope: torch.Tensor,
                     q_rope: torch.Tensor, c_kv: torch.Tensor,
                     k_rope: torch.Tensor, length: int, dims: MLADims
                     ) -> torch.Tensor:
    """Weight-absorbed single-token decode in latent space, in f32:

    q_lat[h] = q_nope[h] @ W_uk[h]^T  (absorb the K up-projection)
    logits   = q_lat · c_kv + q_rope · k_rope       (T x kv_lora cache only)
    out[h]   = (p @ c_kv) @ W_uv[h]                 (absorb V's after)
    """
    B, _, h, dn = q_nope.shape
    lora, dr, dv = dims.kv_lora, dims.qk_rope_dim, dims.v_head_dim
    w_uk = params["w_uk"].float().reshape(lora, h, dn)
    q_lat = torch.einsum("bshd,lhd->bhl", q_nope.float(), w_uk)
    scale = 1.0 / torch.sqrt(torch.tensor(float(dn + dr)))
    T = c_kv.shape[1]
    ckv = c_kv.float()
    krp = k_rope.float()
    logits = (torch.einsum("bhl,btl->bht", q_lat, ckv)
              + torch.einsum("bshd,btd->bht", q_rope.float(), krp)
              ) * scale.to(q_lat.device)
    layout = decode_layout_lib.current_decode_layout()
    if layout is not None and layout.seq is not None:
        # this rank's block of the latent: the softmax combined over the
        # sequence group, the context summed in latent space
        from repro_torch.dist.attention import combine_block

        ctx = combine_block(
            logits[:, :, None, :], length, layout.seq_block[0],
            layout.seq_group,
            lambda p: torch.einsum("bht,btl->bhl", p[:, :, 0], ckv)[
                :, :, None])[:, :, 0]                        # (B, H, lora)
    else:
        mask = torch.arange(T, device=ckv.device)[None, None, :] < length
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, device=ckv.device))
        p = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bht,btl->bhl", p, ckv)          # (B, H, lora)
    w_uv = params["w_uv"].float().reshape(lora, h, dv)
    out = torch.einsum("bhl,lhd->bhd", ctx, w_uv)
    return out.reshape(B, 1, h, dv)


def make_mla_cache(batch: int, max_seq: int, dims: MLADims,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_seq, dims.kv_lora), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_seq, dims.qk_rope_dim), dtype=dtype,
                           device=device),
        length=0)
