"""Mamba2 mixer via SSD (port of ``repro.models.ssm``; state-space duality,
arXiv:2405.21060 §6).

The SSD chunked algorithm splits the selective scan into block terms:
  * intra-chunk: a masked, decay-weighted quadratic product, as batched
    matmuls over (B, chunks, groups or heads) through ``mp_matmul`` (policy
    class "ssm"): each product is ONE batched launch;
  * inter-chunk: per-chunk states passed through a short sequential loop
    (an element-wise decay recurrence in f32, outside the multiplier, as in
    the JAX package).

Under the Ulysses layout (``dist/seq_layout.py``) a layer runs this rank's
block of the sequence after the previous block's: the conv takes that
block's last ``d_conv - 1`` pre-conv inputs as its window and the chunk
recurrence its final state as the initial state (the one-rank loop's carry
at that chunk), handed on in rank order over the sequence group.

Decode keeps a recurrent cache: the conv window (d_conv - 1 samples) and the
SSM state (B, H, dh, ds): O(1) per token.  The conv is shifted adds (d_conv
is tiny), never a cuDNN convolution, and the decode update is plain f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mpmatmul import mp_dense, mp_matmul
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import seq_layout as seq_layout_lib
from repro_torch.models.layers import dense_init, normal, rand, rms_norm


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        # z (d_inner) + xBC (conv_dim) + dt (n_heads)
        return self.d_inner + self.conv_dim + self.n_heads


@dataclasses.dataclass
class SSMCache:
    conv: torch.Tensor   # (B, d_conv - 1, conv_dim) rolling window
    state: torch.Tensor  # (B, H, dh, ds)
    length: int = 0


def init_ssm_params(gen: torch.Generator, dims: SSMDims, device=None
                    ) -> dict:
    H = dims.n_heads
    u = rand(gen, H)
    dt = torch.exp(u * (math.log(dims.dt_max) - math.log(dims.dt_min))
                   + math.log(dims.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": dense_init(gen, dims.d_model, dims.in_proj_dim,
                              device=device),
        "conv_w": normal(gen, (dims.d_conv, dims.conv_dim), 0.1, device),
        "conv_b": torch.zeros(dims.conv_dim, device=device),
        "dt_bias": dt_bias.to(device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones(H, device=device),
        "norm_w": torch.ones(dims.d_inner, device=device),
        "out_proj": dense_init(gen, dims.d_inner, dims.d_model,
                               device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) for every x (PyTorch's softplus
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d via shifted adds.  x: (B, S, C); w: (K, C);
    init_window: (B, K - 1, C), the decode carry-in."""
    K = w.shape[0]
    if init_window is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = init_window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S + K - 1, C)
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * w[k].float()
    return out + b.float()


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dims: SSMDims,
                 policy: PrecisionPolicy,
                 init_state: Optional[torch.Tensor] = None, handover=None):
    """SSD over chunks.  xh: (B, S, H, dh); dt: (B, S, H); A: (H,) negative;
    Bm/Cm: (B, S, G, ds).  Returns (y (B, S, H, dh), final state
    (B, H, dh, ds)).  ``handover`` (a ``dist.seq_layout.SSMHandover``):
    the initial state is the previous sequence block's final state,
    received right before the chunk recurrence, and the final state goes
    on to the next block."""
    Bsz, S, H, dh = xh.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    hpg = H // G                                      # heads per group
    cl = min(dims.chunk, S)
    S_orig = S
    if S % cl:  # pad to a chunk multiple; zero x/B/C contribute nothing
        pad = cl - S % cl
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // cl
    mode = policy.mode("ssm")
    bwd = policy.bwd_kwargs("ssm")

    x_c = xh.reshape(Bsz, nc, cl, H, dh)
    dt_c = dt.reshape(Bsz, nc, cl, H)
    B_c = Bm.reshape(Bsz, nc, cl, G, ds)
    C_c = Cm.reshape(Bsz, nc, cl, G, ds)

    dA = dt_c * A[None, None, None, :]                # (B, nc, cl, H)
    cum = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    seg_total = cum[:, :, -1, :]                      # (B, nc, H)

    # --- intra-chunk: decay L[i, j] = exp(cum_i - cum_j) for i >= j -------
    # masked before the exp: above the diagonal cum_i - cum_j > 0 overflows
    # to inf over a long chunk, and the gradient through exp(inf) masked to
    # 0 afterwards is 0 * inf = NaN (the JAX package masks after the exp);
    # exp(-inf) = 0, so the forward's bits are the same
    Li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,l,s,H)
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=xh.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], Li,
                              torch.full((), -math.inf, device=xh.device)))
    # scores per group, C_i · B_j: (B,nc,G,l,ds) @ (B,nc,G,ds,s)
    Cg = C_c.permute(0, 1, 3, 2, 4)
    Bg = B_c.permute(0, 1, 3, 4, 2)
    scores = mp_matmul(Cg, Bg, mode, **bwd)                   # (B,nc,G,l,s)
    scores = torch.repeat_interleave(scores, hpg, dim=2)      # (B,nc,H,l,s)
    Lh = L.permute(0, 1, 4, 2, 3)
    w = scores * Lh * dt_c.permute(0, 1, 3, 2)[:, :, :, None, :]
    xg = x_c.permute(0, 1, 3, 2, 4)                           # (B,nc,H,s,dh)
    y_intra = mp_matmul(w.float(), xg.float(), mode, **bwd)   # (B,nc,H,l,dh)

    # --- chunk states: sum_s exp(seg_total - cum_s) dt_s B_s (x) x_s -------
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)  # (B,nc,cl,H)
    wB = B_c[:, :, :, :, None, :].expand(Bsz, nc, cl, G, hpg, ds).reshape(
        Bsz, nc, cl, H, ds)
    wBx = (decay_to_end * dt_c)[..., None] * wB               # (B,nc,cl,H,ds)
    # (B,nc,H,dh,cl) @ (B,nc,H,cl,ds) -> (B,nc,H,dh,ds)
    s_chunk = mp_matmul(x_c.permute(0, 1, 3, 4, 2).float(),
                        wBx.permute(0, 1, 3, 2, 4).float(), mode, **bwd)

    # --- inter-chunk state recurrence (sequential over nc, f32) ------------
    seg_decay = torch.exp(seg_total)                          # (B, nc, H)
    if handover is not None:
        init_state = handover.recv_state(s_chunk[:, 0])
    state = (init_state if init_state is not None
             else torch.zeros((Bsz, H, dh, ds), device=xh.device))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(state)                  # the state BEFORE chunk c
        state = state * seg_decay[:, c, :, None, None] + s_chunk[:, c]
    s_prev = torch.stack(s_prevs, dim=1)                      # (B,nc,H,dh,ds)
    if handover is not None:
        handover.send_state(state)

    # --- inter-chunk contribution: y_inter[l] = exp(cum_l) C_l · S_prev ----
    Ch = torch.repeat_interleave(C_c.permute(0, 1, 3, 2, 4), hpg, dim=2)
    y_inter = mp_matmul(Ch.float(), s_prev.permute(0, 1, 2, 4, 3).float(),
                        mode, **bwd)                          # (B,nc,H,l,dh)
    y_inter = y_inter * torch.exp(cum).permute(0, 1, 3, 2)[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, dh)
    return y[:, :S_orig], state


def ssm_forward(params: dict, x: torch.Tensor, dims: SSMDims,
                policy: PrecisionPolicy, *, cache: Optional[SSMCache] = None
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    B, S, _ = x.shape
    H, dh, ds, G = dims.n_heads, dims.head_dim, dims.d_state, dims.n_groups
    mode, bwd = policy.mode("ssm"), policy.bwd_kwargs("ssm")

    zxbcdt = mp_dense(x, params["in_proj"], mode, **bwd)
    z, xBC_pre, dt = torch.split(
        zxbcdt, [dims.d_inner, dims.conv_dim, H], dim=-1)

    if cache is not None and S == 1:
        return _decode_step(params, z, xBC_pre, dt, dims, policy, cache)

    seq = seq_layout_lib.current_seq_layout()
    hand = window = None
    if seq is not None:   # this rank's block: the previous block's carry
        if S % dims.chunk:
            raise ValueError(
                f"a sequence block of {S} positions under the Ulysses "
                f"layout: the SSD chunks ({dims.chunk}) must tile each "
                f"block, or the blocks would not chunk as the whole "
                f"sequence does")
        hand = seq_layout_lib.SSMHandover(seq, xBC_pre)
        window = hand.window(xBC_pre, dims.d_conv - 1)
    xBC = F.silu(_causal_conv(xBC_pre, params["conv_w"], params["conv_b"],
                              init_window=window))
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, G * ds, G * ds], dim=-1)
    xh = xs.reshape(B, S, H, dh)
    Bm = Bm.reshape(B, S, G, ds)
    Cm = Cm.reshape(B, S, G, ds)
    dt = softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    y, final_state = _ssd_chunked(xh.float(), dt, A, Bm, Cm, dims, policy,
                                  handover=hand)
    y = y + params["D"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, dims.d_inner)
    y = y * F.silu(z.float())
    y = rms_norm(y, params["norm_w"])
    if hand is not None:
        y = hand.tie(y)
    out = mp_dense(y.to(x.dtype), params["out_proj"], mode, **bwd)

    new_cache = None
    if cache is not None:  # prefill: stash the conv window and final state
        K = dims.d_conv
        conv_tail = xBC_pre[:, S - (K - 1):, :]  # last K-1 pre-conv inputs
        if seq is not None:   # the last block's, on every rank
            conv_tail = seq_layout_lib.from_last(conv_tail, seq)
            final_state = seq_layout_lib.from_last(final_state, seq)
            S = seq.seq_len
        new_cache = SSMCache(conv=conv_tail.to(cache.conv.dtype),
                             state=final_state.to(cache.state.dtype),
                             length=cache.length + S)
    return out, new_cache


def _decode_step(params: dict, z: torch.Tensor, xBC_new: torch.Tensor,
                 dt: torch.Tensor, dims: SSMDims, policy: PrecisionPolicy,
                 cache: SSMCache):
    """O(1) recurrent decode: roll the conv window, update the state."""
    B = z.shape[0]
    H, dh, ds, G = dims.n_heads, dims.head_dim, dims.d_state, dims.n_groups

    window = torch.cat([cache.conv.float(), xBC_new.float()], dim=1)
    # the new position of the causal conv over the carried window
    conv_out = _causal_conv(xBC_new.float(), params["conv_w"],
                            params["conv_b"], init_window=cache.conv)
    xBC = F.silu(conv_out)                                    # (B, 1, conv)
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, G * ds, G * ds], dim=-1)
    xh = xs.reshape(B, H, dh)
    Bm = torch.repeat_interleave(Bm.reshape(B, G, ds), H // G, dim=1)
    Cm = torch.repeat_interleave(Cm.reshape(B, G, ds), H // G, dim=1)
    dt = softplus(dt[:, 0].float() + params["dt_bias"].float())   # (B, H)
    A = -torch.exp(params["A_log"].float())

    state = cache.state.float()
    decay = torch.exp(dt * A[None, :])                        # (B, H)
    upd = (dt[..., None] * xh)[..., None] * Bm[:, :, None, :]  # (B,H,dh,ds)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhds,bhs->bhd", state, Cm)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, dims.d_inner)
    y = y * F.silu(z.float())
    y = rms_norm(y, params["norm_w"])
    out = mp_dense(y.float(), params["out_proj"], policy.mode("ssm"),
                   **policy.bwd_kwargs("ssm"))
    return out, SSMCache(conv=window[:, 1:, :].to(cache.conv.dtype),
                         state=state.to(cache.state.dtype),
                         length=cache.length + 1)


def make_ssm_cache(batch: int, dims: SSMDims, dtype=torch.float32,
                   device=None) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, dims.d_conv - 1, dims.conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, dims.n_heads, dims.head_dim,
                           dims.d_state), dtype=dtype, device=device),
        length=0)
