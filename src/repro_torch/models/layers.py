"""Shared layer primitives (port of ``repro.models.layers``).  Every dense
contraction routes through the multi-precision ops so the whole network
obeys one PrecisionPolicy."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core import lanes as lanes_lib
from repro_torch.core.mpmatmul import mp_dense, mp_swiglu
from repro_torch.core.policy import PrecisionPolicy


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, in an order that does not depend on how many
    rows there are.  PyTorch's CUDA reduction picks its thread layout from
    the number of outputs too (a (8, 768) row sum splits each row across 64
    lanes, a (1, 768) one across 128), so one row's sum changes with the
    batch it sits in.  Summing 32-element chunks first, then the chunk
    sums, gives both passes a layout fixed by the row length alone: the
    decode micro-batch width (1, 2, 4 or 8 slots) cannot move a token."""
    D = x.shape[-1]
    if D % 32 or D == 32:
        return x.sum(dim=-1, keepdim=True)
    chunks = x.reshape(x.shape[:-1] + (D // 32, 32)).sum(dim=-1)
    return chunks.sum(dim=-1, keepdim=True)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = _row_sum(x * x) / x.shape[-1]
    return (x * torch.rsqrt(var + eps) * weight).to(dt)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, policy: PrecisionPolicy,
               op_class: str = "ffn") -> torch.Tensor:
    """LLaMA-style gated MLP: down( silu(x@gate) * (x@up) ).  The gate/up
    pair runs as ONE fused projection (x read and limbed once, the silu-gate
    combine applied in the kernel's epilogue).  Inside a mixed decode step
    every slot runs the MLP at its own format, in one launch per matmul."""
    lanes = lanes_lib.current_lanes()
    if lanes is not None:
        env, ln, lo = lanes.for_class(op_class)
        h = dispatch_lib.mixed_fused_proj(x, (w_gate, w_up), env, ln, lo,
                                          epilogue="swiglu")
        return dispatch_lib.dispatch_mixed_matmul(h, w_down, env, ln, lo)
    mode = policy.mode(op_class)
    h = mp_swiglu(x, w_gate, w_up, mode)
    return mp_dense(h, w_down, mode)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup."""
    return table[tokens]


def unembed(x: torch.Tensor, w_head: torch.Tensor, policy: PrecisionPolicy
            ) -> torch.Tensor:
    """LM head: (..., D) @ (D, V) at the logits format (each slot's own
    inside a mixed decode step)."""
    lanes = lanes_lib.current_lanes()
    if lanes is not None:
        env, ln, lo = lanes.for_class("lm_head")
        return dispatch_lib.dispatch_mixed_matmul(x, w_head, env, ln, lo)
    return mp_dense(x, w_head, policy.mode("lm_head"))


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of the head dim.
    x: (B, S, H, Dh); positions: (B, S)."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_frequencies(rot, theta, x.device)               # (rot/2,)
    angles = positions[..., None].float() * freqs                # (B, S, rot/2)
    cos = torch.cos(angles)[..., None, :]                        # (B, S, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < dh else out


# --------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / float(d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    return (w * scale).to(device)


def embed_init(gen: torch.Generator, vocab: int, d: int, device=None
               ) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32)
    return (w * 0.02).to(device)
