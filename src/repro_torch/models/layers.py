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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = _row_sum(x) / x.shape[-1]
    var = _row_sum((x - mu) ** 2) / x.shape[-1]
    return ((x - mu) * torch.rsqrt(var + eps) * weight + bias).to(dt)


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
    bwd = policy.bwd_kwargs(op_class)
    h = mp_swiglu(x, w_gate, w_up, mode, **bwd)
    return mp_dense(h, w_down, mode, **bwd)


def sorted_row_sum(ids: torch.Tensor, rows: torch.Tensor, n_rows: int
                   ) -> torch.Tensor:
    """``out[i] = sum of rows[t] where ids[t] == i`` -> (n_rows, D) f32,
    each sum taken from +0.0 in the order of t, with no atomics and no
    read back to the host: rows are sorted by id (stably), each id's run
    is found by a binary search, and one segmented reduction adds every
    run's rows in order.  PyTorch's gather backward accumulates duplicates
    on the card in an order it does not promise, and a training step must
    give the same bits twice."""
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    ids_s, rows_s = ids[order], rows[order].float()
    bounds = torch.searchsorted(
        ids_s, torch.arange(n_rows + 1, device=ids.device))
    return torch.segment_reduce(rows_s, "sum", lengths=bounds.diff(),
                                unsafe=True)


class _EmbedFn(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each row's gradients in token
    order (:func:`sorted_row_sum`)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        V, D = ctx.table_shape
        d_table = sorted_row_sum(tokens.reshape(-1), g.reshape(-1, D), V)
        return d_table.to(ctx.table_dtype), None


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup (a gather; under autograd its backward sums
    in a fixed order)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedFn.apply(table, tokens)
    return table[tokens]


def unembed(x: torch.Tensor, w_head: torch.Tensor, policy: PrecisionPolicy
            ) -> torch.Tensor:
    """LM head: (..., D) @ (D, V) at the logits format (each slot's own
    inside a mixed decode step)."""
    lanes = lanes_lib.current_lanes()
    if lanes is not None:
        env, ln, lo = lanes.for_class("lm_head")
        return dispatch_lib.dispatch_mixed_matmul(x, w_head, env, ln, lo)
    return mp_dense(x, w_head, policy.mode("lm_head"),
                    **policy.bwd_kwargs("lm_head"))


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


def apply_rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                           theta: float = 10000.0) -> torch.Tensor:
    """DeepSeek-MLA style rope over the dedicated rope dims (full dim)."""
    return apply_rope(x, positions, theta, fraction=1.0)


# --------------------------------------------------------------- init utils
# Every draw comes from ``gen`` on the generator's own device (a CUDA
# generator fills the card's memory in place: the full-width families hold
# billions of parameters), then moves to ``device``.  On ``meta`` (the dry
# run's shapes) there is no generator: :class:`MetaGenerator` stands in and
# the draws are shapes only.
class MetaGenerator:
    """The stand-in generator of a ``meta`` init: no state, no numbers."""

    device = torch.device("meta")


def rand(gen, shape) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` (shapes only on ``meta``)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device)


def normal(gen: torch.Generator, shape, scale: float = 1.0, device=None
           ) -> torch.Tensor:
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / float(d_in) ** 0.5
    return normal(gen, (d_in, d_out), scale, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, device=None
               ) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, device)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (the CPU by default); on ``meta``
    a :class:`MetaGenerator` (a ``torch.Generator`` cannot live there)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)
