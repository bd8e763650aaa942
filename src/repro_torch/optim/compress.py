"""Gradient compression for the cross-pod reduction (port of
``repro.optim.compress``).

int8 block quantization with error feedback: each gradient leaf is
quantized per 256-element block to int8 plus an f32 scale (8 + 32 / 256
bits a value), and the quantization residual is carried in an
error-feedback buffer so the bias cancels over steps.  Plain tensor ops, no
collective: this is the lossy channel the cross-pod leg of
``dist.collectives.hierarchical_psum_compressed`` sees.  ``torch.round``
rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib

BLOCK = 256


class CompressState(NamedTuple):
    error: Any  # error-feedback residual, a tree like the grads


def init(grads_like) -> CompressState:
    return CompressState(error=tree_lib.map_(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _quant_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, shape
                  ) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return deq[:n].reshape(shape)


def compress_decompress(grads, state: CompressState
                        ) -> Tuple[Any, CompressState, dict]:
    """Round-trip the compressor with error feedback.  Returns
    (grads', new_state, stats)."""
    def leaf(g, e):
        x = g.float() + e
        q, scale = _quant_leaf(x)
        deq = _dequant_leaf(q, scale, g.shape)
        return deq.to(g.dtype), x - deq

    # the map follows ``grads``' structure, so each pair stays one leaf
    pairs = tree_lib.map_(leaf, grads, state.error)
    new_g = tree_lib.map_(lambda _, p: p[0], grads, pairs)
    new_e = tree_lib.map_(lambda _, p: p[1], grads, pairs)
    bits = 8 + 32.0 / BLOCK
    return new_g, CompressState(new_e), {"compress_bits_per_value": bits}
