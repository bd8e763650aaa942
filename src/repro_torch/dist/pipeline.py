"""GPipe pipeline parallelism over a mesh axis (port of
``repro.dist.pipeline``).

The L layers split into ``n_stages = mesh size along stage_axis``
contiguous stages; microbatches flow through the stages with point-to-point
``send`` / ``recv`` as the wire (JAX: ``ppermute``), never an all-gather of
activations.  Stage s runs microbatch i at time s + i: plain GPipe
fill-drain, idle share :func:`bubble_fraction`.  The last stage's outputs
are broadcast to every rank of the axis (JAX: a masked ``psum``), so every
rank returns the whole result.

Gradients: the wire is two ``torch.autograd.Function``\\ s, :class:`_Recv`
and :class:`_Send`, whose backwards send each microbatch's activation
gradient back up the stages.  A rank's parameter gradients are those of its
own stage's layers (zeros elsewhere); summing them over the stage axis
gives the sequential model's.  Every rank issues its point-to-point calls
in one order, forward and backward: microbatches in order in the forward,
in reverse in the backward (autograd runs the later-built chain first).

Each stage body runs inside ``dispatch.owned_axes``: a sharded-backend call
there computes locally, because the ranks of the axis are running different
layers and would not all meet at its collective.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import collectives


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule (fill + drain bubbles)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


class _Recv(torch.autograd.Function):
    """Receive one activation from the previous stage; the backward sends
    its gradient back there.  ``dep`` only carries ``requires_grad``."""

    @staticmethod
    def forward(ctx, dep, like, src, group):
        ctx.src, ctx.group = src, group
        return collectives.recv(torch.empty_like(like), src, group)

    @staticmethod
    def backward(ctx, g):
        collectives.send(g.contiguous(), ctx.src, ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send one activation to the next stage; returns a 0-d token that the
    caller ties into its result, and whose backward receives the
    activation's gradient from that stage."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        collectives.send(x.contiguous(), dst, group)
        return torch.zeros((), device=x.device)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        return collectives.recv(g, ctx.dst, ctx.group), None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every rank of the axis.  Backward: the
    last stage takes the gradient of its outputs; the other stages' tokens
    take zeros (their gradients arrive through :class:`_Send`)."""

    @staticmethod
    def forward(ctx, outs, src, group, *tokens):
        ctx.n_tokens = len(tokens)
        out = outs.detach().clone()
        collectives.broadcast(out, src, group)
        return out

    @staticmethod
    def backward(ctx, g):
        zeros = [torch.zeros((), device=g.device)] * ctx.n_tokens
        return (g, None, None, *zeros)


def _layers(params) -> List:
    """Per-layer trees: a list of them as it is, a stacked tree (every leaf
    with leading dim L) cut along that dim."""
    if isinstance(params, (list, tuple)):
        return list(params)
    L = tree_lib.leaves(params)[0].shape[0]
    return [tree_lib.map_(lambda w, i=i: w[i], params) for i in range(L)]


def pipeline_forward(layer_fn: Callable, params, x: torch.Tensor, mesh, *,
                     n_micro: int, stage_axis: str = "model"
                     ) -> torch.Tensor:
    """Run ``layer_fn(lp, h) -> h`` over L layers as a pipeline over the
    ranks of ``stage_axis``.

    ``params``: a list of L per-layer trees, or one tree whose leaves are
    stacked on a leading L (L % n_stages == 0); ``x``: (B, ...) with
    B % n_micro == 0, the same on every rank.  ``layer_fn`` keeps ``h``'s
    shape and dtype (the wire's buffers are ``x``'s microbatches').  The
    result equals the sequential loop over layers: each microbatch runs
    the same layers in the same order, and a row of a layer's output does
    not depend on the other rows where the layer's ops do not."""
    from repro_torch.core import dispatch

    layers = _layers(params)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    s = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of n_micro {n_micro}")
    per = L // n_stages
    mine = layers[s * per:(s + 1) * per]
    xm = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    wants_grad = torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree_lib.leaves(mine)))
    dep = torch.zeros((), device=x.device, requires_grad=wants_grad)
    last = n_stages - 1
    outs, tokens = [], []
    with dispatch.owned_axes(stage_axis):
        for i in range(n_micro):
            h = xm[i] if s == 0 else _Recv.apply(dep, xm[i], s - 1, group)
            for lp in mine:
                h = layer_fn(lp, h)
            if s < last:
                tokens.append(_Send.apply(h, s + 1, group))
            else:
                outs.append(h)
    local = torch.stack(outs) if s == last else torch.zeros_like(xm)
    src = torch.distributed.get_global_rank(group, last)
    out = _Broadcast.apply(local, src, group, *tokens)
    return out.reshape((B,) + tuple(out.shape[2:]))
