"""Counted collectives and the hierarchical reduction (port of
``repro.dist.collectives``).

The production gradient reduction is hierarchical (DESIGN.md §5): a
reduce-scatter over the inner (fast) axis, the cross-pod hop on the shards
only, then an all-gather over the inner axis.  The compressed variant
quantizes the cross-pod leg to int8 with error feedback (the scheme of
optim/compress.py).  Where the JAX package runs these inside ``shard_map``
with named axes bound, the port runs them on every rank over a
``DeviceMesh``'s named dims.

Every collective here counts its calls and payload bytes on the function
(``fn.calls``, ``fn.bytes``: the bytes each rank hands in), as the kernel
wrappers count launches; the counts are the port's form of the JAX tests'
HLO checks.  :func:`counts` and :func:`reset_counts` read and zero them.

gloo and CUDA tensors: gloo runs all-reduce (sum, max), broadcast,
all-gather, reduce-scatter and ``all_to_all_single`` on CUDA tensors
itself, and refuses point-to-point (measured on an H100 with torch 2.11
and PyTorch's gloo: ``send`` / ``recv`` of a CUDA tensor fail).  The ops in
:data:`GLOO_HOST_STAGED` are staged through pinned host memory there:
copied to the host, run, copied back; each staged call adds one to
``fn.staged``.  Nothing else is staged, so an op gloo refuses that is not
listed fails loudly.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisNames = Union[str, Sequence[str]]

# ops gloo does not run on CUDA tensors: staged through the host there
GLOO_HOST_STAGED = frozenset({"send", "recv"})

# the flat-tensor forms (newer torch names them *_single)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _run(fn, name: str, tensors, call, group) -> None:
    """Run ``call(tensors)``, or, where gloo does not take CUDA tensors for
    this op, ``call`` on pinned host copies of them, copied back after."""
    if not (name in GLOO_HOST_STAGED and any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo"):
        call(tensors)
        return
    fn.staged += 1
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in tensors]
    call(host)
    for t, h in zip(tensors, host):
        t.copy_(h)


def _counted(fn, nbytes: int) -> None:
    fn.calls += 1
    fn.bytes += nbytes


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group`` (``op``: sum or max)."""
    _counted(all_reduce, _nbytes(x))
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run(all_reduce, "all_reduce", [x],
         lambda t: dist.all_reduce(t[0], op=red, group=group), group)
    return x


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` (flat, length divisible by the group) over the group,
    this rank's 1/n tile of it."""
    n = dist.get_world_size(group)
    if x.numel() % n:
        raise ValueError(f"{x.numel()} elements do not tile {n} ranks")
    _counted(reduce_scatter, _nbytes(x))
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    _run(reduce_scatter, "reduce_scatter", [x.reshape(-1), out],
         lambda t: _REDUCE_SCATTER(t[1], t[0], group=group), group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenation of every rank's ``x`` (flat) in rank order."""
    n = dist.get_world_size(group)
    _counted(all_gather, _nbytes(x))
    out = torch.empty(x.numel() * n, dtype=x.dtype, device=x.device)
    _run(all_gather, "all_gather", [x.reshape(-1), out],
         lambda t: _ALL_GATHER(t[1], t[0], group=group), group)
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim-0 blocks (one per rank of ``group``, in group-rank
    order) exchanged: block j goes to rank j, and block j of the result
    came from rank j (JAX's ``all_to_all(split_axis=0, concat_axis=0)``).
    Its own inverse."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    _counted(all_to_all, _nbytes(x))
    x = x.contiguous()
    out = torch.empty_like(x)
    _run(all_to_all, "all_to_all", [x, out],
         lambda t: dist.all_to_all_single(t[1], t[0], group=group), group)
    return out


def send(x: torch.Tensor, dst: int, group) -> None:
    """Point-to-point send to group rank ``dst`` (blocking)."""
    _counted(send, _nbytes(x))
    _run(send, "send", [x],
         lambda t: dist.send(t[0], dist.get_global_rank(group, dst),
                             group=group), group)


def recv(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Point-to-point receive into ``x`` from group rank ``src``."""
    _counted(recv, _nbytes(x))
    _run(recv, "recv", [x],
         lambda t: dist.recv(t[0], dist.get_global_rank(group, src),
                             group=group), group)
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of global rank ``src``'s ``x`` over ``group``."""
    _counted(broadcast, _nbytes(x))
    _run(broadcast, "broadcast", [x],
         lambda t: dist.broadcast(t[0], src, group=group), group)
    return x


COLLECTIVES = {"all_reduce": all_reduce, "reduce_scatter": reduce_scatter,
               "all_gather": all_gather, "all_to_all": all_to_all,
               "broadcast": broadcast, "send": send, "recv": recv}


def reset_counts() -> None:
    for fn in (*COLLECTIVES.values(), flat_psum, hierarchical_psum,
               hierarchical_psum_compressed):
        fn.calls = fn.bytes = fn.staged = 0


def counts() -> Dict[str, Dict[str, int]]:
    """{name: {calls, bytes, staged}} of every counted collective."""
    fns = {**COLLECTIVES, "flat_psum": flat_psum,
           "hierarchical_psum": hierarchical_psum,
           "hierarchical_psum_compressed": hierarchical_psum_compressed}
    return {k: {"calls": f.calls, "bytes": f.bytes, "staged": f.staged}
            for k, f in fns.items()}


# ---------------------------------------------------------------------------
# groups over one or several mesh axes
# ---------------------------------------------------------------------------
_GROUPS: dict = {}


def axis_group(mesh, axes: AxisNames):
    """The process group of this rank over mesh axis ``axes`` (a name, or
    several names flattened into one group).  Every rank must ask for the
    same multi-axis groups in the same order: making a group is
    collective."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, int(torch.tensor([mesh.shape[d] for d in dims]).prod()))
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if dist.get_rank() in row:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# the reductions (JAX: inside shard_map with the named axes bound)
# ---------------------------------------------------------------------------
def flat_psum(x: torch.Tensor, mesh, axes: AxisNames) -> torch.Tensor:
    """The baseline: one all-reduce over all named axes (a new tensor)."""
    out = x.clone()
    _counted(flat_psum, _nbytes(x))
    return all_reduce(out, axis_group(mesh, axes))


def _scatter(x: torch.Tensor, mesh, inner_axis: str
             ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    return reduce_scatter(x.reshape(-1), axis_group(mesh, inner_axis)), \
        tuple(x.shape)


def _gather(shard: torch.Tensor, mesh, inner_axis: str, shape) -> torch.Tensor:
    return all_gather(shard, axis_group(mesh, inner_axis)).reshape(shape)


def hierarchical_psum(x: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      inner_axis: str = "data") -> torch.Tensor:
    """reduce-scatter(inner) -> all-reduce(pod, on 1/inner shards) ->
    all-gather(inner).  Each element sums the same terms as
    :func:`flat_psum`, in another association of f32 adds."""
    _counted(hierarchical_psum, _nbytes(x))
    shard, shape = _scatter(x, mesh, inner_axis)
    all_reduce(shard, axis_group(mesh, pod_axis))
    return _gather(shard, mesh, inner_axis, shape)


def hierarchical_psum_compressed(x: torch.Tensor, err: torch.Tensor, mesh, *,
                                 pod_axis: str = "pod",
                                 inner_axis: str = "data"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`hierarchical_psum` with an int8 cross-pod leg and error
    feedback.  ``err`` is this rank's residual, shaped like its shard
    (flat size / inner size); the new residual comes back beside the sum.
    The rounding is ``torch.round``'s, half to even like ``jnp.round``."""
    _counted(hierarchical_psum_compressed, _nbytes(x))
    shard, shape = _scatter(x, mesh, inner_axis)
    val = shard.float() + err
    scale = torch.clamp(val.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(val / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale                # what the wire carries
    new_err = val - deq
    all_reduce(deq, axis_group(mesh, pod_axis))
    return _gather(deq, mesh, inner_axis, shape), new_err


# ---------------------------------------------------------------------------
# differentiable forms (the expert-parallel MoE under autograd).  Each
# backward is the transpose JAX's autodiff takes of the same collective
# inside ``shard_map``: psum -> psum, a tiled all_gather -> psum_scatter,
# all_to_all -> all_to_all.  Every rank builds the same graph, so autograd
# runs these backwards in one order on every rank.
# ---------------------------------------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.shape = group, tuple(x.shape)
        n = dist.get_world_size(group)
        out = all_gather(x.contiguous(), group)
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group).reshape(
            ctx.shape), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def psum_diff(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (a new tensor); backward: the sum of the
    cotangents over the group."""
    return _Psum.apply(x, group)


def all_gather_diff(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in group-rank order (a
    tiled all-gather); backward: the reduce-scatter of the cotangent."""
    return _AllGather.apply(x, group)


def all_to_all_diff(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` under autograd; backward: the same exchange of
    the cotangent."""
    return _AllToAll.apply(x, group)


reset_counts()
