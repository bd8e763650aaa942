"""The FSDP (ZeRO-3) layout of a training step: parameters, AdamW moments
and batch laid out by ``launch/specs.make_rules`` / ``param_shardings``.

The JAX package has no counterpart module: there GSPMD partitions the step
and inserts this work.  Here it is explicit, on every rank:

* each rank holds its block of every leaf (``dist.sharding.shard``; the
  trailing dim over the batch axes, a dim that does not divide them
  whole) and its rows of the batch (``dist.sharding.batch_rows``);
* the forward gathers a layer's leaves right before the layer runs
  (:func:`gather`: an all-gather, whose backward is the reduce-scatter of
  the cotangent), the embedding, final norm and head where it uses them;
  under remat the recompute gathers the layer again (``models.transformer``
  reads the installed layout through :func:`gatherer`);
* a replicated leaf's gradient is summed over the batch group (one
  all-reduce in its backward);
* each rank's loss is its rows' mean divided by the group's size, so the
  sums above give the gradient of the global mean (:func:`local_loss`);
* the step's metrics are reduced over the group (:func:`reduce_metrics`),
  the clipping norm in ``optim.adamw.global_norm``.

A gathered weight is contiguous row-major, so each matmul takes the route
it takes on one rank.  With no layout installed nothing here runs and no
collective is called.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.dist import collectives
from repro_torch.dist import sharding as sh_lib
from repro_torch.dist.sharding import AxisRules, Sharding


def is_pure_fsdp(rules: Optional[AxisRules]) -> bool:
    """Rules that shard the batch and nothing besides (no sequence axes,
    no tensor parallelism)."""
    return (rules is not None and rules.batch is not None
            and not rules.seq_axes and not rules.tp_enabled)


def is_sharded(sharding: Sharding) -> bool:
    return any(e is not None for e in sharding.spec)


@dataclasses.dataclass(frozen=True)
class Layout:
    """An FSDP layout: the rules and the :class:`Sharding` of every leaf of
    the model's parameters (``param_shardings`` of their global shapes);
    the AdamW moments share it."""

    rules: AxisRules
    params: Any

    @property
    def group(self):
        """The batch group: the ranks whose rows make one global batch."""
        return collectives.axis_group(self.rules.mesh,
                                      sh_lib.axes_of(self.rules.batch))

    @property
    def size(self) -> int:
        return self.rules.axis_size(self.rules.batch)

    @property
    def metrics_group(self):
        """The ranks a step's metrics sum over: the batch group."""
        return self.group


def make_layout(params, rules: AxisRules) -> Layout:
    """The layout of a model whose global parameters (any device, ``meta``
    too) are ``params``, under pure FSDP ``rules``."""
    if not is_pure_fsdp(rules):
        raise ValueError(f"not a pure FSDP layout: {rules}")
    return Layout(rules, sh_lib.param_shardings(params, rules))


def shard_tree(tree, shardings):
    """This rank's block of every leaf of a global tree."""
    return tree_lib.map_(sh_lib.shard, tree, shardings)


def local_structs(tree, shardings):
    """``meta`` tensors of this rank's blocks' shapes."""
    return tree_lib.map_(
        lambda x, s: torch.empty(sh_lib.local_shape(s, x.shape),
                                 dtype=x.dtype, device="meta"),
        tree, shardings)


# ---------------------------------------------------------------------------
# the gathers
# ---------------------------------------------------------------------------
def _sharded_dim(sharding: Sharding) -> int:
    dims = [d for d, e in enumerate(sharding.spec) if e is not None]
    if len(dims) != 1:
        raise ValueError(f"an FSDP leaf shards one dim: {sharding.spec}")
    return dims[0]


def _group(sharding: Sharding, dim: int):
    """The group a sharded dim gathers over; its group ranks must be the
    blocks' order (``sharding.shard_index``), which holds for axes in the
    mesh's order."""
    mesh, axes = sharding.mesh, sh_lib.axes_of(sharding.spec[dim])
    names = list(mesh.mesh_dim_names)
    idx = [names.index(a) for a in axes]
    if idx != sorted(idx):
        raise ValueError(f"axes {axes} are not in the mesh's order "
                         f"{tuple(names)}: the group's ranks would not be "
                         f"the blocks' order")
    return collectives.axis_group(mesh, axes)


def _gather_dim(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole tensor from the blocks along the sharded dim, contiguous
    row-major; differentiable (backward: reduce-scatter)."""
    d = _sharded_dim(sharding)
    if sh_lib.shard_index(sharding.mesh, sharding.spec[d])[1] == 1:
        return x
    moved = x.movedim(d, 0).contiguous()
    full = collectives.all_gather_diff(moved, _group(sharding, d))
    return full.movedim(0, d).contiguous()


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward: the cotangent summed over the batch
    group (a replicated leaf's gradient from every rank's rows)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.contiguous().clone(), ctx.group), \
            None


def gather(x_local: torch.Tensor, sharding: Sharding,
           rules: AxisRules) -> torch.Tensor:
    """The whole leaf from this rank's block: a sharded leaf all-gathered
    along its sharded dim (backward: reduce-scatter of the cotangent), a
    replicated one as it is (backward: all-reduce over the batch group).

    Under rules that also have sequence axes (the Ulysses layout,
    ``dist/seq_layout.py``) the ranks of one row group hold other blocks
    of the sequence, so a gradient also sums over the sequence group: a
    sharded leaf's block after the reduce-scatter (one all-reduce over
    the sequence axes), a replicated leaf's over every rank."""
    seq = sh_lib.axes_of(rules.seq) if rules.seq_axes else ()
    if is_sharded(sharding):
        if seq and x_local.requires_grad:
            x_local = _SumGrad.apply(
                x_local, collectives.axis_group(rules.mesh, seq))
        return _gather_dim(x_local, sharding)
    if not x_local.requires_grad:
        return x_local
    return _SumGrad.apply(x_local, collectives.axis_group(
        rules.mesh, sh_lib.axes_of(rules.batch) + seq))


@torch.no_grad()
def full_leaf(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The global leaf from every rank's block (no autograd): all-gathered
    if it is sharded, else as it is."""
    return _gather_dim(x, sharding) if is_sharded(sharding) else x


def full_tree(tree, shardings):
    """The global tree from every rank's blocks (:func:`full_leaf` of each
    leaf)."""
    return tree_lib.map_(full_leaf, tree, shardings)


# ---------------------------------------------------------------------------
# the installed layout and the forward's hook
# ---------------------------------------------------------------------------
_LAYOUT: contextvars.ContextVar[Optional[Layout]] = contextvars.ContextVar(
    "repro_torch_fsdp_layout", default=None)


@contextlib.contextmanager
def use_layout(layout: Optional[Layout]):
    tok = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(tok)


def current_layout() -> Optional[Layout]:
    return _LAYOUT.get()


def _identity(tree, *keys):
    return tree


def gatherer() -> Callable:
    """The forward's gather hook, taken where the forward starts (remat's
    recompute runs on autograd's thread, which sees no installed layout):
    ``hook(subtree, *keys)`` is ``subtree`` with every leaf gathered,
    ``keys`` its path in the parameters (``"layers", 3``).  The identity
    with no layout installed."""
    layout = current_layout()
    if layout is None:
        return _identity

    def hook(tree, *keys):
        shardings = layout.params
        for k in keys:
            shardings = shardings[k]
        return tree_lib.map_(lambda x, s: gather(x, s, layout.rules),
                             tree, shardings)

    return hook


# ---------------------------------------------------------------------------
# the step's loss and metrics
# ---------------------------------------------------------------------------
def local_loss(loss_fn: Callable, layout: Layout) -> Callable:
    """``loss_fn`` on this rank's rows under ``layout``: its loss and
    extras divided by the group's size (its share of the global mean, so
    the gradients' sums over the group are the global mean's).  A Ulysses
    layout (``dist/seq_layout.py``) carries its parameters' ``params``,
    ``rules`` and batch group ``size`` and takes the same share; its
    ``loss_fn`` gives its rows' mean summed over the sequence group."""
    n = float(layout.size)

    def fn(params, batch):
        with use_layout(layout):
            loss, extras = loss_fn(params, batch)
        return loss / n, {k: v / n for k, v in extras.items()}

    return fn


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   layout: Layout) -> Dict[str, torch.Tensor]:
    """The step's metrics over ``layout.metrics_group`` (the batch group;
    under the Ulysses layout every rank), in one all-reduce: ``loss`` and
    ``nll`` (each rank's share) summed into the global means, and
    ``params_finite`` 1 only where every rank's blocks are finite.  (The
    MoE terms are not reduced: an MoE forward refuses a layout.)"""
    keys = ("loss", "nll")
    packed = torch.stack([metrics[k].float().reshape(()) for k in keys]
                         + [1.0 - metrics["params_finite"].float()])
    collectives.all_reduce(packed, layout.metrics_group)
    out = dict(metrics)
    out.update({k: packed[i] for i, k in enumerate(keys)})
    out["params_finite"] = (packed[-1] == 0).float()
    return out
