"""Logical sharding rules (port of ``repro.dist.sharding``): one
:class:`AxisRules` describes how a cell lays out on a ``DeviceMesh``, and
code asks for layouts by *logical name* instead of hard-coded placements.

Layouts are JAX's PartitionSpec entries — per tensor dim ``None``, a mesh
axis name, or a tuple of names — held in a :class:`Sharding` beside its
mesh; :meth:`Sharding.placements` turns them into ``torch.distributed.tensor``
placements (``Shard(d)`` on each mesh dim a tensor dim is split over,
``Replicate()`` on the others), which ``distribute_tensor`` and
``DTensor.redistribute`` take.

Vocabulary (as the JAX package's launch/specs.make_rules decides it):
  batch_axes  mesh axes the global batch shards over
  model_axis  the tensor- / sequence-parallel axis
  seq_axes    axes the activation sequence dim shards over
  tp_enabled  weights sharded over model_axis (Megatron TP)
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_lib


def _entry(axes: Tuple[str, ...]):
    """Tuple of mesh axes -> one spec entry (None / name / tuple)."""
    axes = tuple(a for a in axes if a)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, axis: str) -> int:
    return mesh.size(_names(mesh).index(axis))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec (JAX's PartitionSpec entries, one per tensor dim) on a mesh."""

    mesh: object
    spec: Tuple

    def placements(self):
        """The DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(_names(self.mesh))
        for d, e in enumerate(self.spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                out[_names(self.mesh).index(a)] = Shard(d)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Sharding layout of one cell (frozen)."""

    mesh: object
    batch_axes: Tuple[Optional[str], ...] = (None,)
    model_axis: str = "model"
    seq_axes: Tuple[str, ...] = ()
    tp_enabled: bool = False

    @property
    def batch(self):
        return _entry(tuple(a for a in self.batch_axes if a))

    @property
    def seq(self):
        return _entry(self.seq_axes)

    @property
    def model_free(self) -> bool:
        """Is the model axis free for weight / head sharding (not absorbed
        into the batch)?"""
        return (self.model_axis in _names(self.mesh)
                and self.model_axis not in self.batch_axes)

    def axis_size(self, entry) -> int:
        if entry is None:
            return 1
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= _size(self.mesh, a)
        return n


_RULES: contextvars.ContextVar[Optional[AxisRules]] = contextvars.ContextVar(
    "repro_torch_axis_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    tok = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(tok)


def current_rules() -> Optional[AxisRules]:
    return _RULES.get()


def moe_layer_kwargs(rules: Optional[AxisRules] = None) -> dict:
    """The layout arguments an MoE layer passes to the expert-parallel
    forward (``models.moe.moe_forward_ep``) under ``rules`` (default: the
    installed ones; none installed, none passed): the batch axes besides
    ``data`` and the model axis, whether the tokens already split over the
    model axis, and the activations' (batch, seq) spec entries."""
    rules = rules if rules is not None else current_rules()
    if rules is None:
        return {}
    return {
        "extra_data_axes": tuple(a for a in rules.batch_axes
                                 if a and a not in ("data", rules.model_axis)),
        "tokens_on_model": (rules.model_axis in (rules.seq_axes or ())
                            or rules.model_axis in rules.batch_axes),
        "x_pspec": (rules.batch, rules.seq_axes if rules.seq_axes else None),
    }


def _logical_entries(name: str, ndim: int, rules: AxisRules):
    """A logical activation name -> per-dim spec entries."""
    b, s = rules.batch, rules.seq
    m = rules.model_axis if rules.model_free else None
    vocab = (m if rules.tp_enabled and m is not None
             and m not in (rules.seq_axes or ()) else None)
    table = {
        "activations": (b, None, None),           # (B, S, D)
        "activations_seq": (b, s, None),
        "logits": (b, s, vocab),                  # (B, S, V)
        "attn_heads": (b, None, m, None),         # (B, S, H, Dh)
        "attn_out_seq": (b, s, None, None),
    }
    if name not in table:
        raise KeyError(f"unknown logical sharding name: {name!r}")
    entries = list(table[name])
    while len(entries) < ndim:
        entries.insert(0, None)
    return entries[-ndim:]


def constrain(x, name: str):
    """Lay ``x`` out by logical name.  The identity with no rules installed
    or on a plain tensor: eager PyTorch has no partitioner to hand a hint
    to (JAX's ``with_sharding_constraint``), so only a ``DTensor`` moves,
    redistributed to the named placements; a dim that does not divide its
    axes stays whole."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    entries = _logical_entries(name, x.ndim, rules)
    for i, e in enumerate(entries):
        if e is not None and x.shape[i] % rules.axis_size(e) != 0:
            entries[i] = None
    return x.redistribute(rules.mesh,
                          Sharding(rules.mesh, tuple(entries)).placements())


def _map_with_path(fn, tree, prefix: str = ""):
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(prefix, tree)


def param_shardings(params, rules: AxisRules):
    """A :class:`Sharding` tree for model / optimizer parameters.

    TP layouts shard each weight over the model axis, Megatron-style:
    column-parallel (last dim) for up / gate / qkv, row-parallel (the
    contraction dim) for ``w_down`` / ``wo`` / ``w_o``.  Otherwise the
    trailing dim shards over the batch axes (FSDP).  A dim that does not
    divide its axes stays replicated."""
    mesh = rules.mesh

    def leaf(path, x):
        entries = [None] * x.ndim
        if x.ndim == 0:
            return Sharding(mesh, ())
        if rules.tp_enabled and rules.model_free:
            msize = _size(mesh, rules.model_axis)
            row_parallel = any(t in path for t in ("w_down", "wo", "w_o"))
            dim = x.ndim - 2 if (row_parallel and x.ndim >= 2) \
                else x.ndim - 1
            if x.shape[dim] % msize == 0:
                entries[dim] = rules.model_axis
        else:
            b = rules.batch
            if b is not None and x.shape[-1] % rules.axis_size(b) == 0:
                entries[-1] = b
        return Sharding(mesh, tuple(entries))

    return _map_with_path(leaf, params)


# ---------------------------------------------------------------------------
# the per-rank view of a layout
# ---------------------------------------------------------------------------
def axes_of(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def shard_index(mesh, entry) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) along a dim laid out by a
    spec ``entry``: the row-major index of the rank's mesh coordinates over
    the entry's axes, in the entry's order — the block JAX's
    ``NamedSharding.devices_indices_map`` gives the device at the same
    coordinates.  (0, 1) for ``None``."""
    coord = dict(zip(_names(mesh), mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes_of(entry):
        idx, n = idx * _size(mesh, a) + coord[a], n * _size(mesh, a)
    return idx, n


def _blocks(sharding: Sharding, shape):
    """Per dim: (block, number of blocks); a dim that does not divide its
    axes stays whole (``param_shardings``' rule)."""
    out = []
    for d, e in enumerate(sharding.spec):
        idx, n = shard_index(sharding.mesh, e)
        out.append((idx, n) if shape[d] % n == 0 else (0, 1))
    return out


def local_shape(sharding: Sharding, shape) -> Tuple[int, ...]:
    """The shape of this rank's block of a global ``shape``."""
    return tuple(s // n for s, (_, n) in zip(shape, _blocks(sharding, shape)))


def block(sharding: Sharding, shape) -> Tuple[slice, ...]:
    """This rank's block of a global ``shape``: one slice a dim."""
    return tuple(slice(idx * (s // n), (idx + 1) * (s // n))
                 for s, (idx, n) in zip(shape, _blocks(sharding, shape)))


def shard(x, sharding: Sharding):
    """This rank's block of the global tensor ``x`` (a contiguous copy, so
    it holds no reference to the whole)."""
    return x[block(sharding, x.shape)].clone(
        memory_format=torch.contiguous_format)


def batch_rows(rules: AxisRules, B: int) -> slice:
    """This rank's rows of a global batch of ``B`` rows laid out over the
    rules' batch axes (JAX's ``P(batch, ...)``)."""
    idx, n = shard_index(rules.mesh, rules.batch)
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{n} ranks of the batch axes {rules.batch}")
    return slice(idx * B // n, (idx + 1) * B // n)


def seq_block(rules: AxisRules, S: int) -> slice:
    """This rank's positions of a global sequence of ``S`` laid out over
    the rules' sequence axes (JAX's ``P(batch, seq, ...)``), in
    :func:`shard_index`'s block order."""
    idx, n = shard_index(rules.mesh, rules.seq)
    if S % n:
        raise ValueError(f"a sequence of {S} positions does not split over "
                         f"the {n} ranks of the sequence axes {rules.seq}")
    return slice(idx * S // n, (idx + 1) * S // n)


def expert_shardings(params, mesh, *, model_axis: str = "model",
                     data_axis: str = "data"):
    """A :class:`Sharding` tree for a model's parameters as the
    expert-parallel MoE holds them (``models.moe.moe_forward_ep``'s
    ``P(model, data, None)``): each MoE layer's stacked ``w_gate`` /
    ``w_up`` / ``w_down`` with its experts over ``model_axis`` and its
    next dim over ``data_axis``; every other leaf replicated.  For
    ``checkpoint.restore(shardings=...)``."""
    def leaf(path, x):
        parts = path.split("/")
        if ("moe" in parts and "shared" not in parts
                and parts[-1] in ("w_gate", "w_up", "w_down")):
            return Sharding(mesh, (model_axis, data_axis, None))
        return Sharding(mesh, (None,) * x.ndim)

    return _map_with_path(leaf, params)


def cache_specs(cache, rules: AxisRules, *, seq_axes=()):
    """Spec tree (tuples of entries) for stacked decode caches: leaves
    (L, B, S_max, ...) shard dim 1 over the batch group and dim 2 (the
    cache sequence) over ``seq_axes``; leaves without a sequence dim shard
    the batch only."""
    if isinstance(seq_axes, str):
        seq_axes = (seq_axes,)
    seq_axes = tuple(a for a in (seq_axes or ())
                     if a and a in _names(rules.mesh))
    bentry = rules.batch

    def leaf(x):
        if x.ndim < 2:
            return ()
        entries = [None] * x.ndim
        if bentry is not None and x.shape[1] % rules.axis_size(bentry) == 0:
            entries[1] = bentry
        if x.ndim >= 4 and seq_axes:
            sentry = _entry(seq_axes)
            if x.shape[2] % rules.axis_size(sentry) == 0:
                entries[2] = sentry
        return tuple(entries)

    return tree_lib.map_(leaf, cache)


# the per-layer cache tensors whose dim 1 is the cache sequence
_SEQ_FIELDS = frozenset({"k", "v", "c_kv", "k_rope"})


def map_cache(fn, cache, *rest):
    """``fn(field, tensor, *others)`` over every tensor of the port's
    per-layer caches: a ``ModelCache`` (or a list, or one layer's
    ``KVCache`` / ``MLACache`` / ``SSMCache``), the result of the same
    structure; ``others`` are the same fields of ``rest`` (trees of that
    structure, e.g. shardings).  Other fields (``length``) are kept."""
    if cache is None:
        return None
    if isinstance(cache, list):
        return [map_cache(fn, c, *(r[i] for r in rest))
                for i, c in enumerate(cache)]
    kw = {}
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        others = [getattr(r, f.name) for r in rest]
        if isinstance(v, torch.Tensor):
            kw[f.name] = fn(f.name, v, *others)
        elif isinstance(v, list) or dataclasses.is_dataclass(v):
            kw[f.name] = map_cache(fn, v, *others)
    return dataclasses.replace(cache, **kw)


def layer_cache_shardings(cache, rules: AxisRules, seq_axes=()):
    """A :class:`Sharding` for every tensor of the port's per-layer
    ``ModelCache`` (the result has its structure, a ``Sharding`` in each
    tensor's place): :func:`cache_specs`' rule on the stacked leaves
    without the leading L — dim 0 (B) over the batch axes, dim 1 (S) over
    ``seq_axes`` for the sequence tensors (``KVCache.k`` / ``.v``,
    ``MLACache.c_kv`` / ``.k_rope``); an ``SSMCache``'s ``conv`` and
    ``state`` by rows only.  A dim that does not divide its axes stays
    whole."""
    mesh = rules.mesh
    seq = _entry(tuple(a for a in axes_of(seq_axes) if a in _names(mesh)))
    bentry = rules.batch

    def leaf(name, x):
        entries = [None] * x.ndim
        if bentry is not None and x.shape[0] % rules.axis_size(bentry) == 0:
            entries[0] = bentry
        if (name in _SEQ_FIELDS and seq is not None
                and x.shape[1] % rules.axis_size(seq) == 0):
            entries[1] = seq
        return Sharding(mesh, tuple(entries))

    return map_cache(leaf, cache)
