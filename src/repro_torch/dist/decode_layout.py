"""The decode layout of a serve step: batch rows over the batch axes, the
cache's sequence over the sequence axes, parameters by
``dist.sharding.param_shardings`` (``launch/specs.make_rules``,
``_cache_seq_axes``).

The JAX package has no counterpart module: there GSPMD partitions the
serve step over the cache's shardings (``cache_specs``) and keeps
``masked_decode_attention`` plain batched products so that it can shard
the cache sequence (sequence-parallel decode).  Here it is explicit, on
every rank:

* each rank holds its rows of every cache tensor and, of the sequence
  tensors (K / V, MLA's latent and rope key), its block of the sequence
  (:func:`shard_cache`; ``dist.sharding.layer_cache_shardings``), and the
  step takes its rows of the tokens;
* under pure FSDP rules (a batch of more than one row: no sequence axes,
  no TP) the parameters are this rank's blocks, gathered by the forward
  right before each use (``dist.fsdp.gatherer``; the step runs under
  ``torch.no_grad``, so no backward collective exists); at batch 1 there
  are no batch axes and the parameters stay whole;
* the new token's K / V lands on the rank whose block holds its position
  (``models.attention``, ``models.mla``); ``length`` stays the global
  prefix on every rank;
* attention runs over the rank's block and combines over the sequence
  group in three all-reduces (``dist.attention.sp_decode_block``; MLA's in
  latent space).

With no layout installed nothing here runs and no collective is called.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.dist import fsdp as fsdp_lib
from repro_torch.dist import sharding as sh_lib
from repro_torch.dist.sharding import AxisRules


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """A decode layout: the rules, the parameters' FSDP layout (None where
    the rules have no batch axes: parameters whole), the cache's
    shardings (a ``ModelCache`` of :class:`~repro_torch.dist.sharding.
    Sharding`), the cache sequence's spec entry (None where it is not
    sharded: no sequence axes, or a length they do not divide) and the
    cache's global length."""

    rules: AxisRules
    fsdp: Optional[fsdp_lib.Layout]
    cache: Any
    seq: Any
    seq_len: int

    @property
    def size(self) -> int:
        """The batch group's ranks: a rank holds 1 / size of the rows."""
        return self.rules.axis_size(self.rules.batch)

    @property
    def seq_group(self):
        """The sequence group: the ranks whose blocks make one cache
        sequence (group ranks in the blocks' order)."""
        if self.seq is None:
            return None
        return collectives.axis_group(self.rules.mesh,
                                      sh_lib.axes_of(self.seq))

    @property
    def seq_block(self) -> Tuple[int, int]:
        """(offset, length) of this rank's block of the cache sequence."""
        idx, n = sh_lib.shard_index(self.rules.mesh, self.seq)
        t = self.seq_len // n
        return idx * t, t

    def rows(self, B: int) -> slice:
        """This rank's rows of a global batch of ``B`` rows."""
        if self.rules.batch is None:
            return slice(0, B)
        return sh_lib.batch_rows(self.rules, B)


def _seq_len(cache) -> int:
    lens = set()
    sh_lib.map_cache(lambda name, x: lens.add(x.shape[1])
                     if name in sh_lib._SEQ_FIELDS else None, cache)
    if len(lens) > 1:
        raise ValueError(f"cache sequence lengths differ: {sorted(lens)}")
    return lens.pop() if lens else 0


def make_layout(params, cache, rules: AxisRules, seq_axes) -> DecodeLayout:
    """The decode layout of a model whose global parameters and cache (any
    device, ``meta`` too) are ``params`` and ``cache``, under decode
    ``rules`` (no sequence axes, no TP) with the cache sequence over
    ``seq_axes`` (``launch/specs._cache_seq_axes``)."""
    if rules.seq_axes or rules.tp_enabled:
        raise ValueError(f"not a decode layout's rules: {rules}")
    seq_len = _seq_len(cache)
    mesh = rules.mesh
    seq = sh_lib._entry(tuple(a for a in sh_lib.axes_of(seq_axes)
                              if a in mesh.mesh_dim_names))
    if seq is not None and (seq_len == 0
                            or seq_len % rules.axis_size(seq)):
        seq = None
    fsdp = (fsdp_lib.make_layout(params, rules)
            if fsdp_lib.is_pure_fsdp(rules) else None)
    return DecodeLayout(rules, fsdp,
                        sh_lib.layer_cache_shardings(cache, rules, seq_axes),
                        seq, seq_len)


def shard_cache(cache, layout: DecodeLayout):
    """This rank's blocks of a whole cache (contiguous copies)."""
    return sh_lib.map_cache(lambda name, x, s: sh_lib.shard(x, s), cache,
                            layout.cache)


def local_structs(cache, layout: DecodeLayout):
    """``meta`` tensors of this rank's blocks' shapes."""
    return sh_lib.map_cache(
        lambda name, x, s: torch.empty(sh_lib.local_shape(s, x.shape),
                                       dtype=x.dtype, device="meta"),
        cache, layout.cache)


def _gather(x: torch.Tensor, sharding: sh_lib.Sharding) -> torch.Tensor:
    """The whole tensor from every rank's block, one sharded dim at a time
    (``fsdp.full_leaf``)."""
    for d, e in enumerate(sharding.spec):
        if e is not None:
            one = tuple(e if i == d else None
                        for i in range(len(sharding.spec)))
            x = fsdp_lib.full_leaf(x, sh_lib.Sharding(sharding.mesh, one))
    return x


def full_cache(cache, layout: DecodeLayout):
    """The whole cache from every rank's blocks (for checks)."""
    return sh_lib.map_cache(lambda name, x, s: _gather(x, s), cache,
                            layout.cache)


# ---------------------------------------------------------------------------
# the installed layout
# ---------------------------------------------------------------------------
_LAYOUT: contextvars.ContextVar[Optional[DecodeLayout]] = \
    contextvars.ContextVar("repro_torch_decode_layout", default=None)


@contextlib.contextmanager
def use_decode_layout(layout: Optional[DecodeLayout]):
    """Install ``layout`` for a decode step, and its parameters' FSDP
    layout for the forward's gather hook."""
    tok = _LAYOUT.set(layout)
    try:
        with fsdp_lib.use_layout(layout.fsdp if layout is not None
                                 else fsdp_lib.current_layout()):
            yield layout
    finally:
        _LAYOUT.reset(tok)


def current_decode_layout() -> Optional[DecodeLayout]:
    return _LAYOUT.get()


def block_write(cache_t: torch.Tensor, start: int, new: torch.Tensor,
                layout: DecodeLayout) -> None:
    """Write one step's new entries ``new`` (B, 1, ...) at global position
    ``start`` into this rank's block ``cache_t`` (B, t, ...) of a sequence
    tensor, where the block holds that position (elsewhere nothing)."""
    if new.shape[1] != 1:
        raise ValueError("a decode layout writes one position a step; "
                         "prefill a whole cache and shard it "
                         "(shard_cache)")
    off = layout.seq_block[0] if layout.seq is not None else 0
    t = cache_t.shape[1]
    if off <= start < off + t:
        cache_t[:, start - off] = new[:, 0].to(cache_t.dtype)
