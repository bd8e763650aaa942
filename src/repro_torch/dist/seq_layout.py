"""The Ulysses layout of a train or prefill step: batch rows over the batch
axes, the sequence over the sequence axes (``model``), parameters by
``dist.sharding.param_shardings`` over the batch axes
(``launch/specs.make_rules`` for a cell whose batch does not divide
(``pod``,) ``data``, ``model``).

The JAX package has no counterpart module: there GSPMD partitions the step
by the ``activations_seq`` / ``attn_heads`` constraints and inserts this
work.  Here it is explicit, on every rank:

* each rank holds its rows of the batch with the whole sequence (JAX's
  ``batch_structs``); the forward embeds them and keeps this rank's block
  of the sequence (:attr:`SeqLayout.block`), positions at the block's
  offset;
* the parameters are this rank's FSDP blocks over the batch axes, gathered
  right before each use (``dist.fsdp.gatherer``); a gradient sums over the
  batch group and over the sequence group (``dist.fsdp.gather``);
* attention (``models.attention``, ``models.mla``) runs in one of two
  modes, JAX's rule (``models/attention.py`` there): ``heads`` where the
  sequence group's size divides the heads — q, k, v exchanged from
  sequence blocks to heads (:func:`seq_to_heads`, one ``all_to_all``
  each), each rank attending over the whole sequence for its heads, the
  output exchanged back (:func:`heads_to_seq`); ``seq`` otherwise — K / V
  gathered over the sequence group (:func:`gather_seq`; backward: the
  reduce-scatter) and the rank's queries attending at their offset;
* a Mamba2 layer (``models.ssm``) runs its block after the previous
  block's: it takes the previous block's last ``d_conv - 1`` pre-conv
  inputs as the conv's carried window and its final state as the SSD's
  initial state, and hands its own on (:class:`SSMHandover`: point-to-point
  ``send`` / ``recv`` over the sequence group, in rank order, whose
  backwards send the gradients back);
* each rank's loss is its tokens' sum over its rows' token count, divided
  by the batch group's size (``train.trainer.make_loss_fn`` and
  ``dist.fsdp.local_loss``), so the gradients' sums above are the global
  mean's; the metrics sum over every rank (``dist.fsdp.reduce_metrics``
  over :attr:`SeqLayout.metrics_group`);
* a prefill writes each attention layer's K / V into the rank's own cache
  block (the decode layout's blocks: ``layer_cache_shardings`` with the
  cache sequence over the sequence axes; ``dist.decode_layout.shard_cache``
  and ``full_cache`` cut and join them), and the last block's SSM states
  and logits go to every rank of the sequence group (:func:`from_last`).

The forward on a rank's rows and block gives the one-rank forward's bits
there wherever each kernel is row-invariant and each head is computed
alone: the exchanges are copies, the route is decided on the global shape
(``models.attention._self_attention``), and the SSM hand-over is the
one-rank chunk loop's carry.  With no layout installed nothing here runs
and no collective is called.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.dist import fsdp as fsdp_lib
from repro_torch.dist import sharding as sh_lib
from repro_torch.dist.sharding import AxisRules


@dataclasses.dataclass(frozen=True)
class SeqLayout:
    """A Ulysses layout: the rules, the parameters' FSDP layout over the
    batch axes, the global sequence length and, for a prefill, the cache's
    shardings (a ``ModelCache`` of :class:`~repro_torch.dist.sharding.
    Sharding`; None for a training step).  ``params``, ``group`` and
    ``size`` are the FSDP layout's (the AdamW step reads them)."""

    rules: AxisRules
    fsdp: fsdp_lib.Layout
    seq_len: int
    cache: Any = None

    @property
    def params(self):
        return self.fsdp.params

    @property
    def group(self):
        """The batch group: the ranks holding other rows of one block."""
        return self.fsdp.group

    @property
    def size(self) -> int:
        return self.fsdp.size

    @property
    def model_size(self) -> int:
        """The sequence group's size M."""
        return self.rules.axis_size(self.rules.seq)

    @property
    def model_group(self):
        """The sequence group: the ranks whose blocks make one sequence
        (group ranks in the blocks' order)."""
        return collectives.axis_group(self.rules.mesh,
                                      sh_lib.axes_of(self.rules.seq))

    @property
    def model_rank(self) -> int:
        return sh_lib.shard_index(self.rules.mesh, self.rules.seq)[0]

    @property
    def metrics_group(self):
        """Every rank of the layout (batch and sequence axes): the ranks a
        step's loss shares and metrics sum over."""
        return collectives.axis_group(
            self.rules.mesh, sh_lib.axes_of(self.rules.batch)
            + sh_lib.axes_of(self.rules.seq))

    @property
    def block(self) -> Tuple[int, int]:
        """(offset, length) of this rank's block of the sequence."""
        s = sh_lib.seq_block(self.rules, self.seq_len)
        return s.start, s.stop - s.start

    def mode(self, n_heads: int) -> str:
        """``heads`` where the sequence group divides the heads (the
        seq <-> heads exchange), else ``seq`` (K / V gathered)."""
        return "heads" if n_heads % self.model_size == 0 else "seq"

    def rows(self, B: int) -> slice:
        """This rank's rows of a global batch of ``B`` rows."""
        return sh_lib.batch_rows(self.rules, B)


def make_layout(params, rules: AxisRules, seq_len: int, cache=None,
                cache_seq_axes=()) -> SeqLayout:
    """The layout of a model whose global parameters (any device, ``meta``
    too) are ``params`` over a sequence of ``seq_len`` positions, under
    rules with batch and sequence axes and no TP; ``cache``: a prefill's
    global cache, laid out with its sequence over ``cache_seq_axes``."""
    if not rules.seq_axes or rules.tp_enabled or rules.batch is None:
        raise ValueError(f"not a Ulysses layout's rules: {rules}")
    if seq_len % rules.axis_size(rules.seq):
        raise ValueError(f"a sequence of {seq_len} does not split over the "
                         f"sequence axes {rules.seq}")
    shardings = (sh_lib.layer_cache_shardings(cache, rules, cache_seq_axes)
                 if cache is not None else None)
    return SeqLayout(rules, fsdp_lib.Layout(
        rules, sh_lib.param_shardings(params, rules)), seq_len, shardings)


# ---------------------------------------------------------------------------
# the installed layout
# ---------------------------------------------------------------------------
_LAYOUT: contextvars.ContextVar[Optional[SeqLayout]] = \
    contextvars.ContextVar("repro_torch_seq_layout", default=None)


@contextlib.contextmanager
def use_seq_layout(layout: Optional[SeqLayout]):
    """Install ``layout`` for a step, and its parameters' FSDP layout for
    the forward's gather hook."""
    tok = _LAYOUT.set(layout)
    try:
        with fsdp_lib.use_layout(layout.fsdp if layout is not None
                                 else fsdp_lib.current_layout()):
            yield layout
    finally:
        _LAYOUT.reset(tok)


def current_seq_layout() -> Optional[SeqLayout]:
    return _LAYOUT.get()


# ---------------------------------------------------------------------------
# the attention exchanges
# ---------------------------------------------------------------------------
def seq_to_heads(x: torch.Tensor, layout: SeqLayout) -> torch.Tensor:
    """(B, t, H, Dh), this rank's positions of every head -> (B, S, H / M,
    Dh), every position of its heads (head block j goes to group rank j);
    one ``all_to_all`` over the sequence group, a copy."""
    M = layout.model_size
    B, t, H, Dh = x.shape
    blocks = x.reshape(B, t, M, H // M, Dh).permute(2, 0, 1, 3, 4)
    got = collectives.all_to_all_diff(blocks.contiguous(),
                                      layout.model_group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, M * t, H // M, Dh)


def heads_to_seq(x: torch.Tensor, layout: SeqLayout) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: (B, S, h, Dh) of this rank's
    heads -> (B, t, M h, Dh) of its positions."""
    M = layout.model_size
    B, S, h, Dh = x.shape
    blocks = x.reshape(B, M, S // M, h, Dh).permute(1, 0, 2, 3, 4)
    got = collectives.all_to_all_diff(blocks.contiguous(),
                                      layout.model_group)
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // M, M * h, Dh)


def gather_seq(x: torch.Tensor, layout: SeqLayout) -> torch.Tensor:
    """(B, t, ...) this rank's block -> (B, S, ...) every block in order
    (contiguous); one ``all_gather`` over the sequence group, whose
    backward reduce-scatters the cotangent (every rank's queries' share)."""
    moved = x.movedim(1, 0).contiguous()
    full = collectives.all_gather_diff(moved, layout.model_group)
    return full.movedim(0, 1).contiguous()


def cache_block_write(cache_t: torch.Tensor, start: int, new: torch.Tensor,
                      layout: SeqLayout) -> None:
    """A prefill's entries ``new`` (B, t, ...) of this rank's block into
    its block ``cache_t`` of a sequence tensor of the cache.  Local only
    where the cache's blocks are the sequence's: a cache as long as the
    prompt, written from position 0."""
    if start != 0 or cache_t.shape[1] != new.shape[1]:
        raise NotImplementedError(
            "a prefill into a cache longer than its prompt (or after a "
            "prefix) under the Ulysses layout: the rank's block of the "
            "prompt is not its block of the cache, and the port has no "
            "exchange between them (ROADMAP.md Queue 1 item 2c); such a "
            "prefill runs whole-rank")
    cache_t.copy_(new.to(cache_t.dtype))


# ---------------------------------------------------------------------------
# the SSM hand-over
# ---------------------------------------------------------------------------
class _Recv(torch.autograd.Function):
    """Receive one carry from group rank ``src`` (None: no previous block,
    zeros); the backward sends its gradient back there.  ``dep`` takes no
    gradient: it ties the node to the parameters, so that a backward
    asked for their gradients alone still runs it."""

    @staticmethod
    def forward(ctx, dep, like, src, group):
        ctx.src, ctx.group = src, group
        if src is None:
            return like.zero_()
        return collectives.recv(like, src, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.src is not None:
            collectives.send(g.contiguous(), ctx.src, ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send one carry to group rank ``dst`` (None: no next block, nothing
    sent); returns a 0-d token for :class:`_Tie`, whose backward receives
    the carry's gradient from that rank (zeros where none)."""

    @staticmethod
    def forward(ctx, x, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        if dst is not None:
            collectives.send(x.contiguous(), dst, group)
        return torch.zeros((), device=x.device)

    @staticmethod
    def backward(ctx, _):
        g = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        if ctx.dst is not None:
            collectives.recv(g, ctx.dst, ctx.group)
        return g, None, None


class _Tie(torch.autograd.Function):
    """``x`` itself, made to depend on the hand-over's send tokens: the
    backward reaches each send (whose backward receives the gradient of
    what it sent) once it has passed ``x``."""

    @staticmethod
    def forward(ctx, x, *tokens):
        ctx.n = len(tokens)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros((), device=g.device)] * ctx.n)


class SSMHandover:
    """One Mamba2 layer's hand-over between the blocks of the sequence
    group, in rank order: the rank receives the previous block's carry
    (zeros on the first block: the one-rank start) and sends its own to
    the next block (nothing from the last).  Where the step differentiates
    through the carry each receive's backward sends its gradient back and
    each send's backward receives it; ``dep``, a tensor of the layer that
    requires grad exactly then (the same on every rank), carries that to
    the receives.

    Every rank builds the same autograd nodes (the first block's receives
    and the last block's sends are nodes that call nothing), so the
    backward runs the hand-over and the gradients' collectives in one
    order on every rank: each send's backward waits only on the next
    block's receive, with no collective of the group between them."""

    def __init__(self, layout: SeqLayout, dep: torch.Tensor):
        self.group = layout.model_group
        r, M = layout.model_rank, layout.model_size
        self.prev = r - 1 if r > 0 else None
        self.next = r + 1 if r < M - 1 else None
        self.dep = dep
        self.tokens = []

    def _recv(self, like: torch.Tensor) -> torch.Tensor:
        return _Recv.apply(self.dep, torch.empty(
            like.shape, dtype=like.dtype, device=like.device), self.prev,
            self.group)

    def _send(self, x: torch.Tensor) -> None:
        self.tokens.append(_Send.apply(x, self.next, self.group))

    def window(self, x_pre: torch.Tensor, n: int) -> torch.Tensor:
        """The previous block's last ``n`` pre-conv inputs (the conv's
        carried window; zeros on the first block), this block's sent
        on."""
        mine = x_pre[:, x_pre.shape[1] - n:]
        got = self._recv(mine)
        self._send(mine)
        return got

    def recv_state(self, like: torch.Tensor) -> torch.Tensor:
        """The previous block's final state (zeros on the first block)."""
        return self._recv(like)

    def send_state(self, state: torch.Tensor) -> None:
        self._send(state)

    def tie(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` carrying the sends' tokens (see :class:`_Tie`); tie a
        tensor the layer's last saved product reads, so that its backward
        (remat's recompute of the layer included) runs before the sends'
        backwards wait on the next block."""
        if not torch.is_grad_enabled():
            return x
        return _Tie.apply(x, *self.tokens)


def from_last(x: torch.Tensor, layout: SeqLayout) -> torch.Tensor:
    """The last block's ``x`` on every rank of the sequence group (a
    broadcast; no autograd): a prefill's SSM states and last logits."""
    group = layout.model_group
    out = x.detach().contiguous().clone()
    return collectives.broadcast(
        out, dist.get_global_rank(group, layout.model_size - 1), group)


# ---------------------------------------------------------------------------
# the step's labels
# ---------------------------------------------------------------------------
def label_block(logits: torch.Tensor, labels: torch.Tensor, n_prefix: int,
                layout: SeqLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block's logits (B, t, V) and its labels: ``labels``
    (B, S - n_prefix) hold the positions from ``n_prefix`` on (the VLM's
    patches carry none), so the block keeps the positions at or past
    ``n_prefix`` by global position."""
    off, t = layout.block
    lo = max(off, n_prefix)
    hi = max(off + t, n_prefix)
    return logits[:, lo - off:], labels[:, lo - n_prefix:hi - n_prefix]
