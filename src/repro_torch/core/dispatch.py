"""Backend dispatch for the multi-precision ops (port of
``repro.core.dispatch``).

Three built-in backends:

  cuda     the hand-written CUDA kernels (kernels/ops.py,
           kernels/mp_attention.py) — the default.  Their wrappers run the
           kernels' plain PyTorch versions for CPU tensors.
  ref      the pure-PyTorch oracle (kernels/ref.py), chosen only when a
           caller asks for it.
  sharded  the K-sharded multi-rank path over ``torch.distributed``: the
           contraction dim of a 2-D-weight matmul shards over a 1-D mesh
           axis, each rank runs the fused kernel's partials epilogue on its
           K-slice (``kernels.mp_matmul.mp_fused_matmul_partials``: one f32
           sum per limb-product order), ONE all-reduce sums the
           (n_orders, M, N) stacks, and the compensated cross-order combine
           (``ref.combine_partials``) runs once on the reduced stack.  The
           payload is ``n_orders x M x N x 4`` bytes — 1x for M8 up to 7x
           for M52 — so low modes cut communication bytes, and the shard
           count never changes which terms each compensation sees.  Decode
           attention (S == 1) runs sequence-parallel over the cache
           (``dist/attention.sp_decode_attention``).

Where sharding cannot help or cannot work the sharded backend computes
locally, as the JAX package does: DD operands, pre-limbed weights, a batched
``b``, a mesh of one rank, and calls inside a scope that already owns the
ranks (:func:`owned_axes`, which ``dist.pipeline.pipeline_forward`` enters
around each stage).  The JAX package's local fallback is ``ref`` (XLA on its
chip); the port's is the ``cuda`` backend, its kernels, and the fused
projections and prefill attention under ``sharded`` run the ``cuda`` route
too (ROADMAP.md Queue 3).  On CPU tensors those wrappers run their plain
versions.

Pre-limbed weights (:class:`~repro_torch.core.limbs.PrelimbedWeight`) route
to the pre-limbed kernel on ``cuda`` and to the oracle on ``ref``; two-float
operands (:class:`~repro_torch.core.limbs.DD`) to the both-prelimbed kernel
on ``cuda`` and to the oracle on ``ref``; paged decode attention routes to
the paged kernel on ``cuda`` and to the ``pool[table]`` gather plus
:func:`masked_decode_attention` on ``ref`` (and on ``sharded`` where a mesh
of several ranks is there), and under AUTO formats to that gather on every
backend.  The partitioned-lane (mixed-format decode) routes go to the mixed
kernels on ``cuda`` and ``sharded`` and to the lane-masked oracle
elsewhere.

On the card the fused matmul (a 2-D weight), the fused projection and
flash attention launch with the autotune table's parameters for their
shape (``kernels/autotune.py``; a miss keeps the default launch, and the
context's ``autotune`` switch sweeps on a miss); the parameters change no
bit.  Every route reports its call to ``analysis.accounting`` (nothing
outside ``count_work``); under ``sharded`` the part this rank runs.

Backends registered with :func:`register_backend` take ``fn(a, b, fmt)``
for every matmul; their fused projections run per branch through it, their
attention through the oracle.  The deprecated v1 shims
(``set_default_backend``, ``use_backend``) set the context and warn.
"""
from __future__ import annotations

import contextlib
import contextvars
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import accounting
from repro_torch.core import context as context_lib
from repro_torch.core.formats import FormatLike, MPFormat, is_auto, resolve
from repro_torch.core.limbs import DD, PrelimbedWeight
from repro_torch.kernels import autotune
from repro_torch.kernels import ref as ref_backend

BACKENDS = ("cuda", "ref", "sharded")


# ---------------------------------------------------------------------------
# default-backend plumbing — deprecated shims over the PrecisionContext
# ---------------------------------------------------------------------------
def set_default_backend(name: str) -> None:
    """Deprecated: use ``mp.configure(backend=...)``."""
    warnings.warn("set_default_backend is deprecated; use "
                  "repro_torch.mp.configure(backend=...)", DeprecationWarning,
                  stacklevel=2)
    context_lib.configure(backend=name)


def get_default_backend() -> str:
    """The active context's backend (scoped override, else process
    default)."""
    return context_lib.current_context().backend


@contextlib.contextmanager
def use_backend(name: str):
    """Deprecated: use ``with mp.context(backend=...)``."""
    warnings.warn("use_backend is deprecated; use "
                  "repro_torch.mp.context(backend=...)", DeprecationWarning,
                  stacklevel=3)
    with context_lib.context(backend=name) as ctx:
        yield ctx


# ---------------------------------------------------------------------------
# the scope that owns the ranks (JAX: axis names bound by shard_map)
# ---------------------------------------------------------------------------
_OWNED: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "repro_torch_owned_axes", default=())


def _bound_axis_names() -> Tuple[str, ...]:
    """Mesh axes owned by an enclosing per-rank program (a pipeline stage):
    a sharded-backend call inside it computes locally, since the ranks are
    already running different parts of the work and would not all meet at
    its collective."""
    return _OWNED.get()


@contextlib.contextmanager
def owned_axes(names):
    """Mark a scope whose body every rank runs on its own part of the work
    (``dist.pipeline.pipeline_forward``'s stage bodies)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    token = _OWNED.set(_OWNED.get() + names)
    try:
        yield
    finally:
        _OWNED.reset(token)


def snapshot() -> Tuple:
    """The precision context and owned axes of this moment: the training
    ops take it at their forward and restore it around their backward and
    remat's recompute, which run on the autograd engine's thread and see
    none of the caller's context variables."""
    return context_lib.current_context(), _OWNED.get()


@contextlib.contextmanager
def restored(snap: Tuple):
    """Run a scope under a :func:`snapshot`."""
    pctx, owned = snap
    token = _OWNED.set(owned)
    try:
        with context_lib.scoped(pctx):
            yield
    finally:
        _OWNED.reset(token)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
def _on_card(*tensors) -> bool:
    for t in tensors:
        if not t.is_cuda:
            return False
    return True


def _tuned_blocks(a, b, fmt: MPFormat):
    """The autotune table's launch parameters for the fused matmul that
    ``ops.mp_matmul_cuda`` will launch (``a``'s batch folded into M when
    ``b`` is 2-D), or None (a miss: today's choice).  Sweeps only when the
    context's ``autotune`` switch is on (``REPRO_MP_AUTOTUNE=1``);
    otherwise a pure table read.  Batched ``b`` and tensors off the card
    take no part."""
    if b.ndim != 2 or not _on_card(a, b):
        return None
    sweep = context_lib.autotune_enabled()
    if not sweep and not autotune.load_table():
        return None     # no table: nothing to look up on the host
    M = 1
    for d in a.shape[:-1]:
        M *= d
    K, N = b.shape
    if sweep:
        return autotune.autotune(M, K, N, fmt, dtype=torch.float32)
    return autotune.lookup(M, K, N, fmt)


def _run_cuda(a, b, fmt: MPFormat) -> torch.Tensor:
    from repro_torch.kernels import ops

    if isinstance(a, DD) or isinstance(b, DD):
        return ops.mp_matmul_dd(a, b, fmt)
    if isinstance(b, PrelimbedWeight):
        if b.ndim != 2:
            raise ValueError("prelimbed weights must be 2-D per matmul")
        return ops.mp_matmul_prelimbed_weights(a, b.limbs, fmt)
    return ops.mp_matmul_cuda(a, b, fmt, tune=_tuned_blocks(a, b, fmt))


def _run_ref(a, b, fmt: MPFormat) -> torch.Tensor:
    return ref_backend.mp_matmul_ref(a, b, fmt)


def resolve_mesh(mesh=None, axis: str = "data"):
    """The sharded backend's (mesh, axis): the call's mesh, else the
    context's, else the default 1-D matmul mesh of the initialized world;
    a 1-D mesh under any axis name counts, a multi-D mesh without ``axis``
    raises.  None where no process group is initialized and no mesh was
    given (a world of one rank)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    if mesh is None:
        mesh = context_lib.current_context().mesh
    if mesh is None:
        if not dist.is_initialized():
            return None
        mesh = mesh_lib.make_matmul_mesh(axis=axis)
    names = mesh_lib.mesh_axes(mesh)
    if axis not in names:
        if len(names) != 1:
            raise ValueError(
                f"sharded backend needs a 1-D mesh or an axis named "
                f"{axis!r}; the configured mesh has axes {tuple(names)}")
        # a 1-D mesh under any axis name IS a matmul mesh: use its axis
        axis = next(iter(names))
    return mesh, axis


def _sharded_2d(a: torch.Tensor, b: torch.Tensor, fmt: MPFormat, mesh,
                axis: str) -> torch.Tensor:
    """K-sharded a (M, K) @ b (K, N): this rank's K-slice through the
    partials kernel, one all-reduce of the stack, then the combine.  The
    slices are JAX's zero-padded ones (ceil(K / n) each, the last short):
    a view of the replicated operands, no pad copy — the kernel zero-fills
    a chunk past K as the padding would."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import mp_matmul as kern

    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    K = a.shape[1]
    kl = -(-K // n)
    k0, k1 = min(r * kl, K), min((r + 1) * kl, K)
    accounting.record_matmul(a[:, k0:k1], b[k0:k1], fmt,
                             out_planes=fmt.n_orders)
    if k1 > k0:
        part = kern.mp_fused_matmul_partials(a[:, k0:k1], b[k0:k1], fmt)
    else:  # more ranks than K: this rank's slice is all padding
        part = torch.zeros((fmt.n_orders, a.shape[0], b.shape[1]),
                           device=a.device)
    # ONE collective: the (n_orders, M, N) f32 stack
    collectives.all_reduce(part, mesh.get_group(axis))
    return ref_backend.combine_partials(part, fmt)


def _local(a, b, fmt: MPFormat) -> torch.Tensor:
    """The sharded backend computing on this rank alone (the cuda
    route)."""
    accounting.record_matmul(a, b, fmt)
    return _run_cuda(a, b, fmt)


def _run_sharded(a, b, fmt: MPFormat, *, mesh=None,
                 axis: str = "data") -> torch.Tensor:
    """K-sharded multi-rank path; computes locally (the ``cuda`` backend)
    where sharding the contraction cannot help or cannot work: DD or
    pre-limbed operands, a batched ``b``, a mesh of one rank, a scope that
    already owns the ranks."""
    if isinstance(a, (DD, PrelimbedWeight)) \
            or isinstance(b, (DD, PrelimbedWeight)) or b.ndim != 2 \
            or _bound_axis_names():
        return _local(a, b, fmt)
    resolved = resolve_mesh(mesh, axis)
    if resolved is None:
        return _local(a, b, fmt)
    mesh, axis = resolved
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return _local(a, b, fmt)
    lead = a.shape[:-1]
    out = _sharded_2d(a.reshape(-1, a.shape[-1]), b, fmt, mesh, axis)
    return out.reshape(tuple(lead) + (b.shape[-1],))


_REGISTRY: Dict[str, Callable] = {
    "cuda": _run_cuda,
    "ref": _run_ref,
    "sharded": lambda a, b, fmt: _run_sharded(a, b, fmt),
}


def register_backend(name: str, fn: Callable) -> None:
    """Extension point: ``fn(a, b, fmt: MPFormat) -> (..., M, N)`` f32.

    Built-in names are reserved — overwriting "ref" would silently reroute
    every oracle comparison in the process with no way back."""
    if name in BACKENDS:
        raise ValueError(f"cannot override built-in backend {name!r}")
    _REGISTRY[name] = fn


def unregister_backend(name: str) -> None:
    if name in BACKENDS:
        raise ValueError(f"cannot unregister built-in backend {name!r}")
    _REGISTRY.pop(name, None)


def pin_backend(fn: Callable, backend: Optional[str]) -> Callable:
    """Wrap ``fn`` so each call runs under ``context(backend=...)``;
    ``backend`` of None / "" returns ``fn`` unchanged."""
    if not backend:
        return fn

    def wrapped(*args, **kwargs):
        with context_lib.context(backend=backend):
            return fn(*args, **kwargs)

    return wrapped


def available_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def _backend(backend: Optional[str]) -> str:
    name = backend or context_lib.current_context().backend
    if name not in _REGISTRY:
        raise ValueError(f"unknown backend {name!r}; have "
                         f"{available_backends()}")
    return name


def _kernel_route(name: str) -> bool:
    """Does this backend run the kernels for ops it does not shard?"""
    return name in ("cuda", "sharded")


def dispatch(a, b, mode: FormatLike, *,
             backend: Optional[str] = None) -> torch.Tensor:
    """Route one static-format matmul a (..., M, K) @ b (..., K, N); ``b``
    may be a 2-D :class:`PrelimbedWeight`, and either operand a 2-D
    :class:`DD` pair."""
    name = _backend(backend)
    if name != "sharded":   # the sharded backend reports this rank's part
        accounting.record_matmul(a, b, mode)
    return _REGISTRY[name](a, b, resolve(mode))


def dispatch_fused(x: torch.Tensor, ws, mode: FormatLike, *,
                   gate: str = "none", biases=None, residual=None,
                   backend: Optional[str] = None):
    """Route one fused projection group (one activation, ``n_out``
    weights, epilogue lattice): the oracle on ``ref``, the fused projection
    kernel on ``cuda`` and ``sharded`` (K-sharding each branch would
    all-reduce ``n_out`` stacks per group), per-branch :func:`dispatch`
    calls plus the shared epilogue on a registered backend."""
    fmt = resolve(mode)
    ws = tuple(ws)
    name = _backend(backend)
    accounting.record_fused(x, ws, fmt, gate=gate, biases=biases,
                            residual=residual)
    if name == "ref":
        return ref_backend.mp_fused_proj_ref(x, ws, fmt, gate=gate,
                                             biases=biases, residual=residual)
    if _kernel_route(name):
        from repro_torch.kernels import ops

        tune = _tuned_blocks_fused(x, ws, fmt, gate, biases is not None,
                                   residual is not None)
        return ops.mp_fused_proj_cuda(x, ws, fmt, gate=gate, biases=biases,
                                      residual=residual, tune=tune)
    with accounting.paused():
        raws = [dispatch(x, w, fmt, backend=name) for w in ws]
    return ref_backend.apply_epilogue(raws, gate=gate, biases=biases,
                                      residual=residual)


def _tuned_blocks_fused(x, ws, fmt: MPFormat, gate: str, has_bias: bool,
                        has_res: bool):
    """The autotune table's launch parameters for the fused projection
    ``ops.mp_fused_proj_cuda`` will launch: equal widths stack (n_out > 1),
    unequal widths concatenate along N (n_out = 1, N = the sum), as the JAX
    package keys them.  Same sweep discipline as :func:`_tuned_blocks`."""
    if not _on_card(x, *ws):
        return None
    sweep = context_lib.autotune_enabled()
    if not sweep and not autotune.load_table():
        return None
    M = 1
    for d in x.shape[:-1]:
        M *= d
    K = x.shape[-1]
    Ns = [w.shape[-1] for w in ws]
    if len(set(Ns)) == 1 and len(ws) > 1:
        n_out, N = len(ws), Ns[0]
    else:
        n_out, N = 1, sum(Ns)
    desc = autotune.epilogue_desc(gate, has_bias, has_res)
    if sweep:
        return autotune.autotune(M, K, N, fmt, dtype=torch.float32,
                                 n_out=n_out, epilogue=desc)
    return autotune.lookup(M, K, N, fmt, n_out=n_out, epilogue=desc)


def _attn_blocks(q, k, fmt_qk: MPFormat, fmt_pv: MPFormat, causal: bool):
    """The autotune table's query rows per block for the flash kernel (a
    batch x heads / S / T / Dh cell), or None; same sweep discipline as
    :func:`_tuned_blocks`."""
    if not _on_card(q, k):
        return None
    sweep = context_lib.autotune_enabled()
    if not sweep and not autotune.load_table():
        return None
    B, S, H, Dh = q.shape
    T = k.shape[1]
    if sweep:
        got = autotune.autotune_attention(B * H, S, T, Dh, fmt_qk, fmt_pv,
                                          causal=causal)
    else:
        got = autotune.lookup_attention(B * H, S, T, Dh, fmt_qk, fmt_pv,
                                        causal=causal)
    return None if got is None else got[0]


def dispatch_attention(q, k, v, mode_qk: FormatLike,
                       mode_pv: Optional[FormatLike] = None, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0, backend: Optional[str] = None
                       ) -> torch.Tensor:
    """Route one fused attention call (q (B, S, H, Dh), k/v (B, T, H, Dh),
    H already GQA-repeated): the flash kernel on ``cuda``, the unblocked
    oracle on ``ref`` and on registered backends.  ``sharded`` runs decode
    shapes (S == 1) sequence-parallel over the cache
    (``dist.attention.sp_decode_attention``: a causal step at ``q_offset``
    sees positions [0, q_offset], a non-causal probe all T) and prefill
    shapes through the flash kernel."""
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    name = _backend(backend)
    if name == "sharded" and q.shape[1] == 1:
        from repro_torch.dist import attention as dist_attn

        name = "sharded" if dist_attn.usable_mesh() is not None else "cuda"
    if name != "sharded" or q.shape[1] != 1:   # sp decode reports its part
        accounting.record_attention(q, k, v, fmt_qk, fmt_pv, causal=causal,
                                    q_offset=q_offset)
    if name == "sharded" and q.shape[1] == 1:
        T = k.shape[1]
        ln = min(q_offset + 1, T) if causal else T
        return dist_attn.sp_decode_attention(q, k, v, ln, fmt_qk, fmt_pv,
                                             scale=scale)
    if not _kernel_route(name):
        return ref_backend.mp_attention_ref(
            q, k, v, fmt_qk, fmt_pv, causal=causal, scale=scale,
            q_offset=q_offset)
    from repro_torch.kernels import mp_attention as attn_kernels

    return attn_kernels.mp_flash_attention(
        q, k, v, fmt_qk, fmt_pv, causal=causal, scale=scale,
        q_offset=q_offset,
        block_q=_attn_blocks(q, k, fmt_qk, fmt_pv, causal))


def masked_decode_attention(q, k, v, length, mode_qk: FormatLike,
                            mode_pv: Optional[FormatLike] = None, *,
                            scale: Optional[float] = None,
                            backend: Optional[str] = None) -> torch.Tensor:
    """Decode attention: q (B, 1, H, Dh) against k/v (B, T, H, Dh) (H already
    repeated), masked to the first ``length`` positions (an int, or a (B,)
    tensor of per-slot lengths).  Both contractions route through
    ``mp_matmul`` at the ``attn_qk`` / ``attn_pv`` formats; q is scaled
    *before* the contraction so the limb cascade decomposes the same operand
    the fused kernels do.  k/v are read through transposed views (no
    copies): the batched kernel takes their strides.

    Under ``sharded`` (outside a scope that owns the ranks, formats not
    AUTO) the cache sequence is the contraction of both products, so they
    shard jointly: ``dist.attention.sp_decode_attention``, which computes
    here on the ``cuda`` backend where the mesh has one rank."""
    from repro_torch.core.mpmatmul import mp_einsum_qk, mp_matmul

    name = _backend(backend)
    if name == "sharded" and not _bound_axis_names() and not (
            is_auto(mode_qk)
            or is_auto(mode_pv if mode_pv is not None else mode_qk)):
        from repro_torch.dist import attention as dist_attn

        return dist_attn.sp_decode_attention(q, k, v, length, mode_qk,
                                             mode_pv, scale=scale)
    T = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    mode_pv = mode_pv if mode_pv is not None else mode_qk
    qh = q.permute(0, 2, 1, 3).float() * scale             # (B, H, 1, Dh)
    kh = k.permute(0, 2, 1, 3).float()                     # (B, H, T, Dh)
    vh = v.permute(0, 2, 1, 3).float()
    logits = mp_einsum_qk(qh, kh, mode_qk, backend=backend)  # (B, H, 1, T)
    if torch.is_tensor(length) and length.ndim:
        length = length.reshape(-1, 1, 1, 1)
    mask = torch.arange(T, device=q.device) < length
    neg = torch.full((), ref_backend.ATTN_NEG_INF, device=q.device)
    logits = torch.where(mask, logits, neg)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    out = mp_matmul(p, vh, mode_pv, backend=backend)       # (B, H, 1, Dh)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def dispatch_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, block_table: torch.Tensor,
                             lengths: torch.Tensor, mode_qk: FormatLike,
                             mode_pv: Optional[FormatLike] = None, *,
                             scale: Optional[float] = None,
                             backend: Optional[str] = None) -> torch.Tensor:
    """Route one paged-decode attention step: q (B, 1, H, Dh) against the
    block pool (n_blocks, bs, Hkv, Dh) through the slot block tables
    (B, W) int32 and per-slot lengths (B,) int32.

    ``cuda`` runs the paged kernel: pool blocks are read straight through
    the table, the contiguous ``pool[table]`` gather never materializes.
    ``ref`` gathers the table's columns (bounded: the scheduler slices the
    table to its used width) and runs :func:`masked_decode_attention`, as
    ``sharded`` does where a mesh of several ranks is there (the masked
    path then runs sequence-parallel); ``sharded`` on one rank runs the
    paged kernel.  AUTO formats analyze raw operand values, so they take
    that gather on every backend (its contractions run AUTO through
    ``mp_matmul``)."""
    B, S1, H, Dh = q.shape
    mode_pv = mode_pv if mode_pv is not None else mode_qk
    name = _backend(backend)
    auto = is_auto(mode_qk) or is_auto(mode_pv)
    if name == "sharded" and not auto:
        from repro_torch.dist import attention as dist_attn

        if dist_attn.usable_mesh() is None:
            name = "cuda"
    if name == "cuda" and not auto:
        from repro_torch.kernels import mp_attention as attn_kernels

        out = attn_kernels.mp_paged_attention(
            q.reshape(B, H, Dh), k_pool, v_pool, block_table, lengths,
            resolve(mode_qk), resolve(mode_pv), scale=scale)
        return out.reshape(B, S1, H, Dh).to(q.dtype)
    kk, vv = _gather_pages(k_pool, v_pool, block_table, H)
    return masked_decode_attention(q, kk, vv, lengths, mode_qk, mode_pv,
                                   scale=scale, backend=name)


def _gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor, H: int):
    """The ``ref`` routes' K/V: the table's pool blocks gathered into
    (B, W * bs, H, Dh), kv heads repeated to the H query heads."""
    B, W = block_table.shape
    _, bs, hk, Dh = k_pool.shape
    idx = block_table.long()
    kk = k_pool[idx].reshape(B, W * bs, hk, Dh)
    vv = v_pool[idx].reshape(B, W * bs, hk, Dh)
    n_rep = H // hk
    if n_rep > 1:
        kk = torch.repeat_interleave(kk, n_rep, dim=2)
        vv = torch.repeat_interleave(vv, n_rep, dim=2)
    return kk, vv


# ---------------------------------------------------------------------------
# partitioned-lane mixed-format decode (one launch, per-slot formats)
# ---------------------------------------------------------------------------
def _lane_cols(lane: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-slot (B,) lane tensor shaped to broadcast over a (B, ..., N)
    operand: every row of a slot shares the slot's format."""
    lane = lane.reshape(-1)
    return lane.reshape((lane.shape[0],) + (1,) * (ndim - 1))


def dispatch_mixed_matmul(a: torch.Tensor, b, env: FormatLike,
                          lane_n: torch.Tensor, lane_ord: torch.Tensor, *,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Route one partitioned-lane matmul: ``a`` (B, 1, K), one decode row
    per slot, each at its slot's ``(n_limbs, max_order)`` ((B,) int32
    ``lane_n`` / ``lane_ord``) at or below the envelope ``env``, against
    one 2-D weight (raw or pre-limbed).  ``cuda`` runs the mixed pre-limbed
    kernel (``ops.mp_mixed_matmul``); ``ref`` runs the masked oracle.  Both
    apply ``kernels/ref.lane_keep``; ``sharded`` runs the kernel (a decode
    micro-batch's few rows gain nothing from K-sharding), registered
    backends the oracle.  Inference only."""
    env = resolve(env)
    if not _kernel_route(_backend(backend)):
        return ref_backend.masked_matmul_ref(
            a, b, env, _lane_cols(lane_n, a.ndim),
            _lane_cols(lane_ord, a.ndim))
    from repro_torch.kernels import ops

    return ops.mp_mixed_matmul(a, b, env, lane_n, lane_ord)


def mixed_fused_proj(x: torch.Tensor, ws, env: FormatLike,
                     lane_n: torch.Tensor, lane_ord: torch.Tensor, *,
                     epilogue: str = "none", biases=None, residual=None,
                     backend: Optional[str] = None):
    """Partitioned-lane projection group: per-branch mixed matmuls plus the
    shared epilogue, the lane form of ``mpmatmul._sequential_fused``
    (decode projections hit pre-limbed weights, which run per branch in
    the homogeneous path too)."""
    raws = [dispatch_mixed_matmul(x, w, env, lane_n, lane_ord,
                                  backend=backend) for w in ws]
    return ref_backend.apply_epilogue(raws, gate=epilogue, biases=biases,
                                      residual=residual)


def mixed_masked_decode_attention(q, k, v, lengths, env_qk: FormatLike,
                                  env_pv: FormatLike, lane_qk_n, lane_qk_ord,
                                  lane_pv_n, lane_pv_ord, *,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Lane-masked :func:`masked_decode_attention` (the ``ref`` route): q
    (B, 1, H, Dh) against k/v (B, T, H, Dh) (H already repeated), each slot
    running both contractions at its own formats under the envelopes.  The
    same mask / softmax / re-zero steps as the homogeneous path, and the
    same operands limbed (QK on the transposed k, as ``mp_einsum_qk``
    takes it)."""
    T = k.shape[1]
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    qh = q.permute(0, 2, 1, 3).float() * scale             # (B, H, 1, Dh)
    kh = k.permute(0, 2, 1, 3).float()                     # (B, H, T, Dh)
    vh = v.permute(0, 2, 1, 3).float()
    logits = ref_backend.masked_matmul_ref(
        qh, kh.transpose(-1, -2), resolve(env_qk), _lane_cols(lane_qk_n, 4),
        _lane_cols(lane_qk_ord, 4))                         # (B, H, 1, T)
    if torch.is_tensor(lengths) and lengths.ndim:
        lengths = lengths.reshape(-1, 1, 1, 1)
    mask = torch.arange(T, device=q.device) < lengths
    neg = torch.full((), ref_backend.ATTN_NEG_INF, device=q.device)
    logits = torch.where(mask, logits, neg)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    out = ref_backend.masked_attn_pv(
        p, vh, resolve(env_pv), _lane_cols(lane_pv_n, 4),
        _lane_cols(lane_pv_ord, 4))                        # (B, H, 1, Dh)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def dispatch_mixed_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_table: torch.Tensor,
                                   lengths: torch.Tensor, env_qk: FormatLike,
                                   env_pv: FormatLike, lane_qk_n, lane_qk_ord,
                                   lane_pv_n, lane_pv_ord, *,
                                   scale: Optional[float] = None,
                                   backend: Optional[str] = None
                                   ) -> torch.Tensor:
    """Route one partitioned-lane paged-decode attention step: q
    (B, 1, H, Dh) against the block pool through the slot block tables,
    with per-slot QK / PV formats ((B,) int32 lanes) under the envelopes.
    ``cuda`` runs the mixed paged kernel (one launch for every format in
    the batch); ``ref`` gathers the table's columns and runs
    :func:`mixed_masked_decode_attention`.  AUTO never reaches here:
    ``lanes.lanes_eligible`` keeps AUTO policies on the bucket path."""
    B, S1, H, Dh = q.shape
    lanes = (lane_qk_n, lane_qk_ord, lane_pv_n, lane_pv_ord)
    if _kernel_route(_backend(backend)):
        from repro_torch.kernels import mp_attention as attn_kernels

        out = attn_kernels.mp_mixed_paged_attention(
            q.reshape(B, H, Dh), k_pool, v_pool, block_table, lengths,
            env_qk, env_pv, *lanes, scale=scale)
        return out.reshape(B, S1, H, Dh).to(q.dtype)
    kk, vv = _gather_pages(k_pool, v_pool, block_table, H)
    return mixed_masked_decode_attention(q, kk, vv, lengths, env_qk, env_pv,
                                         *lanes, scale=scale)
