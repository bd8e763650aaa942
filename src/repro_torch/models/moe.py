"""Mixture-of-Experts FFN (port of ``repro.models.moe``; DeepSeek-V2 style:
shared + routed experts, top-k softmax gating), with the JAX package's two
dispatch realizations:

``dense``  — every expert runs on every token and the gated combine keeps
             each token's top-k: exact (no capacity drops).  The JAX package
             maps the E experts one at a time; here each of the three expert
             contractions is ONE batched launch, the (T, D) tokens broadcast
             against the stacked (E, D, F) weights, each batch entry summed
             in the order of a lone launch (so bitwise the per-expert loop).
             The gate combine ``te,etd->td`` is a plain f32 einsum, as XLA
             computes it in the JAX package.

``ep``     — expert parallelism over a ``(data, model)`` mesh of ranks
             (:func:`moe_forward_ep`): tokens split over the model axis,
             routed with the sort-based capacity-bounded dispatch
             (:func:`_dispatch_chunk`), exchanged with ``all_to_all`` over
             the model axis (experts live there), each expert's FFN run on
             its weights all-gathered over data (FSDP), and the inverse
             ``all_to_all`` + gated combine restore token order; chunked
             over tokens (``n_chunks``).  Decode-sized batches take the
             replicated route (a ``psum`` over the model axis in place of
             the exchange).

The router runs at the policy's ``moe_router`` format (M23 by default),
the expert FFNs at ``moe_expert``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core.mpmatmul import mp_matmul
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.models.layers import dense_init, normal, swiglu_mlp


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0
    shared_ff: int = 0           # defaults to n_shared * expert_ff
    capacity_factor: float = 1.25
    n_chunks: int = 1            # token-chunked dispatch (memory / overlap)
    dispatch_dtype: str = "float32"

    @property
    def shared_ff_dim(self) -> int:
        return self.shared_ff or self.n_shared * self.expert_ff


def init_moe_params(gen: torch.Generator, dims: MoEDims, device=None
                    ) -> dict:
    d, e, f = dims.d_model, dims.n_experts, dims.expert_ff
    p = {
        "router": dense_init(gen, d, e, scale=0.02, device=device),
        # stacked expert weights: (E, D, F) / (E, F, D)
        "w_gate": normal(gen, (e, d, f), d ** -0.5, device),
        "w_up": normal(gen, (e, d, f), d ** -0.5, device),
        "w_down": normal(gen, (e, f, d), f ** -0.5, device),
    }
    if dims.n_shared > 0:
        sf = dims.shared_ff_dim
        p["shared"] = {
            "w_gate": dense_init(gen, d, sf, device=device),
            "w_up": dense_init(gen, d, sf, device=device),
            "w_down": dense_init(gen, sf, d, device=device),
        }
    return p


def _route(x2d: torch.Tensor, w_router: torch.Tensor, dims: MoEDims,
           policy: PrecisionPolicy):
    """Router: logits -> top-k, renormalized softmax over the chosen k;
    the Switch-style load-balance aux and the router z-loss."""
    logits = mp_matmul(x2d, w_router, policy.mode("moe_router"),
                       **policy.bwd_kwargs("moe_router"))
    probs = torch.softmax(logits.float(), dim=-1)
    # descending, ties to the lower index (jax.lax.top_k's order)
    top_p, top_i = torch.topk(probs, dims.top_k, dim=-1, sorted=True)
    log = _active_route_log.get()
    if log is not None:
        picked = log.note(top_i)
        if picked is not top_i:   # pinned to a recorded routing
            top_i, top_p = picked, probs.gather(-1, picked)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    T = x2d.shape[0]
    me = probs.mean(dim=0)                                   # mean prob per e
    counts = torch.zeros(dims.n_experts, device=x2d.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=x2d.device)
    ) / (T * dims.top_k)
    aux = dims.n_experts * (me * counts).sum()
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return top_p, top_i, {"moe_aux": aux, "moe_zloss": zloss}


class RouteLog:
    """The router's top-k of one rematerialized region: the forward records
    each ``_route`` call's expert indices in order (:meth:`recording`); the
    recompute in the backward must pick the same experts at each call
    (:meth:`replaying`), or :meth:`note` raises — the counterpart of
    ``core.auto.SelectionLog`` for the router.  :meth:`pinning` instead
    routes each call to the recorded experts (their gates taken from this
    run's probabilities), counting in ``flips`` the tokens whose own top-k
    differs: another backend's run held against a recorded one with the
    router's discrete choice made equal."""

    def __init__(self):
        self.picks: List[torch.Tensor] = []
        self.flips: List[int] = []
        self._pos: Optional[int] = None  # None while recording
        self._pin = False

    @contextlib.contextmanager
    def recording(self):
        self.picks.clear()
        self._pos = None
        token = _active_route_log.set(self)
        try:
            yield self
        finally:
            _active_route_log.reset(token)

    @contextlib.contextmanager
    def replaying(self, pin: bool = False):
        self._pos, self._pin = 0, pin
        token = _active_route_log.set(self)
        try:
            yield self
            if self._pos != len(self.picks):
                raise RuntimeError(f"router recompute made {self._pos} "
                                   f"routings, the forward {len(self.picks)}")
        finally:
            self._pin = False
            _active_route_log.reset(token)

    def pinning(self):
        self.flips.clear()
        return self.replaying(pin=True)

    def note(self, top_i: torch.Tensor) -> torch.Tensor:
        """The experts this call routes to."""
        if self._pos is None:
            self.picks.append(top_i.detach().clone())
            return top_i
        want = self.picks[self._pos] if self._pos < len(self.picks) else None
        if want is not None and self._pin:
            self.flips.append(int((top_i.sort(-1)[0] != want.sort(-1)[0])
                                  .any(-1).sum()))
            self._pos += 1
            return want
        # a meta tensor (the dry run) has no values to hold against
        if want is None or (not top_i.is_meta
                            and not torch.equal(top_i, want)):
            raise RuntimeError(f"router recompute picked other experts at "
                               f"routing {self._pos} than the forward")
        self._pos += 1
        return top_i


_active_route_log: contextvars.ContextVar[Optional[RouteLog]] = \
    contextvars.ContextVar("repro_torch_route_log", default=None)


def moe_forward_dense(params: dict, x: torch.Tensor, dims: MoEDims,
                      policy: PrecisionPolicy) -> Tuple[torch.Tensor, dict]:
    """All experts on all tokens: three batched expert launches, then the
    gated combine and the shared experts."""
    B, S, D = x.shape
    x2 = x.reshape(-1, D)
    top_p, top_i, aux = _route(x2, params["router"], dims, policy)

    mode = policy.mode("moe_expert")
    bwd = policy.bwd_kwargs("moe_expert")
    g = mp_matmul(x2, params["w_gate"], mode, **bwd)         # (E, T, F)
    u = mp_matmul(x2, params["w_up"], mode, **bwd)
    all_out = mp_matmul(torch.nn.functional.silu(g) * u, params["w_down"],
                        mode, **bwd)                         # (E, T, D)
    gates = torch.zeros((x2.shape[0], dims.n_experts), device=x.device)
    gates = gates.scatter(1, top_i, top_p)
    out = torch.einsum("te,etd->td", gates, all_out).reshape(B, S, D)
    out = out + _shared_out(params, x, dims, policy)
    return out, aux


def _shared_out(params: dict, x: torch.Tensor, dims: MoEDims,
                policy: PrecisionPolicy) -> torch.Tensor:
    if dims.n_shared == 0:
        return torch.zeros_like(x)
    sp = params["shared"]
    return swiglu_mlp(x, sp["w_gate"], sp["w_up"], sp["w_down"], policy,
                      op_class="moe_expert")




# -------------------------------------------------------------------- EP path
def _dispatch_chunk(x_chunk: torch.Tensor, top_p: torch.Tensor,
                    top_i: torch.Tensor, dims: MoEDims, cap: int):
    """Sort-based capacity dispatch bookkeeping for one token chunk.

    Returns (send buffer (E*cap, D), keep mask (T*k,), flat buffer index
    (T*k,)): assignment j of token t is row ``buf_idx[t*k + j]`` of the
    buffer, its rank among its expert's assignments in token order (a
    stable sort by expert); an assignment past ``cap`` is dropped
    (``keep`` False, ``buf_idx`` = E*cap, out of the buffer)."""
    T, D = x_chunk.shape
    E, k = dims.n_experts, dims.top_k
    dev = x_chunk.device
    e_flat = top_i.reshape(-1).long()                           # (T*k,)
    # rank of each assignment within its expert (stable order = token order)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    ranks_sorted = torch.arange(T * k, device=dev) - starts[e_sorted]
    ranks = torch.zeros_like(ranks_sorted).scatter(0, order, ranks_sorted)
    keep = ranks < cap                                          # capacity drop
    buf_idx = torch.where(keep, e_flat * cap + ranks,
                          torch.full_like(ranks, E * cap))      # OOB -> drop
    tok_idx = torch.arange(T, device=dev).repeat_interleave(k)
    dtype = getattr(torch, dims.dispatch_dtype)
    # one spare row takes the dropped assignments (JAX: mode="drop")
    send = torch.zeros((E * cap + 1, D), dtype=dtype, device=dev).index_put(
        (buf_idx,), x_chunk[tok_idx].to(dtype))
    return send[:E * cap], keep, buf_idx


def _expert_ffn_gathered(recv: torch.Tensor, params: dict, dims: MoEDims,
                         policy: PrecisionPolicy, data_group, e_local: int
                         ) -> torch.Tensor:
    """recv: (E_local, Tcap, D).  Per local expert, its data-sharded
    weights all-gathered over the data axis (FSDP: peak weight memory one
    expert; the backward reduce-scatters their gradients), then the SwiGLU
    FFN at ``moe_expert`` -> (E_local, Tcap, D) in ``recv``'s dtype."""
    from repro_torch.dist import collectives

    mode = policy.mode("moe_expert")
    bwd = policy.bwd_kwargs("moe_expert")
    outs = []
    for e in range(e_local):
        wg, wu, wd = (collectives.all_gather_diff(params[k][e], data_group)
                      for k in ("w_gate", "w_up", "w_down"))
        xe = recv[e].float()
        g = mp_matmul(xe, wg, mode, **bwd)
        u = mp_matmul(xe, wu, mode, **bwd)
        y = mp_matmul(torch.nn.functional.silu(g) * u, wd, mode, **bwd)
        outs.append(y.to(recv.dtype))
    return torch.stack(outs)


# ``shard_map``'s in / out specs on a torch ``DeviceMesh``: a spec has one
# entry per tensor dim (None, an axis name, or a tuple of names, the first
# major), and a rank's block along a dim is its row-major index over the
# entry's axes.
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def _used(spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in _axes(e))


def _free(mesh, spec) -> Tuple[str, ...]:
    used = _used(spec)
    return tuple(a for a in mesh.mesh_dim_names if a not in used)


def _block_slices(x_shape, mesh, spec):
    idx = []
    for d, e in enumerate(spec):
        i, n = 0, 1
        for a in _axes(e):
            i, n = i * _size(mesh, a) + mesh.get_local_rank(a), \
                n * _size(mesh, a)
        b = x_shape[d] // n
        idx.append(slice(i * b, (i + 1) * b))
    return tuple(idx)


def _assemble(block: torch.Tensor, mesh, spec, full_shape) -> torch.Tensor:
    """Every rank's block (the same spec) put together: the whole array,
    on every rank (one all-gather over the spec's axes)."""
    from repro_torch.dist import collectives

    used = _used(spec)
    if not used:
        return block.clone()
    group = collectives.axis_group(mesh, used)
    flat = collectives.all_gather(block.contiguous().reshape(-1), group)
    ns = [math.prod(_size(mesh, a) for a in _axes(e)) for e in spec]
    k = len(spec)
    # the gather is in group-rank order; put each rank's block at its
    # row-major place in the grid of blocks
    names = list(mesh.mesh_dim_names)
    where = {int(r): c for c, r in zip(
        torch.cartesian_prod(*[torch.arange(n) for n in mesh.mesh.shape])
        .reshape(-1, mesh.mesh.ndim).tolist(), mesh.mesh.reshape(-1))}
    order = []
    for r in torch.distributed.get_process_group_ranks(group):
        c, i = where[r], 0
        for a in used:
            i = i * _size(mesh, a) + c[names.index(a)]
        order.append(i)
    blocks = flat.reshape((len(order),) + tuple(block.shape))
    grid = torch.empty_like(blocks)
    grid[torch.tensor(order, device=blocks.device)] = blocks
    grid = grid.reshape(tuple(ns) + tuple(block.shape))
    perm = [p for d in range(k) for p in (d, k + d)]
    return grid.permute(perm).reshape(full_shape)


class _Enter(torch.autograd.Function):
    """A tensor every rank holds whole -> this rank's block under ``spec``
    (``shard_map``'s in_spec).  Backward: JAX's transpose, the block's
    cotangent summed over the mesh axes the spec leaves out; then every
    rank's block gathered into the whole gradient, which every rank holds
    (the port's parameters and activations are replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, tuple(x.shape)
        return x[_block_slices(x.shape, mesh, spec)].clone()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.dist import collectives

        g = g.contiguous()
        free = _free(ctx.mesh, ctx.spec)
        if free:
            g = collectives.all_reduce(
                g.clone(), collectives.axis_group(ctx.mesh, free))
        return _assemble(g, ctx.mesh, ctx.spec, ctx.shape), None, None


class _Exit(torch.autograd.Function):
    """This rank's block of a ``shard_map`` output -> the whole array on
    every rank (the global array JAX returns).  Backward: the cotangent's
    block, divided by the product of the sizes of the axes the spec leaves
    out — JAX's rule for an output replicated over them."""

    @staticmethod
    def forward(ctx, y, mesh, spec, full_shape):
        ctx.mesh, ctx.spec = mesh, spec
        return _assemble(y, mesh, spec, full_shape)

    @staticmethod
    def backward(ctx, g):
        n = math.prod(_size(ctx.mesh, a) for a in _free(ctx.mesh, ctx.spec))
        g = g[_block_slices(g.shape, ctx.mesh, ctx.spec)]
        return (g / n if n != 1 else g.clone()), None, None, None


def _grad_live(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _enter(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    if _grad_live(x):
        return _Enter.apply(x, mesh, spec)
    return x[_block_slices(x.shape, mesh, spec)]


def _exit(y: torch.Tensor, mesh, spec, full_shape) -> torch.Tensor:
    if _grad_live(y):
        return _Exit.apply(y, mesh, spec, tuple(full_shape))
    return _assemble(y, mesh, spec, tuple(full_shape))


def _pmean(v: torch.Tensor, mesh, axes) -> torch.Tensor:
    from repro_torch.dist import collectives

    for ax in axes:
        v = collectives.psum_diff(v, collectives.axis_group(mesh, ax)) \
            / _size(mesh, ax)
    return v


def _combine(ret: torch.Tensor, keep, buf_idx, top_p, n_tok: int,
             dims: MoEDims) -> torch.Tensor:
    """Gated combine: out[t] = sum_k gate * ret[buf_idx[t, k]] (dropped
    assignments weigh 0) -> (n_tok, D) f32."""
    E_cap = ret.shape[0]
    vals = ret[buf_idx.clamp(0, E_cap - 1)]
    vals = vals * (keep[:, None] * top_p.reshape(-1)[:, None]).to(vals.dtype)
    return vals.reshape(n_tok, dims.top_k, -1).sum(dim=1).float()


def moe_forward_ep(params: dict, x: torch.Tensor, dims: MoEDims,
                   policy: PrecisionPolicy, mesh, *, data_axis: str = "data",
                   model_axis: str = "model",
                   extra_data_axes: Tuple[str, ...] = (),
                   tokens_on_model: bool = False, x_pspec=None
                   ) -> Tuple[torch.Tensor, dict]:
    """Expert-parallel MoE over a ``DeviceMesh`` of ranks (JAX: a
    ``shard_map`` over (data, model)).  ``x`` (B, S, D) and ``params`` are
    whole on every rank, as in the ``sharded`` backend; each rank takes
    its rows of ``x`` over the data axes (``x_pspec``'s layout when given),
    and its experts' slice of the stacked expert weights (experts over
    ``model_axis``, D or F over ``data_axis``).  The whole (B, S, D)
    output and the aux losses (averaged over the mesh) come back on every
    rank.

    Three routes, chosen by the JAX package's rule on the tokens per data
    shard: the split route (each model rank dispatches its slice of the
    tokens, ``all_to_all`` to the experts' ranks and back, the slices
    all-gathered); ``tokens_on_model`` (the batch or sequence already
    split over the model axis: no slice, no gather); and the replicated
    decode route (every model rank routes all its data shard's tokens,
    serves the assignments of its own experts, and the partial outputs are
    summed over the model axis).

    Differentiable: the collectives' backwards are the transposes JAX's
    autodiff takes of the same ``shard_map`` (``dist.collectives``'
    differentiable forms; an output replicated over axes gets its
    cotangent divided by their size, an input's cotangent is summed over
    the axes its spec leaves out), and every parameter's whole gradient
    ends on every rank."""
    from repro_torch.dist import collectives

    names = tuple(mesh.mesh_dim_names)
    d_axes = tuple(extra_data_axes) + (data_axis,)
    missing = [a for a in (model_axis,) + d_axes if a not in names]
    if missing:
        raise ValueError(f"expert parallelism needs mesh axes {missing}; "
                         f"the mesh has {names}")
    B, S, D = x.shape
    E, k = dims.n_experts, dims.top_k
    m_size = _size(mesh, model_axis)
    if E % m_size:
        raise ValueError(f"{E} experts do not split over {m_size} ranks")
    e_local = E // m_size
    if x_pspec is not None:
        pspec_x = (x_pspec[0], x_pspec[1], None)
    else:
        bax = d_axes if len(d_axes) > 1 else d_axes[0]
        pspec_x = (bax, model_axis if tokens_on_model else None, None)
    wspec = (model_axis, data_axis, None)
    # the tokens per data shard decide the route: the split + all_to_all
    # route needs them divisible by the model axis
    data_size = math.prod(_size(mesh, a) for a in d_axes + (
        (model_axis,) if tokens_on_model else ()))
    t_all = (B * S) // data_size
    decode = not tokens_on_model and not (t_all % m_size == 0
                                          and t_all >= m_size)
    # every group the forward or backward may use, made now in one order
    # on every rank (making a group is collective)
    for spec in (pspec_x, wspec, (None, None)):
        for axes in (_used(spec), _free(mesh, spec)):
            if len(axes) > 1:
                collectives.axis_group(mesh, axes)
    g_model = collectives.axis_group(mesh, model_axis)
    g_data = collectives.axis_group(mesh, data_axis)
    m_idx = mesh.get_local_rank(model_axis)

    with dispatch_lib.owned_axes(names):
        x_loc = _enter(x, mesh, pspec_x)
        router = _enter(params["router"], mesh, (None, None))
        lp = {n: _enter(params[n], mesh, wspec)
              for n in ("w_gate", "w_up", "w_down")}
        Bl, S_loc, _ = x_loc.shape
        T_all = Bl * S_loc
        if decode or tokens_on_model:
            T_loc, x_slice = T_all, x_loc.reshape(T_all, D)
        else:
            T_loc = T_all // m_size
            x_slice = x_loc.reshape(T_all, D)[m_idx * T_loc:
                                              (m_idx + 1) * T_loc]
        top_p, top_i, aux = _route(x_slice, router, dims, policy)
        aux_v = _pmean(torch.stack([aux["moe_aux"], aux["moe_zloss"]]),
                       mesh, (model_axis,) + d_axes)
        if decode:
            cap = max(1, math.ceil(T_all * k * dims.capacity_factor / E))
            send, keep, buf_idx = _dispatch_chunk(x_slice, top_p, top_i,
                                                  dims, cap)
            # take only this rank's experts; each model rank fills its
            # slots and the sum over the model axis combines them
            local = send.reshape(E, cap, D)[m_idx * e_local:
                                            (m_idx + 1) * e_local]
            eout = _expert_ffn_gathered(local, lp, dims, policy, g_data,
                                        e_local)
            z = eout.new_zeros
            full = torch.cat([z((m_idx * e_local, cap, D)), eout,
                              z(((m_size - m_idx - 1) * e_local, cap, D))])
            full = collectives.psum_diff(full, g_model).reshape(E * cap, D)
            y = _combine(full, keep, buf_idx, top_p, T_all, dims
                         ).reshape(Bl, S_loc, D)
        else:
            n_chunks = max(1, dims.n_chunks)
            Tc = T_loc // n_chunks
            cap = max(1, math.ceil(Tc * k * dims.capacity_factor / E))
            ys = []
            for c in range(n_chunks):
                sl = slice(c * Tc, (c + 1) * Tc)
                send, keep, buf_idx = _dispatch_chunk(
                    x_slice[sl], top_p[sl], top_i[sl], dims, cap)
                recv = collectives.all_to_all_diff(
                    send.reshape(m_size, e_local * cap, D), g_model)
                # (m_src, E_l*cap, D) -> (E_l, m_src*cap, D)
                recv = recv.reshape(m_size, e_local, cap, D).permute(
                    1, 0, 2, 3).reshape(e_local, m_size * cap, D)
                eout = _expert_ffn_gathered(recv, lp, dims, policy, g_data,
                                            e_local)
                back = eout.reshape(e_local, m_size, cap, D).permute(
                    1, 0, 2, 3).reshape(m_size, e_local * cap, D)
                ret = collectives.all_to_all_diff(back, g_model).reshape(
                    E * cap, D)
                ys.append(_combine(ret, keep, buf_idx, top_p[sl], Tc, dims))
            y_slice = torch.cat(ys)
            if tokens_on_model:
                y = y_slice.reshape(Bl, S_loc, D)
            else:  # the model ranks' slices put back together
                y = collectives.all_gather_diff(y_slice, g_model).reshape(
                    Bl, S_loc, D)
        if dims.n_shared > 0:  # every token, on every model rank
            sp = {n: _enter(w, mesh, (None, None))
                  for n, w in params["shared"].items()}
            y = y + swiglu_mlp(x_loc, sp["w_gate"], sp["w_up"],
                               sp["w_down"], policy, op_class="moe_expert")
        out = _exit(y, mesh, pspec_x, x.shape)
        aux_v = _exit(aux_v, mesh, (None,), (2,))
    return out, {"moe_aux": aux_v[0], "moe_zloss": aux_v[1]}


def moe_forward(params: dict, x: torch.Tensor, dims: MoEDims,
                policy: PrecisionPolicy, mesh=None, **kw
                ) -> Tuple[torch.Tensor, dict]:
    """The expert-parallel realization over ``mesh`` (``kw``: the layout
    arguments of :func:`moe_forward_ep`), else all experts on all tokens."""
    if mesh is not None:
        return moe_forward_ep(params, x, dims, policy, mesh, **kw)
    return moe_forward_dense(params, x, dims, policy)
