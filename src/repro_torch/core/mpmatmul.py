"""Public multi-precision ops (port of ``repro.core.mpmatmul``).

``mp_matmul(a, b, mode)`` is the single entry point every layer uses for
dense contractions; ``mode`` is anything ``formats.resolve`` accepts.  The
fused projection group (QKV, SwiGLU gate/up) and flash attention have their
own entry points.  The backend comes from the active precision context
(``cuda`` by default) unless a call names one.  ``mode="AUTO"`` (paper mode
1) analyzes the operands at run time and runs the cheapest adequate format
(``core/auto.py``).

Differentiable: when an input requires grad, each op runs as a
``torch.autograd.Function`` whose backward re-enters dispatch at the
backward formats — ``dgrad_mode`` (activation grad, dA = g @ B^T) and
``wgrad_mode`` (weight grad, dB = A^T @ g), each defaulting to ``bwd_mode``,
then to the forward format — and so runs the forward kernels.  The weight
gradient of a batched activation against a 2-D weight is one plain product
over all its tokens (``ref.mp_wgrad_ref``).  When no input requires grad
(every serving path) the ops call dispatch directly.  The backend, and the
rest of the precision context with the owned mesh axes
(``dispatch.snapshot``), are taken when the forward runs and restored
around the backward: the CUDA backward runs on the autograd engine's
thread, which sees none of the caller's scopes.

Under ``sharded`` the dgrad re-enters dispatch at ``sharded`` (K-sharded
over the forward's N, one all-reduce of its partials) and the weight
gradient of a batched activation stays local (``ref.mp_wgrad_ref``), as in
the JAX package.  Every rank builds the same graph from the same
replicated inputs, so autograd runs its nodes — and so their collectives —
in one order on every rank: the forward's in program order, the
backward's in reverse order of creation (remat's recompute included, which
runs when the backward reaches its layer).

DD and pre-limbed operands are inference-only, as in the JAX package.  AUTO
under autograd runs the selected format's differentiable op at the caller's
backward formats (``core/auto.py``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core import context as context_lib
from repro_torch.analysis import accounting
from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core.formats import FormatLike, is_auto, resolve
from repro_torch.core.limbs import DD, PrelimbedWeight
from repro_torch.kernels import ref as ref_backend


def _in_forward_scope(backward):
    """Run an autograd Function's backward under the precision context and
    owned axes its forward saved in ``ctx.snap`` (``dispatch.snapshot``)."""
    @functools.wraps(backward)
    def wrapped(ctx, *grads):
        with dispatch_lib.restored(ctx.snap):
            return backward(ctx, *grads)

    return wrapped


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _backend_now(backend: Optional[str]) -> str:
    return backend or context_lib.current_context().backend


def _resolve_bwd(fmt: Optional[FormatLike]):
    return None if fmt is None else resolve(fmt)


def _unbroadcast(x: torch.Tensor, target_shape) -> torch.Tensor:
    """Sum the dims a broadcasting matmul added or expanded back to
    ``target_shape``: leading extra dims first, then the size-1 dims."""
    target_shape = tuple(target_shape)
    if tuple(x.shape) == target_shape:
        return x
    extra = x.ndim - len(target_shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, (xs, ts) in enumerate(zip(x.shape, target_shape))
                 if ts == 1 and xs != 1)
    if dims:
        x = x.sum(dim=dims, keepdim=True)
    return x


def _wgrad(x: torch.Tensor, dr: torch.Tensor, w_shape, wg, backend
           ) -> torch.Tensor:
    """dW = x^T @ dr at ``wg``: one product over every token when a batched
    activation meets a 2-D weight, else a dispatched matmul of the
    transposed view (plus the broadcast reduction)."""
    if len(w_shape) == 2 and x.ndim > 2:
        accounting.record_wgrad(x, dr, wg)
        return ref_backend.mp_wgrad_ref(x, dr, wg)
    dw = dispatch_lib.dispatch(x.transpose(-1, -2), dr, wg, backend=backend)
    return _unbroadcast(dw, w_shape)


class _MPMatmulFn(torch.autograd.Function):
    """``_mp_matmul_diff``: forward at ``fmt``; dA = g @ B^T at the dgrad
    format, dB = A^T @ g at the wgrad format."""

    @staticmethod
    def forward(ctx, a, b, fmt, dgrad_fmt, wgrad_fmt, backend):
        ctx.save_for_backward(a, b)
        ctx.fmts = (dgrad_fmt or fmt, wgrad_fmt or fmt)
        ctx.backend = backend
        ctx.snap = dispatch_lib.snapshot()
        return dispatch_lib.dispatch(a, b, fmt, backend=backend)

    @staticmethod
    @_in_forward_scope
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        dg, wg = ctx.fmts
        g = g.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = dispatch_lib.dispatch(g, b.transpose(-1, -2), dg,
                                       backend=ctx.backend)
            da = _unbroadcast(da, a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _wgrad(a, g, b.shape, wg, ctx.backend).to(b.dtype)
        return da, db, None, None, None, None


def mp_matmul(a, b, mode: FormatLike = "M16", *,
              bwd_mode: Optional[FormatLike] = None,
              dgrad_mode: Optional[FormatLike] = None,
              wgrad_mode: Optional[FormatLike] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-precision matmul: a (..., M, K) @ b (..., K, N) -> (..., M, N)
    f32 at the requested format.  ``b`` may be a 2-D
    :class:`~repro_torch.core.limbs.PrelimbedWeight` (the serving decode
    path's pre-limbed weights), and either operand a 2-D
    :class:`~repro_torch.core.limbs.DD` pair (modes 5 and 6 on operands
    wider than f32).  ``mode="AUTO"`` selects the format from the operands'
    significant bits (``core.auto.mp_matmul_auto``).

    Backward formats: ``dgrad_mode`` and ``wgrad_mode`` each default to
    ``bwd_mode``, which defaults to ``mode``."""
    dgrad = _resolve_bwd(dgrad_mode if dgrad_mode is not None else bwd_mode)
    wgrad = _resolve_bwd(wgrad_mode if wgrad_mode is not None else bwd_mode)
    if is_auto(mode):
        if any(isinstance(x, (PrelimbedWeight, DD)) for x in (a, b)):
            raise TypeError(
                "AUTO mode analyzes raw f32 operand values; pre-limbed "
                "weights carry only a fixed limb stack and DD pairs two "
                "words — resolve a static format first (serving skips "
                "pre-limbing under AUTO policies)")
        from repro_torch.core import auto  # auto imports this module

        return auto.mp_matmul_auto(a, b, backend=backend, dgrad_mode=dgrad,
                                   wgrad_mode=wgrad)
    fmt = resolve(mode)
    if (isinstance(a, (DD, PrelimbedWeight))
            or isinstance(b, (DD, PrelimbedWeight)) or not _needs_grad(a, b)):
        # DD / pre-limbed operands are inference-only (serving decode never
        # differentiates), as in the JAX package
        return dispatch_lib.dispatch(a, b, fmt, backend=backend)
    return _MPMatmulFn.apply(a, b, fmt, dgrad, wgrad, _backend_now(backend))


def mp_dense(x: torch.Tensor, w, mode: FormatLike = "M16", *,
             bwd_mode: Optional[FormatLike] = None,
             dgrad_mode: Optional[FormatLike] = None,
             wgrad_mode: Optional[FormatLike] = None,
             backend: Optional[str] = None) -> torch.Tensor:
    """Dense layer contraction: x (..., K) @ w (K, N) -> (..., N); ``w``
    may be a :class:`~repro_torch.core.limbs.PrelimbedWeight`."""
    return mp_matmul(x, w, mode, bwd_mode=bwd_mode, dgrad_mode=dgrad_mode,
                     wgrad_mode=wgrad_mode, backend=backend)


# ---------------------------------------------------------------------------
# Operand-shared fused projections (QKV, SwiGLU gate+up, fused epilogues)
# ---------------------------------------------------------------------------
class _FusedProjFn(torch.autograd.Function):
    """``_mp_fused_proj_diff``.  Under autograd the raw (post-bias) branch
    outputs are the backward's residuals, so the kernel runs WITHOUT the
    gate and residual epilogue (x is still read and limbed once) and the
    epilogue applies outside it.  The backward is per-branch dispatch calls
    at the backward formats, the branches' dx summed in branch order."""

    @staticmethod
    def forward(ctx, x, residual, meta, *ws_biases):
        fmt, dg, wg, backend, gate, n_w = meta
        ws, biases = ws_biases[:n_w], ws_biases[n_w:] or None
        raws = dispatch_lib.dispatch_fused(x, ws, fmt, gate="none",
                                           biases=biases, backend=backend)
        if not isinstance(raws, tuple):
            raws = (raws,)
        out = ref_backend.apply_epilogue(raws, gate=gate, residual=residual)
        saved = (x, *ws) + (raws if gate == "swiglu" else ())
        ctx.save_for_backward(*saved)
        ctx.meta = meta
        ctx.raw_shapes = [r.shape for r in raws]
        ctx.bias_dtypes = None if biases is None else [b.dtype for b in
                                                       biases]
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.snap = dispatch_lib.snapshot()
        return out

    @staticmethod
    @_in_forward_scope
    def backward(ctx, *grads):
        fmt, dg, wg, backend, gate, n_w = ctx.meta
        dg, wg = dg or fmt, wg or fmt
        x, *rest = ctx.saved_tensors
        ws = rest[:n_w]
        if gate == "swiglu":
            gg = grads[0].float()
            a, u = rest[n_w:]
            sig = torch.sigmoid(a)
            # d silu(a)/da = sig * (1 + a * (1 - sig))
            d_raws = (gg * u * sig * (1.0 + a * (1.0 - sig)), gg * (a * sig))
        else:
            d_raws = tuple(
                torch.zeros(s, device=x.device) if t is None else t.float()
                for t, s in zip(grads, ctx.raw_shapes))
        d_res = None
        if ctx.res_dtype is not None and ctx.needs_input_grad[1]:
            d_res = grads[0].float().to(ctx.res_dtype)
        dx = None
        dws = []
        for t, (w, dr) in enumerate(zip(ws, d_raws)):
            if ctx.needs_input_grad[0]:
                da = dispatch_lib.dispatch(dr, w.transpose(-1, -2), dg,
                                           backend=backend)
                dx = da if dx is None else dx + da
            dws.append(_wgrad(x, dr, w.shape, wg, backend).to(w.dtype)
                       if ctx.needs_input_grad[3 + t] else None)
        d_biases = []
        if ctx.bias_dtypes is not None:
            d_biases = [dr.sum(dim=tuple(range(dr.ndim - 1))).to(dt)
                        for dr, dt in zip(d_raws, ctx.bias_dtypes)]
        dx = None if dx is None else dx.to(x.dtype)
        return (dx, d_res, None, *dws, *d_biases)


def _sequential_fused(x, ws, mode, *, epilogue, biases, residual, dgrad,
                      wgrad, backend):
    """Per-branch ``mp_matmul`` (pre-limbed or DD operands, AUTO mode): no
    A-sharing kernel, the same epilogue math (``apply_epilogue``) and
    backward formats."""
    raws = [mp_matmul(x, w, mode, dgrad_mode=dgrad, wgrad_mode=wgrad,
                      backend=backend) for w in ws]
    return ref_backend.apply_epilogue(raws, gate=epilogue, biases=biases,
                                      residual=residual)


def mp_fused_proj(x: torch.Tensor, ws, mode: FormatLike = "M16", *,
                  epilogue: str = "none", biases=None,
                  residual: Optional[torch.Tensor] = None,
                  bwd_mode: Optional[FormatLike] = None,
                  dgrad_mode: Optional[FormatLike] = None,
                  wgrad_mode: Optional[FormatLike] = None,
                  backend: Optional[str] = None):
    """Fused projection group: ``n_out`` contractions of ONE activation
    x (..., K) against (K, N_t) weights, sharing x's read and limb
    decomposition.  Returns the tuple of (..., N_t) outputs, or one tensor
    when ``epilogue="swiglu"`` combines them or ``len(ws) == 1``.  Biases
    ((N_t,) each) and the residual (added to the single final output) fold
    into the kernel's epilogue.  Pre-limbed or DD operands and AUTO mode run
    per-branch ``mp_matmul`` calls with the same epilogue (serving decode
    hits the pre-limbed kernel per branch, and AUTO analyzes each branch's
    operands, as in the JAX package).  Differentiable: per-branch dispatch
    calls at ``dgrad_mode`` / ``wgrad_mode`` (both default to
    ``bwd_mode``, then ``mode``)."""
    ws = tuple(ws)
    if not ws:
        raise ValueError("mp_fused_proj needs at least one weight")
    for w in ws:
        if w.ndim != 2:
            raise ValueError(
                f"fused projection weights must be 2-D, got {tuple(w.shape)}")
    if epilogue not in ("none", "swiglu"):
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "swiglu":
        if len(ws) != 2:
            raise ValueError("swiglu epilogue needs exactly 2 weights")
        if ws[0].shape[-1] != ws[1].shape[-1]:
            raise ValueError("swiglu gate/up weights must have equal width")
    if residual is not None and epilogue == "none" and len(ws) != 1:
        raise ValueError("residual epilogue needs a single final output")
    if biases is not None:
        biases = tuple(biases)
        if len(biases) != len(ws):
            raise ValueError(f"{len(biases)} biases for {len(ws)} weights")
        if any(b is None for b in biases):
            raise ValueError("biases must be all tensors or None (pass a "
                             "zeros vector for a bias-free branch)")
    dgrad = _resolve_bwd(dgrad_mode if dgrad_mode is not None else bwd_mode)
    wgrad = _resolve_bwd(wgrad_mode if wgrad_mode is not None else bwd_mode)
    if is_auto(mode) or any(isinstance(o, (PrelimbedWeight, DD))
                            for o in (x, *ws)):
        return _sequential_fused(x, ws, mode, epilogue=epilogue,
                                 biases=biases, residual=residual,
                                 dgrad=dgrad, wgrad=wgrad, backend=backend)
    fmt = resolve(mode)
    if not _needs_grad(x, residual, *ws, *(biases or ())):
        return dispatch_lib.dispatch_fused(x, ws, fmt, gate=epilogue,
                                           biases=biases, residual=residual,
                                           backend=backend)
    meta = (fmt, dgrad, wgrad, _backend_now(backend), epilogue, len(ws))
    return _FusedProjFn.apply(x, residual, meta, *ws, *(biases or ()))


def mp_swiglu(x, w_gate, w_up, mode: FormatLike = "M16", *, biases=None,
              residual=None, **kw) -> torch.Tensor:
    """Fused SwiGLU half-MLP: ``silu(x @ w_gate) * (x @ w_up)`` in one
    kernel."""
    return mp_fused_proj(x, (w_gate, w_up), mode, epilogue="swiglu",
                         biases=biases, residual=residual, **kw)


def mp_qkv_proj(x, wq, wk, wv, mode: FormatLike = "M16", *, biases=None,
                **kw):
    """Fused attention input projections: (q, k, v) from one pass over x
    (GQA widths concatenate along N in the ops layer)."""
    return mp_fused_proj(x, (wq, wk, wv), mode, biases=biases, **kw)


def mp_einsum_qk(q: torch.Tensor, k: torch.Tensor, mode: FormatLike, **kw
                 ) -> torch.Tensor:
    """Attention logits: q (..., S, D) @ k^T (..., T, D) -> (..., S, T).
    ``k^T`` is a transposed view; the kernel reads it through its strides."""
    return mp_matmul(q, k.transpose(-1, -2), mode, **kw)


# ---------------------------------------------------------------------------
# Fused multi-precision flash attention
# ---------------------------------------------------------------------------
class _AttentionFn(torch.autograd.Function):
    """``_mp_attention_diff``: the flash kernel forward; the backward
    decomposed into dispatch calls at the per-side backward formats:

        dV = P^T · dO            at wgrad_pv      (weight-side of P·V)
        dP = dO · V^T            at dgrad_pv      (activation grad of P·V)
        dS = P ∘ (dP - rowsum(dP ∘ P))            (softmax Jacobian, f32)
        dQ = dS · K  (· scale)   at dgrad_qk
        dK = dS^T · Qs           at wgrad_qk      (Qs pre-scaled, as fwd)

    P is rematerialized densely from the saved (q, k, v) at the *forward*
    QK format, so the backward sees the logits the forward quantized."""

    @staticmethod
    def forward(ctx, q, k, v, meta):
        fmt_qk, fmt_pv, _, _, _, _, causal, scale, q_offset, backend = meta
        ctx.save_for_backward(q, k, v)
        ctx.meta = meta
        ctx.snap = dispatch_lib.snapshot()
        return dispatch_lib.dispatch_attention(
            q, k, v, fmt_qk, fmt_pv, causal=causal, scale=scale,
            q_offset=q_offset, backend=backend)

    @staticmethod
    @_in_forward_scope
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        (fmt_qk, fmt_pv, dg_qk, wg_qk, dg_pv, wg_pv, causal, scale,
         q_offset, backend) = ctx.meta
        dg_qk, wg_qk = dg_qk or fmt_qk, wg_qk or fmt_qk
        dg_pv, wg_pv = dg_pv or fmt_pv, wg_pv or fmt_pv

        def run(x, y, fmt):
            return dispatch_lib.dispatch(x, y, fmt, backend=backend)

        S, T = q.shape[1], k.shape[1]
        qh = q.permute(0, 2, 1, 3).float() * scale
        kh = k.permute(0, 2, 1, 3).float()
        vh = v.permute(0, 2, 1, 3).float()
        logits = run(qh, kh.transpose(-1, -2), fmt_qk)        # (B, H, S, T)
        mask = None
        if causal:
            q_pos = q_offset + torch.arange(S, device=q.device)
            mask = q_pos[:, None] >= torch.arange(T, device=q.device)[None, :]
            logits = torch.where(mask, logits, torch.full(
                (), ref_backend.ATTN_NEG_INF, device=q.device))
        p = torch.softmax(logits, dim=-1)
        gh = g.permute(0, 2, 1, 3).float()                    # (B, H, S, Dh)
        dv = run(p.transpose(-1, -2), gh, wg_pv)
        dp = run(gh, vh.transpose(-1, -2), dg_pv)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        if mask is not None:
            ds = torch.where(mask, ds, torch.zeros((), device=q.device))
        dq = run(ds, kh, dg_qk) * scale
        dk = run(ds.transpose(-1, -2), qh, wg_qk)

        def to_bshd(x, like):
            return x.permute(0, 2, 1, 3).to(like.dtype)

        return to_bshd(dq, q), to_bshd(dk, k), to_bshd(dv, v), None


def mp_attention(q, k, v, mode_qk: FormatLike = "M16",
                 mode_pv: Optional[FormatLike] = None, *, causal: bool = True,
                 scale: Optional[float] = None, q_offset: int = 0,
                 bwd_mode: Optional[FormatLike] = None,
                 dgrad_qk_mode: Optional[FormatLike] = None,
                 wgrad_qk_mode: Optional[FormatLike] = None,
                 dgrad_pv_mode: Optional[FormatLike] = None,
                 wgrad_pv_mode: Optional[FormatLike] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Fused multi-precision flash attention: q (B, S, H, Dh); k/v
    (B, T, H, Dh) with H already GQA-repeated.  QK^T at ``mode_qk`` and P·V
    at ``mode_pv`` (defaults to ``mode_qk``).  Differentiable: the backward
    rematerializes P densely and runs dispatch calls at the per-side
    backward formats (each defaults to ``bwd_mode``, then its forward
    format).

    AUTO formats analyze raw operand values per matmul and are not taken
    here: resolve a static format first (models route AUTO policies to the
    chunk-scan, whose per-chunk ``mp_matmul`` calls run AUTO)."""
    if is_auto(mode_qk) or (mode_pv is not None and is_auto(mode_pv)):
        raise ValueError(
            "mp_attention needs static formats (AUTO analyzes operands per "
            "matmul; use the chunk-scan path for AUTO policies)")
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if not _needs_grad(q, k, v):
        return dispatch_lib.dispatch_attention(
            q, k, v, fmt_qk, fmt_pv, causal=causal, scale=float(scale),
            q_offset=q_offset, backend=backend)
    bwd = _resolve_bwd(bwd_mode)

    def side(mode):
        return _resolve_bwd(mode) if mode is not None else bwd

    meta = (fmt_qk, fmt_pv, side(dgrad_qk_mode), side(wgrad_qk_mode),
            side(dgrad_pv_mode), side(wgrad_pv_mode), causal, float(scale),
            q_offset, _backend_now(backend))
    return _AttentionFn.apply(q, k, v, meta)


def mode_flops(mode: FormatLike, m: int, k: int, n: int) -> int:
    """Multiply-add FLOPs of one mp_matmul: 2·m·k·n per kept limb product
    (the paper's 'area x time' cost axis)."""
    return 2 * m * k * n * resolve(mode).n_products
