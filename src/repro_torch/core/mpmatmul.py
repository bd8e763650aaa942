"""Public multi-precision ops (port of ``repro.core.mpmatmul``), forward only.

``mp_matmul(a, b, mode)`` is the single entry point every layer uses for
dense contractions; ``mode`` is anything ``formats.resolve`` accepts.  The
fused projection group (QKV, SwiGLU gate/up) and flash attention have their
own entry points.  The backend comes from the active precision context
(``cuda`` by default) unless a call names one.

Forward only: the ``torch.autograd.Function``s with separate dgrad/wgrad
formats come with the training slice (ROADMAP.md, "Training").  AUTO
(paper mode 1) comes with slice 4 (ROADMAP.md, "Slice 4: DD and AUTO").
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dispatch as dispatch_lib
from repro_torch.core.formats import FormatLike, is_auto, resolve
from repro_torch.core.limbs import PrelimbedWeight
from repro_torch.kernels import ref as ref_backend

_AUTO_TODO = ("AUTO (paper mode 1) is not ported yet: it comes with "
              "ROADMAP.md 'Slice 4: DD and AUTO'; resolve a static format")


def _static(mode: FormatLike):
    if is_auto(mode):
        raise NotImplementedError(_AUTO_TODO)
    return resolve(mode)


def mp_matmul(a: torch.Tensor, b, mode: FormatLike = "M16", *,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-precision matmul: a (..., M, K) @ b (..., K, N) -> (..., M, N)
    f32 at the requested format.  ``b`` may be a 2-D
    :class:`~repro_torch.core.limbs.PrelimbedWeight` (the serving decode
    path's pre-limbed weights)."""
    return dispatch_lib.dispatch(a, b, _static(mode), backend=backend)


def mp_dense(x: torch.Tensor, w, mode: FormatLike = "M16", *,
             backend: Optional[str] = None) -> torch.Tensor:
    """Dense layer contraction: x (..., K) @ w (K, N) -> (..., N); ``w``
    may be a :class:`~repro_torch.core.limbs.PrelimbedWeight`."""
    return mp_matmul(x, w, mode, backend=backend)


def _sequential_fused(x, ws, mode, *, epilogue, biases, residual, backend):
    """Per-branch ``mp_matmul`` (pre-limbed weights): no A-sharing kernel,
    the same epilogue math (``apply_epilogue``)."""
    raws = [mp_matmul(x, w, mode, backend=backend) for w in ws]
    return ref_backend.apply_epilogue(raws, gate=epilogue, biases=biases,
                                      residual=residual)


def mp_fused_proj(x: torch.Tensor, ws, mode: FormatLike = "M16", *,
                  epilogue: str = "none", biases=None,
                  residual: Optional[torch.Tensor] = None,
                  backend: Optional[str] = None):
    """Fused projection group: ``n_out`` contractions of ONE activation
    x (..., K) against (K, N_t) weights, sharing x's read and limb
    decomposition.  Returns the tuple of (..., N_t) outputs, or one tensor
    when ``epilogue="swiglu"`` combines them or ``len(ws) == 1``.  Biases
    ((N_t,) each) and the residual (added to the single final output) fold
    into the kernel's epilogue.  Pre-limbed weights run per-branch
    ``mp_matmul`` calls with the same epilogue (serving decode hits the
    pre-limbed kernel per branch, as in the JAX package)."""
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
    if any(isinstance(w, PrelimbedWeight) for w in ws):
        return _sequential_fused(x, ws, _static(mode), epilogue=epilogue,
                                 biases=biases, residual=residual,
                                 backend=backend)
    return dispatch_lib.dispatch_fused(x, ws, _static(mode), gate=epilogue,
                                       biases=biases, residual=residual,
                                       backend=backend)


def mp_swiglu(x, w_gate, w_up, mode: FormatLike = "M16", *, biases=None,
              residual=None, backend: Optional[str] = None) -> torch.Tensor:
    """Fused SwiGLU half-MLP: ``silu(x @ w_gate) * (x @ w_up)`` in one
    kernel."""
    return mp_fused_proj(x, (w_gate, w_up), mode, epilogue="swiglu",
                         biases=biases, residual=residual, backend=backend)


def mp_qkv_proj(x, wq, wk, wv, mode: FormatLike = "M16", *, biases=None,
                backend: Optional[str] = None):
    """Fused attention input projections: (q, k, v) from one pass over x
    (GQA widths concatenate along N in the ops layer)."""
    return mp_fused_proj(x, (wq, wk, wv), mode, biases=biases,
                         backend=backend)


def mp_einsum_qk(q: torch.Tensor, k: torch.Tensor, mode: FormatLike, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Attention logits: q (..., S, D) @ k^T (..., T, D) -> (..., S, T).
    ``k^T`` is a transposed view; the kernel reads it through its strides."""
    return mp_matmul(q, k.transpose(-1, -2), mode, backend=backend)


def mp_attention(q, k, v, mode_qk: FormatLike = "M16",
                 mode_pv: Optional[FormatLike] = None, *, causal: bool = True,
                 scale: Optional[float] = None, q_offset: int = 0,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Fused multi-precision flash attention: q (B, S, H, Dh); k/v
    (B, T, H, Dh) with H already GQA-repeated.  QK^T at ``mode_qk`` and P·V
    at ``mode_pv`` (defaults to ``mode_qk``)."""
    fmt_qk = _static(mode_qk)
    fmt_pv = _static(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    return dispatch_lib.dispatch_attention(
        q, k, v, fmt_qk, fmt_pv, causal=causal, scale=float(scale),
        q_offset=q_offset, backend=backend)
