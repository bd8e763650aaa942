"""Fused multi-precision flash attention: wrapper, plain version and launch
counter (port of the Pallas ``_flash_kernel`` of
``repro.kernels.mp_attention``).

The wrapper runs the plain PyTorch version for CPU tensors and launches the
CUDA kernel (``csrc/mp_attention.cu``) for CUDA tensors — there is no
fallback from one to the other.  The plain version is the oracle
``ref.mp_attention_ref`` blocked as the kernel blocks: kv tiles of
``BLOCK_KV`` positions, each folded into the running (max, denominator,
accumulator) by the shared online-softmax update.  (The q tile size does not
change the numbers: a kv tile that is processed for a q tile but lies above
a row's diagonal is an exact no-op for that row.)
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import FormatLike, resolve
from repro_torch.kernels import build, ref
from repro_torch.kernels.mp_matmul import _cuda_stream, _f32, _on_cpu

BLOCK_Q = 32    # csrc BQ
BLOCK_KV = 32   # csrc BKV: the online-softmax granularity both versions use
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int64


def flash_attention_plain(q, k, v, fmt_qk, fmt_pv, *, causal=True,
                          scale: Optional[float] = None, q_offset: int = 0
                          ) -> torch.Tensor:
    """Plain version of :func:`mp_flash_attention`."""
    return ref.mp_attention_ref(q, k, v, fmt_qk, fmt_pv, causal=causal,
                                scale=scale, q_offset=q_offset,
                                block_q=BLOCK_Q, block_kv=BLOCK_KV)


def _set_argtypes(lib) -> None:
    if getattr(lib, "_mp_attention_typed", False):
        return
    lib.mp_flash_attention_launch.argtypes = (
        [_P, _I, _I, _I] * 4 + [_I] * 7 + [ctypes.c_double] + [_I] * 4 + [_P])
    lib.mp_flash_attention_launch.restype = ctypes.c_int
    lib._mp_attention_typed = True


def launch_flash_attention(lib, stream: int, q, k, v, fmt_qk, fmt_pv, *,
                           causal: bool, scale: float, q_offset: int
                           ) -> torch.Tensor:
    """Marshal one ``mp_flash_attention_launch`` call.  q (B, S, H, Dh),
    k/v (B, T, H, Dh), read in place through their strides (the head dim
    must be unit-stride, else that operand is copied)."""
    _set_argtypes(lib)
    B, S, H, Dh = q.shape
    T = k.shape[1]
    if k.shape != (B, T, H, Dh) or v.shape != (B, T, H, Dh):
        raise ValueError(f"k/v must be ({B}, T, {H}, {Dh}), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous()
               for x in (_f32(q), _f32(k), _f32(v)))
    o = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    args = []
    for x in (q, k, v, o):
        args += [x.data_ptr(), x.stride(0), x.stride(1), x.stride(2)]
    err = lib.mp_flash_attention_launch(
        *args, B, S, T, H, Dh, int(causal), q_offset, float(scale),
        fmt_qk.n_limbs, fmt_qk.max_order, fmt_pv.n_limbs, fmt_pv.max_order,
        stream)
    build.check(err, "mp_flash_attention")
    return o


def mp_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mode_qk: FormatLike = "M16",
                       mode_pv: Optional[FormatLike] = None, *,
                       causal: bool = True, scale: Optional[float] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """Flash attention: q (B, S, H, Dh), k/v (B, T, H, Dh) with H already
    GQA-repeated -> (B, S, H, Dh) f32.  QK^T at ``mode_qk``, P·V at
    ``mode_pv`` (defaults to ``mode_qk``)."""
    fmt_qk = resolve(mode_qk)
    fmt_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if _on_cpu(q, k, v):
        mp_flash_attention.plain_calls += 1
        return flash_attention_plain(q, k, v, fmt_qk, fmt_pv, causal=causal,
                                     scale=scale, q_offset=q_offset)
    stream = _cuda_stream(q, k, v)
    out = launch_flash_attention(build.load("mp_attention"), stream, q, k, v,
                                 fmt_qk, fmt_pv, causal=causal, scale=scale,
                                 q_offset=q_offset)
    mp_flash_attention.launches += 1
    return out


mp_flash_attention.launches = 0
mp_flash_attention.plain_calls = 0
