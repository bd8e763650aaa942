"""Multi-precision limb matmul kernels: wrappers, plain versions and launch
counters (port of the Pallas ``_fused_kernel``, ``_fused_multi_kernel``,
``_prelimbed_kernel``, ``_mixed_prelimbed_kernel`` and ``_decompose_kernel``
of ``repro.kernels.mp_matmul``).

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/mp_matmul.cu``) for CUDA tensors — there is no fallback
from one to the other.  The plain versions repeat the kernels' accumulation
discipline: one f32 sum per limb-product order, joined by the compensated
``_combine_orders`` (highest order first), whatever the limb count.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import limbs as limbs_lib
from repro_torch.core.formats import FormatLike, MPFormat, resolve
from repro_torch.kernels import build, ref

MAX_OUT = 3   # weights one fused-projection launch takes (csrc MAX_OUT)
MAX_BATCH = 65535  # grid.z limit of one batched matmul launch

_P = ctypes.c_void_p
_I = ctypes.c_int64


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch)
# ---------------------------------------------------------------------------
def _order_sums(al: torch.Tensor, bl: torch.Tensor, s: MPFormat
                ) -> List[torch.Tensor]:
    """Per-order f32 sums of the kept limb products, index = order."""
    by_order: dict[int, torch.Tensor] = {}
    for (i, j) in s.products:
        p = torch.matmul(al[i].float(), bl[j].float())
        o = i + j
        by_order[o] = p if o not in by_order else by_order[o] + p
    return [by_order[o] for o in range(s.n_orders)]


def combine_orders(acc: Sequence[torch.Tensor]) -> torch.Tensor:
    """``_combine_orders``: Neumaier-compensated, highest order first."""
    return limbs_lib.neumaier_sum(acc[::-1])


def fused_matmul_plain(a: torch.Tensor, b: torch.Tensor, fmt: FormatLike
                       ) -> torch.Tensor:
    """Plain version of ``mp_fused_matmul``: a (..., M, K) @ b (..., K, N)
    with ``torch.matmul`` broadcasting."""
    s = resolve(fmt)
    al = limbs_lib.decompose(a, s.n_limbs)
    bl = limbs_lib.decompose(b, s.n_limbs)
    return combine_orders(_order_sums(al, bl, s))


def fused_proj_plain(a: torch.Tensor, ws: Sequence[torch.Tensor],
                     fmt: FormatLike, *, gate: str = "none", biases=None,
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``mp_fused_proj``: a (M, K) limbed ONCE against each
    (K, N) weight; epilogue bias -> silu gate -> residual.  Returns
    (n_out, M, N), or (M, N) when gated."""
    s = resolve(fmt)
    al = limbs_lib.decompose(a, s.n_limbs)
    raws = [combine_orders(_order_sums(al, limbs_lib.decompose(w, s.n_limbs),
                                       s)) for w in ws]
    out = ref.apply_epilogue(raws, gate=gate, biases=biases,
                             residual=residual)
    if gate != "none":
        return out
    return torch.stack(out) if isinstance(out, tuple) else out[None]


def decompose_plain(w: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Plain version of ``mp_decompose``: (..., C) f32 -> (n_limbs, ..., C)
    bf16."""
    return limbs_lib.decompose(w, n_limbs)


def prelimbed_matmul_plain(a: torch.Tensor, limbs: torch.Tensor,
                           fmt: FormatLike) -> torch.Tensor:
    """Plain version of ``mp_prelimbed_matmul``: a (M, K) @ the (K, N)
    weight whose (L, K, N) bf16 limb stack is ``limbs`` (missing limbs zero,
    extra limbs ignored).  The per-order sums and their combine are
    :func:`fused_matmul_plain`'s, so on a stack decomposed from a raw weight
    the two agree bit for bit."""
    s = resolve(fmt)
    al = limbs_lib.decompose(a, s.n_limbs)
    bl = ref._limbs_of(limbs_lib.PrelimbedWeight(limbs), s.n_limbs)
    return combine_orders(_order_sums(al, bl, s))


def mixed_prelimbed_matmul_plain(a: torch.Tensor, limbs: torch.Tensor,
                                 env: FormatLike, lane_n: torch.Tensor,
                                 lane_ord: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mp_mixed_prelimbed_matmul``: row m of a (M, K) at
    its own lane format (``lane_n[m]`` limbs, order cut ``lane_ord[m]``)
    against the (L, K, N) limb stack, under the envelope ``env``.

    The kernel's discipline: each order's f32 sum takes a row's kept
    products in the envelope's product order and leaves the others out
    (no +0.0 is added), then each row joins its orders with the compensated
    combine from its own highest order down.  So a row equals
    :func:`prelimbed_matmul_plain`'s row at the lane's format bit for bit."""
    env = resolve(env)
    al = limbs_lib.decompose(a, env.n_limbs)
    bl = ref._limbs_of(limbs_lib.PrelimbedWeight(limbs), env.n_limbs)
    rn, ro = lane_n.reshape(-1, 1), lane_ord.reshape(-1, 1)
    acc: List[Optional[torch.Tensor]] = [None] * env.n_orders
    started: List[Optional[torch.Tensor]] = [None] * env.n_orders
    for (i, j) in env.products:
        o = i + j
        p = torch.matmul(al[i].float(), bl[j].float())
        keep = ref.lane_keep(i, j, rn, ro)
        if acc[o] is None:
            acc[o], started[o] = torch.where(keep, p, 0.0), keep
        else:
            acc[o] = torch.where(
                keep, torch.where(started[o], acc[o] + p, p), acc[o])
            started[o] = started[o] | keep
    # row-wise _combine_orders: orders above a row's cut are left out
    s = torch.where(env.max_order <= ro, acc[-1], 0.0)
    c = torch.zeros_like(s)
    live = env.max_order <= ro
    for o in range(env.max_order - 1, -1, -1):
        t = acc[o]
        tmp = s + t
        comp = torch.where(s.abs() >= t.abs(), (s - tmp) + t, (t - tmp) + s)
        s, c = (torch.where(live, tmp, torch.where(o == ro, t, s)),
                torch.where(live, c + comp, c))
        live = live | (o == ro)
    return torch.where(ro == 0, s, s + c)


# ---------------------------------------------------------------------------
# launch marshalling (pointers, strides, the stream)
# ---------------------------------------------------------------------------
def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _merge_batch(sizes, *strides_per_tensor):
    """Merge adjacent batch dims that are contiguous with each other in
    every tensor; returns (sizes, strides per tensor)."""
    sizes = list(sizes)
    strides = [list(s) for s in strides_per_tensor]
    i = len(sizes) - 2
    while i >= 0:
        if all(st[i] == st[i + 1] * sizes[i + 1] for st in strides):
            sizes[i] *= sizes[i + 1]
            del sizes[i + 1]
            for st in strides:
                st[i] = st[i + 1]
                del st[i + 1]
        i -= 1
    return sizes, strides


def _set_argtypes(lib) -> None:
    if getattr(lib, "_mp_matmul_typed", False):
        return
    lib.mp_fused_matmul_launch.argtypes = [
        _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_fused_matmul_launch.restype = ctypes.c_int
    lib.mp_fused_proj_launch.argtypes = [
        _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
        _I, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_fused_proj_launch.restype = ctypes.c_int
    lib.mp_prelimbed_matmul_launch.argtypes = [
        _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_prelimbed_matmul_launch.restype = ctypes.c_int
    lib.mp_mixed_prelimbed_matmul_launch.argtypes = [
        _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_mixed_prelimbed_matmul_launch.restype = ctypes.c_int
    lib.mp_decompose_launch.argtypes = [_P, _P, _I, _I, _P]
    lib.mp_decompose_launch.restype = ctypes.c_int
    lib._mp_matmul_typed = True


def launch_fused_matmul(lib, stream: int, a: torch.Tensor, b: torch.Tensor,
                        fmt: MPFormat) -> torch.Tensor:
    """Marshal one ``mp_fused_matmul_launch`` call (any device the library
    runs on).  Leading dims broadcast; at most two batch dims reach the
    kernel after merging, else the operands are copied to contiguous."""
    _set_argtypes(lib)
    a, b = _f32(a), _f32(b)
    M, K = a.shape[-2:]
    K2, N = b.shape[-2:]
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(lead + (M, K))
    b = b.expand(lead + (K, N))
    c = torch.empty(lead + (M, N), dtype=torch.float32, device=a.device)
    n = len(lead)
    sizes, (sa, sb, sc) = _merge_batch(lead, a.stride()[:n], b.stride()[:n],
                                       c.stride()[:n])
    if len(sizes) > 2:
        # explicit copy: three or more batch dims that do not merge
        a, b = a.contiguous(), b.contiguous()
        sizes, (sa, sb, sc) = _merge_batch(lead, a.stride()[:n],
                                           b.stride()[:n], c.stride()[:n])
    sizes = [1] * (2 - len(sizes)) + list(sizes)
    sa, sb, sc = ([0] * (2 - len(x)) + list(x) for x in (sa, sb, sc))
    if sizes[0] * sizes[1] > MAX_BATCH:
        raise ValueError(f"batch of {sizes[0] * sizes[1]} matmuls exceeds "
                         f"one launch ({MAX_BATCH})")
    err = lib.mp_fused_matmul_launch(
        a.data_ptr(), sa[0], sa[1], a.stride(-2), a.stride(-1),
        b.data_ptr(), sb[0], sb[1], b.stride(-2), b.stride(-1),
        c.data_ptr(), sc[0], sc[1], c.stride(-2), c.stride(-1),
        sizes[0], sizes[1], M, N, K, fmt.n_limbs, fmt.max_order, stream)
    build.check(err, "mp_fused_matmul")
    return c


def launch_fused_proj(lib, stream: int, a: torch.Tensor,
                      ws: Sequence[torch.Tensor], fmt: MPFormat, *,
                      gate: str = "none", biases=None,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Marshal one ``mp_fused_proj_launch`` call: a (M, K); ws n_out equal
    (K, N) weights, each from its own pointer (no stacked copy)."""
    _set_argtypes(lib)
    n_out = len(ws)
    if not 1 <= n_out <= MAX_OUT:
        raise ValueError(f"one launch takes 1..{MAX_OUT} weights, got {n_out}")
    if gate not in ("none", "swiglu"):
        raise ValueError(f"unknown gate {gate!r}")
    if gate == "swiglu" and n_out != 2:
        raise ValueError("swiglu gate needs 2 weights")
    if residual is not None and gate == "none" and n_out != 1:
        raise ValueError("residual epilogue needs a single final output")
    a = _f32(a).contiguous()
    M, K = a.shape
    ws = [_f32(w).contiguous() for w in ws]
    N = ws[0].shape[1]
    if any(tuple(w.shape) != (K, N) for w in ws):
        raise ValueError(f"weights must all be ({K}, {N})")
    bias_ptrs = [None] * MAX_OUT
    if biases is not None:
        biases = [_f32(x).contiguous() for x in biases]
        if len(biases) != n_out or any(x.shape != (N,) for x in biases):
            raise ValueError(f"need {n_out} biases of shape ({N},)")
        bias_ptrs[:n_out] = [x.data_ptr() for x in biases]
    res_ptr, res_sr = None, 0
    if residual is not None:
        residual = _f32(residual)
        if residual.shape != (M, N) or residual.stride(-1) != 1:
            residual = residual.reshape(M, N).contiguous()
        res_ptr, res_sr = residual.data_ptr(), residual.stride(0)
    out_shape = (M, N) if gate != "none" else (n_out, M, N)
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    w_ptrs = [w.data_ptr() for w in ws] + [None] * (MAX_OUT - n_out)
    err = lib.mp_fused_proj_launch(
        a.data_ptr(), a.stride(0), *w_ptrs, N, *bias_ptrs, res_ptr, res_sr,
        out.data_ptr(), n_out, int(gate == "swiglu"), M, N, K,
        fmt.n_limbs, fmt.max_order, stream)
    build.check(err, "mp_fused_proj")
    return out


def _prelimbed_operands(a: torch.Tensor, limbs: torch.Tensor):
    """Checked operands of a pre-limbed launch: a (M, K) f32 with unit
    column stride, the (L, K, N) bf16 stack as it is, and the output."""
    a = _f32(a)
    if a.stride(-1) != 1:
        a = a.contiguous()
    M, K = a.shape
    L, K2, N = limbs.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ limb "
                         f"stack {tuple(limbs.shape)}")
    if limbs.dtype != torch.bfloat16:
        raise ValueError(f"limb stack must be bf16, got {limbs.dtype}")
    if limbs.stride(-1) != 1:
        raise ValueError("limb stack needs unit column stride")
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    return a, c


def launch_prelimbed_matmul(lib, stream: int, a: torch.Tensor,
                            limbs: torch.Tensor, fmt: MPFormat
                            ) -> torch.Tensor:
    """Marshal one ``mp_prelimbed_matmul_launch`` call: a (M, K) f32 against
    the (L, K, N) bf16 limb stack, read in place (no padded or sliced copy
    of the stack: planes the format does not need are never read)."""
    _set_argtypes(lib)
    a, c = _prelimbed_operands(a, limbs)
    (M, K), (L, _, N) = a.shape, limbs.shape
    err = lib.mp_prelimbed_matmul_launch(
        a.data_ptr(), a.stride(0), limbs.data_ptr(), limbs.stride(0),
        limbs.stride(1), L, c.data_ptr(), c.stride(0), M, N, K,
        fmt.n_limbs, fmt.max_order, stream)
    build.check(err, "mp_prelimbed_matmul")
    return c


def launch_mixed_prelimbed_matmul(lib, stream: int, a: torch.Tensor,
                                  limbs: torch.Tensor, env: MPFormat,
                                  lane_n: torch.Tensor,
                                  lane_ord: torch.Tensor) -> torch.Tensor:
    """Marshal one ``mp_mixed_prelimbed_matmul_launch`` call: as
    :func:`launch_prelimbed_matmul` at the envelope ``env``, plus the
    per-row lanes (M,) int32, read in place."""
    _set_argtypes(lib)
    a, c = _prelimbed_operands(a, limbs)
    (M, K), (L, _, N) = a.shape, limbs.shape
    for lane in (lane_n, lane_ord):
        if (lane.dtype != torch.int32 or lane.shape != (M,)
                or not lane.is_contiguous()):
            raise ValueError(f"lanes must be contiguous ({M},) int32, got "
                             f"{tuple(lane.shape)} {lane.dtype}")
    err = lib.mp_mixed_prelimbed_matmul_launch(
        a.data_ptr(), a.stride(0), limbs.data_ptr(), limbs.stride(0),
        limbs.stride(1), L, lane_n.data_ptr(), lane_ord.data_ptr(),
        c.data_ptr(), c.stride(0), M, N, K, env.n_limbs, env.max_order,
        stream)
    build.check(err, "mp_mixed_prelimbed_matmul")
    return c


def launch_decompose(lib, stream: int, w: torch.Tensor, n_limbs: int
                     ) -> torch.Tensor:
    """Marshal one ``mp_decompose_launch`` call: (..., C) f32 ->
    (n_limbs, ..., C) bf16."""
    _set_argtypes(lib)
    w = _f32(w).contiguous()
    out = torch.empty((n_limbs,) + tuple(w.shape), dtype=torch.bfloat16,
                      device=w.device)
    err = lib.mp_decompose_launch(w.data_ptr(), out.data_ptr(), w.numel(),
                                  n_limbs, stream)
    build.check(err, "mp_decompose")
    return out


# ---------------------------------------------------------------------------
# the wrappers the port calls
# ---------------------------------------------------------------------------
def _cuda_stream(*tensors: torch.Tensor) -> int:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("CUDA kernel wrappers take tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return torch.cuda.current_stream(dev).cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def mp_fused_matmul(a: torch.Tensor, b: torch.Tensor, fmt: FormatLike
                    ) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) at ``fmt`` -> (..., M, N) f32, leading
    dims broadcast.  CPU tensors run :func:`fused_matmul_plain`; CUDA
    tensors launch the kernel (one launch, batch dims included)."""
    fmt = resolve(fmt)
    if _on_cpu(a, b):
        mp_fused_matmul.plain_calls += 1
        return fused_matmul_plain(a, b, fmt)
    stream = _cuda_stream(a, b)
    out = launch_fused_matmul(build.load("mp_matmul"), stream, a, b, fmt)
    mp_fused_matmul.launches += 1
    return out


mp_fused_matmul.launches = 0      # kernel launches
mp_fused_matmul.plain_calls = 0   # CPU calls that ran the plain version


def mp_fused_proj(a: torch.Tensor, ws: Sequence[torch.Tensor],
                  fmt: FormatLike, *, gate: str = "none", biases=None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (M, K) against 1..3 equal-width (K, N) weights at ``fmt`` with the
    fused epilogue -> (n_out, M, N), or (M, N) when ``gate="swiglu"``.  CPU
    tensors run :func:`fused_proj_plain`; CUDA tensors launch the kernel."""
    fmt = resolve(fmt)
    extra: Tuple[torch.Tensor, ...] = tuple(biases or ()) + (
        (residual,) if residual is not None else ())
    if _on_cpu(a, *ws, *extra):
        mp_fused_proj.plain_calls += 1
        return fused_proj_plain(a, ws, fmt, gate=gate, biases=biases,
                                residual=residual)
    stream = _cuda_stream(a, *ws, *extra)
    out = launch_fused_proj(build.load("mp_matmul"), stream, a, ws, fmt,
                            gate=gate, biases=biases, residual=residual)
    mp_fused_proj.launches += 1
    return out


mp_fused_proj.launches = 0
mp_fused_proj.plain_calls = 0


def mp_prelimbed_matmul(a: torch.Tensor, limbs: torch.Tensor,
                        fmt: FormatLike) -> torch.Tensor:
    """a (M, K) f32 @ a (K, N) weight given as its (L, K, N) bf16 limb
    stack, at ``fmt`` -> (M, N) f32.  Limbs the stack lacks are zero, limbs
    past the format's are ignored.  CPU tensors run
    :func:`prelimbed_matmul_plain`; CUDA tensors launch the kernel."""
    fmt = resolve(fmt)
    if _on_cpu(a, limbs):
        mp_prelimbed_matmul.plain_calls += 1
        return prelimbed_matmul_plain(a, limbs, fmt)
    stream = _cuda_stream(a, limbs)
    out = launch_prelimbed_matmul(build.load("mp_matmul"), stream, a, limbs,
                                  fmt)
    mp_prelimbed_matmul.launches += 1
    return out


mp_prelimbed_matmul.launches = 0
mp_prelimbed_matmul.plain_calls = 0


def mp_mixed_prelimbed_matmul(a: torch.Tensor, limbs: torch.Tensor,
                              env: FormatLike, lane_n: torch.Tensor,
                              lane_ord: torch.Tensor) -> torch.Tensor:
    """a (M, K) f32 @ a (K, N) weight given as its (L, K, N) bf16 limb
    stack, row m at its own lane format (``lane_n[m]`` limbs, order cut
    ``lane_ord[m]``, (M,) int32 each) at or below the envelope ``env`` ->
    (M, N) f32.  A row equals :func:`mp_prelimbed_matmul`'s row at the
    lane's format bit for bit.  CPU tensors run
    :func:`mixed_prelimbed_matmul_plain`; CUDA tensors launch the kernel."""
    env = resolve(env)
    if _on_cpu(a, limbs, lane_n, lane_ord):
        mp_mixed_prelimbed_matmul.plain_calls += 1
        return mixed_prelimbed_matmul_plain(a, limbs, env, lane_n, lane_ord)
    stream = _cuda_stream(a, limbs, lane_n, lane_ord)
    out = launch_mixed_prelimbed_matmul(build.load("mp_matmul"), stream, a,
                                        limbs, env, lane_n, lane_ord)
    mp_mixed_prelimbed_matmul.launches += 1
    return out


mp_mixed_prelimbed_matmul.launches = 0
mp_mixed_prelimbed_matmul.plain_calls = 0


def mp_decompose(w: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(..., C) f32 -> (n_limbs, ..., C) bf16 limb stack (the RNE cascade,
    bitwise ``limbs.decompose``).  CPU tensors run
    :func:`decompose_plain`; CUDA tensors launch the kernel."""
    if _on_cpu(w):
        mp_decompose.plain_calls += 1
        return decompose_plain(w, n_limbs)
    stream = _cuda_stream(w)
    out = launch_decompose(build.load("mp_matmul"), stream, w, n_limbs)
    mp_decompose.launches += 1
    return out


mp_decompose.launches = 0
mp_decompose.plain_calls = 0
