"""Multi-precision limb matmul kernels: wrappers, plain versions and launch
counters (port of the Pallas ``_fused_kernel``, ``_fused_multi_kernel``,
``_prelimbed_kernel``, ``_mixed_prelimbed_kernel``,
``_both_prelimbed_kernel`` and ``_decompose_kernel`` of
``repro.kernels.mp_matmul``, plus the fused kernel's partials epilogue,
which replaces no TPU kernel: the K-sharded backend's local step).

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
CUDA kernel (``csrc/mp_matmul.cu``; the Hopper tiles from
``csrc/mp_matmul_hopper.cu``) for CUDA tensors — there is no fallback from
one to the other.  The fused matmul and its partials epilogue, the fused
projection and the pre-limbed and mixed-lane matmuls each take one of their
routes by the operands' shape and layout (:func:`fused_route`,
:func:`proj_route`, :func:`prelimbed_route`; the both-prelimbed matmul by
its stacks' layout and format, :func:`both_route`), each with its own
launch counter (``routes``).
The plain versions repeat the kernels' accumulation discipline: one f32 sum
per limb-product order, joined by the compensated ``_combine_orders``
(highest order first), whatever the limb count.
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
DEC_M = 16    # most rows of the decode tile (csrc DEC_M)
# the fused matmul's routes: the cluster-split decode tile (M <= DEC_M), the
# TMA prefill tile (operands a tensor map reads), the strided prefill tile
SPLIT, TMA, STRIDED = "cluster", "tma", "strided"
ROUTES = (SPLIT, TMA, STRIDED)
# the fused projection's: the cluster-split decode tile (M <= DEC_M) and the
# TMA prefill tile (csrc/mp_matmul_hopper.cu), the strided prefill tile
PROJ_ROUTES = (SPLIT, TMA, STRIDED)
# the pre-limbed and mixed-lane matmuls': the cluster-split decode tile
# (csrc/mp_matmul_hopper.cu), the mma.sync prefill tile (csrc/mp_matmul.cu)
MMA = "mma"
PRELIMBED_ROUTES = (SPLIT, MMA)
# the both-prelimbed matmul's: the TMA + wgmma tile
# (csrc/mp_matmul_hopper.cu), the mma.sync tile (csrc/mp_matmul.cu)
BOTH_ROUTES = (TMA, MMA)
# the split kernels, by kind (mp_split_regs of csrc/mp_matmul_hopper.cu)
SPLIT_KINDS = {"fused": 0, "partials": 1, "prelimbed": 2, "proj": 3,
               "mixed": 4}

# the formats with instantiations of their own (n_limbs, max_order); the
# others run the generic one (csrc builtin_format)
_BUILTIN = ((1, 0), (2, 1), (3, 2), (5, 4), (7, 6))

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


def fused_matmul_partials_plain(a: torch.Tensor, b: torch.Tensor,
                                fmt: FormatLike) -> torch.Tensor:
    """Plain version of ``mp_fused_matmul_partials``: the (n_orders, M, N)
    stack of :func:`_order_sums` of a (M, K) @ b (K, N), uncombined."""
    s = resolve(fmt)
    al = limbs_lib.decompose(a, s.n_limbs)
    bl = limbs_lib.decompose(b, s.n_limbs)
    return torch.stack(_order_sums(al, bl, s))


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


def both_prelimbed_matmul_plain(al: torch.Tensor, bl: torch.Tensor,
                                fmt: FormatLike) -> torch.Tensor:
    """Plain version of ``mp_both_prelimbed_matmul``: the (M, K) operand
    whose (La, M, K) bf16 limb stack is ``al`` @ the (K, N) operand whose
    (Lb, K, N) stack is ``bl`` (missing limbs zero, extra limbs ignored).
    The per-order sums and their combine are :func:`fused_matmul_plain`'s,
    so on stacks decomposed from f32 operands the two agree bit for bit."""
    s = resolve(fmt)
    al = ref._limbs_of(limbs_lib.PrelimbedWeight(al), s.n_limbs)
    bl = ref._limbs_of(limbs_lib.PrelimbedWeight(bl), s.n_limbs)
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
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_fused_proj_launch.restype = ctypes.c_int
    lib.mp_prelimbed_matmul_launch.argtypes = [
        _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_prelimbed_matmul_launch.restype = ctypes.c_int
    lib.mp_mixed_prelimbed_matmul_launch.argtypes = [
        _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_mixed_prelimbed_matmul_launch.restype = ctypes.c_int
    lib.mp_both_prelimbed_matmul_launch.argtypes = [
        _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_both_prelimbed_matmul_launch.restype = ctypes.c_int
    lib.mp_fused_matmul_partials_launch.argtypes = [
        _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.mp_fused_matmul_partials_launch.restype = ctypes.c_int
    lib.mp_decompose_launch.argtypes = [_P, _P, _I, _I, _P]
    lib.mp_decompose_launch.restype = ctypes.c_int
    # the shared-memory mirrors' entries (an older library may lack them)
    if hasattr(lib, "mp_tile_smem_bytes"):
        for entry in ("mp_tile_e", "mp_tile_e_alt"):
            getattr(lib, entry).argtypes = [_I, _I, _I]
            getattr(lib, entry).restype = ctypes.c_int
        lib.mp_tile_smem_bytes.argtypes = [_I] * 5
        lib.mp_tile_smem_bytes.restype = ctypes.c_int64
        lib.mp_decode_smem_bytes.argtypes = [_I] * 6
        lib.mp_decode_smem_bytes.restype = ctypes.c_int64
        lib.mp_decode_ring_k.argtypes = [_I, _I]
        lib.mp_decode_ring_k.restype = ctypes.c_int
    lib._mp_matmul_typed = True


def _set_hopper_argtypes(lib) -> None:
    if getattr(lib, "_mp_hopper_typed", False):
        return
    lib.mp_hopper_matmul_launch.argtypes = [_P, _I, _I, _I, _I, _P, _I, _I,
                                            _I, _I, _P] + [_I] * 15 + [_P]
    lib.mp_hopper_matmul_launch.restype = ctypes.c_int
    # the projection's and the pre-limbed matmul's entries (a library built
    # from an older source lacks them; compare_kernels.py launches its
    # fused matmul only)
    if hasattr(lib, "mp_hopper_proj_launch"):
        lib.mp_hopper_proj_launch.argtypes = [
            _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
            _I, _I, _I, _I, _I, _I, _I, _P]
        lib.mp_hopper_proj_launch.restype = ctypes.c_int
        lib.mp_hopper_prelimbed_launch.argtypes = [
            _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.mp_hopper_prelimbed_launch.restype = ctypes.c_int
        lib.mp_tma_tile_n.argtypes = [_I, _I, _I]
        lib.mp_tma_tile_n.restype = ctypes.c_int
        lib.mp_tma_smem_bytes.argtypes = [_I, _I, _I]
        lib.mp_tma_smem_bytes.restype = ctypes.c_int64
        lib.mp_split_norm.argtypes = [_I, _I]
        lib.mp_split_norm.restype = ctypes.c_int
    # the split projection and mixed-lane matmul, and the plan's exports
    # with weights a block and registers (an older library lacks them)
    if hasattr(lib, "mp_hopper_mixed_prelimbed_launch"):
        lib.mp_hopper_proj_decode_launch.argtypes = [
            _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.mp_hopper_proj_decode_launch.restype = ctypes.c_int
        lib.mp_hopper_mixed_prelimbed_launch.argtypes = [
            _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            _I, _P]
        lib.mp_hopper_mixed_prelimbed_launch.restype = ctypes.c_int
        lib.mp_split_plan.argtypes = [_I] * 11 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.mp_split_plan.restype = ctypes.c_int
        lib.mp_split_dk.argtypes = [_I] * 8
        lib.mp_split_dk.restype = ctypes.c_int
        lib.mp_split_smem_bytes.argtypes = [_I] * 8
        lib.mp_split_smem_bytes.restype = ctypes.c_int64
        lib.mp_split_regs.argtypes = [_I] * 4
        lib.mp_split_regs.restype = ctypes.c_int
    # the both-prelimbed tile and its pins (an older library lacks them)
    if hasattr(lib, "mp_hopper_both_prelimbed_launch"):
        lib.mp_hopper_both_prelimbed_launch.argtypes = [
            _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.mp_hopper_both_prelimbed_launch.restype = ctypes.c_int
        lib.mp_both_tile.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.mp_both_tile.restype = ctypes.c_int
    lib._mp_hopper_typed = True


def _marshal(a: torch.Tensor, b: torch.Tensor):
    """The fused matmul's operands as a launch takes them: leading dims
    broadcast; at most two batch dims after merging, else the operands are
    copied to contiguous.  Returns (a, b, c, sizes, (sa, sb, sc))."""
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
    return a, b, c, sizes, (sa, sb, sc)


def _tma_operand(x: torch.Tensor, sizes, batch_strides) -> bool:
    """Can a TMA tensor map read ``x`` (``tma_operand`` of
    csrc/mp_matmul_hopper.cu): unit column stride, 16-byte aligned base and
    row and batch strides (a batch dim of size 1 excepted)."""
    def ok(st):
        return 0 < st < 2 ** 38 and st % 4 == 0
    return (x.data_ptr() % 16 == 0 and x.stride(-1) == 1 and ok(x.stride(-2))
            and all(n == 1 or ok(st) for n, st in zip(sizes, batch_strides)))


def fused_route(a: torch.Tensor, b: torch.Tensor, sizes, strides, *,
                parts_limbs: int = 0) -> str:
    """The route of a marshalled fused matmul (:func:`_marshal`): the
    cluster-split decode tile at M <= 16 rows, else the TMA prefill tile
    where a tensor map can read both operands (and K, M, N fit 31 bits),
    else the strided prefill tile of csrc/mp_matmul.cu.  The three give
    every output the same bits.  ``parts_limbs``: the limbs of a partials
    launch, whose prefill takes the TMA tile at one limb only (at more the
    strided tile measured faster, PERF.md)."""
    (M, K), N = a.shape[-2:], b.shape[-1]
    if M <= DEC_M:
        return SPLIT
    if parts_limbs > 1:
        return STRIDED
    if (0 < K < 2 ** 31 and M < 2 ** 31 and N < 2 ** 31
            and _tma_operand(a, sizes, strides[0])
            and _tma_operand(b, sizes, strides[1])):
        return TMA
    return STRIDED


def _lib(libs, name: str):
    """``libs[name]`` (another version's libraries, compare_kernels.py), or
    this tree's library, built at first use."""
    return libs[name] if libs is not None else build.load(name)


def launch_hopper_matmul(lib, stream: int, a, b, c, sizes, strides,
                         fmt: MPFormat, tune: Sequence[int] = (0, 0), *,
                         parts: bool = False) -> None:
    """Marshal one ``mp_hopper_matmul_launch`` call on operands
    :func:`_marshal` made (parts: c is the (n_orders, M, N) stack).
    ``tune``: the autotuner's ``(p0, p1)``, (0, 0) the plan's launch: at M
    <= 16 the k per ring stage and the cluster size; the prefill tile takes
    none."""
    _set_hopper_argtypes(lib)
    sa, sb, sc = strides
    M, K = a.shape[-2:]
    N = b.shape[-1]
    c_so = c.stride(0) if parts else 0
    err = lib.mp_hopper_matmul_launch(
        a.data_ptr(), sa[0], sa[1], a.stride(-2), a.stride(-1),
        b.data_ptr(), sb[0], sb[1], b.stride(-2), b.stride(-1),
        c.data_ptr(), sc[0], sc[1], c.stride(-2), c.stride(-1), c_so,
        int(parts), sizes[0], sizes[1], M, N, K, fmt.n_limbs, fmt.max_order,
        int(tune[0]), int(tune[1]), stream)
    build.check(err, "mp_hopper_matmul")


def launch_routed(stream: int, a: torch.Tensor, b: torch.Tensor,
                  fmt: MPFormat, tune: Optional[Sequence[int]] = None, *,
                  parts: bool = False, libs=None):
    """One fused matmul (parts: its partials stack, 2-D operands) by its
    route (:func:`fused_route`), on this tree's libraries (``libs``: a
    dict of another version's ``mp_matmul`` and ``mp_matmul_hopper``).
    ``tune`` (the autotuner's; None or (0, 0): the plan's launch) reaches
    the decode tile; the prefill tiles have no free parameter and raise on
    another.  Returns (output, route)."""
    if parts:
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"partials take 2-D a (M, K) @ b (K, N), got "
                             f"{tuple(a.shape)} @ {tuple(b.shape)}")
        a, b = _f32(a), _f32(b)
        sizes, strides = [1, 1], ([0, 0], [0, 0], [0, 0])
        c = torch.empty((fmt.n_orders, a.shape[0], b.shape[1]),
                        dtype=torch.float32, device=a.device)
    else:
        a, b, c, sizes, strides = _marshal(a, b)
    route = fused_route(a, b, sizes, strides,
                        parts_limbs=fmt.n_limbs if parts else 0)
    if route != SPLIT and tune is not None and tuple(tune) != (0, 0):
        raise ValueError(f"the {route} prefill tile takes no launch "
                         f"parameters, got {tuple(tune)}")
    if route == STRIDED:
        lib = _lib(libs, "mp_matmul")
        if parts:
            c = launch_fused_matmul_partials(lib, stream, a, b, fmt)
        else:
            c = launch_fused_matmul(lib, stream, a, b, fmt)
    else:
        launch_hopper_matmul(_lib(libs, "mp_matmul_hopper"), stream, a, b, c,
                             sizes, strides, fmt, tune or (0, 0),
                             parts=parts)
    return c, route


def launch_fused_matmul(lib, stream: int, a: torch.Tensor, b: torch.Tensor,
                        fmt: MPFormat) -> torch.Tensor:
    """Marshal one ``mp_fused_matmul_launch`` call: this tree's strided
    prefill tile (M > 16), or every shape of another, self-contained
    version of csrc/mp_matmul.cu (compare_kernels.py).  Leading dims
    broadcast (:func:`_marshal`)."""
    _set_argtypes(lib)
    a, b, c, sizes, (sa, sb, sc) = _marshal(a, b)
    M, K = a.shape[-2:]
    N = b.shape[-1]
    err = lib.mp_fused_matmul_launch(
        a.data_ptr(), sa[0], sa[1], a.stride(-2), a.stride(-1),
        b.data_ptr(), sb[0], sb[1], b.stride(-2), b.stride(-1),
        c.data_ptr(), sc[0], sc[1], c.stride(-2), c.stride(-1),
        sizes[0], sizes[1], M, N, K, fmt.n_limbs, fmt.max_order, stream)
    build.check(err, "mp_fused_matmul")
    return c


def launch_fused_matmul_partials(lib, stream: int, a: torch.Tensor,
                                 b: torch.Tensor, fmt: MPFormat
                                 ) -> torch.Tensor:
    """Marshal one ``mp_fused_matmul_partials_launch`` call: 2-D a (M, K)
    and b (K, N) read through their strides (a K-slice of a wider operand
    is a view, not a copy) -> the (n_orders, M, N) f32 stack."""
    _set_argtypes(lib)
    a, b = _f32(a), _f32(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"partials take 2-D a (M, K) @ b (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((fmt.n_orders, M, N), dtype=torch.float32,
                    device=a.device)
    err = lib.mp_fused_matmul_partials_launch(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), c.data_ptr(), c.stride(0), c.stride(1), c.stride(2),
        M, N, K, fmt.n_limbs, fmt.max_order, stream)
    build.check(err, "mp_fused_matmul_partials")
    return c


def _proj_operands(a: torch.Tensor, ws: Sequence[torch.Tensor], *,
                   gate: str, biases, residual):
    """Checked operands of a projection launch: a (M, K) and the n_out
    (K, N) weights contiguous f32, each weight from its own pointer (no
    stacked copy); the entries' argument list from ``a`` to K, ``out``,
    and the tensors the pointers point into (kept alive until the launch:
    a converted bias or residual is a new tensor)."""
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
    args = (a.data_ptr(), a.stride(0), *w_ptrs, N, *bias_ptrs, res_ptr,
            res_sr, out.data_ptr(), n_out, int(gate == "swiglu"), M, N, K)
    return a, ws, args, out, (biases, residual)


def proj_route(a: torch.Tensor, ws: Sequence[torch.Tensor]) -> str:
    """The route of a projection on its marshalled operands (contiguous
    f32, :func:`_proj_operands`): the cluster-split decode tile at M <= 16
    rows, else the TMA prefill tile where a tensor map reads ``a`` and
    every weight (rows of a multiple of 16 bytes, 16-byte aligned bases,
    sizes within 31 bits), else the strided prefill tile of
    csrc/mp_matmul.cu.  The three give every output the same bits."""
    (M, K), N = a.shape, ws[0].shape[1]
    if M <= DEC_M:
        return SPLIT
    if (0 < K < 2 ** 31 and M < 2 ** 31 and N < 2 ** 31
            and all(_tma_operand(x, (1, 1), (0, 0)) for x in (a, *ws))):
        return TMA
    return STRIDED


def launch_fused_proj(lib, stream: int, a: torch.Tensor,
                      ws: Sequence[torch.Tensor], fmt: MPFormat, *,
                      gate: str = "none", biases=None,
                      residual: Optional[torch.Tensor] = None,
                      tune: Sequence[int] = (0, 0)) -> torch.Tensor:
    """Marshal one ``mp_fused_proj_launch`` call (csrc/mp_matmul.cu: the
    strided prefill tile, M > 16; an older version of the source runs its
    decode tile there too): a (M, K); ws n_out equal (K, N) weights.
    ``tune``: the entry's ``(dec_dk, tile_e)`` (dec_dk 0 here; an older
    version's decode tile took its k per stage), (0, 0) the default
    launch."""
    _set_argtypes(lib)
    a, ws, args, out, _keep = _proj_operands(a, ws, gate=gate,
                                             biases=biases, residual=residual)
    err = lib.mp_fused_proj_launch(*args, fmt.n_limbs, fmt.max_order,
                                   int(tune[0]), int(tune[1]), stream)
    build.check(err, "mp_fused_proj")
    return out


def launch_proj_routed(stream: int, a: torch.Tensor,
                       ws: Sequence[torch.Tensor], fmt: MPFormat, *,
                       gate: str = "none", biases=None,
                       residual: Optional[torch.Tensor] = None,
                       tune: Optional[Sequence[int]] = None, libs=None):
    """One fused projection by its route (:func:`proj_route`), on this
    tree's libraries or ``libs`` (as :func:`launch_routed`).  ``tune``
    (the autotuner's; None or (0, 0): the default) reaches the split
    decode tile as ``(dk, S)`` and the strided tile as ``(0, E)``; the TMA
    tile has no free parameter and raises on another.  Returns (output,
    route)."""
    a, ws, args, out, _keep = _proj_operands(a, ws, gate=gate,
                                             biases=biases, residual=residual)
    route = proj_route(a, ws)
    tune = tuple(tune) if tune is not None else (0, 0)
    if route == SPLIT:
        lib = _lib(libs, "mp_matmul_hopper")
        _set_hopper_argtypes(lib)
        err = lib.mp_hopper_proj_decode_launch(
            *args, fmt.n_limbs, fmt.max_order, int(tune[0]), int(tune[1]),
            stream)
    elif route == STRIDED:
        lib = _lib(libs, "mp_matmul")
        _set_argtypes(lib)
        err = lib.mp_fused_proj_launch(*args, fmt.n_limbs, fmt.max_order,
                                       int(tune[0]), int(tune[1]), stream)
    else:
        if tune != (0, 0):
            raise ValueError(f"the {route} prefill tile takes no launch "
                             f"parameters, got {tune}")
        lib = _lib(libs, "mp_matmul_hopper")
        _set_hopper_argtypes(lib)
        err = lib.mp_hopper_proj_launch(*args, fmt.n_limbs, fmt.max_order,
                                        stream)
    build.check(err, "mp_fused_proj")
    return out, route


def _check_stack(limbs: torch.Tensor, what: str) -> None:
    if limbs.ndim != 3 or limbs.dtype != torch.bfloat16:
        raise ValueError(f"{what} must be an (L, rows, cols) bf16 limb stack, "
                         f"got {tuple(limbs.shape)} {limbs.dtype}")
    if limbs.stride(-1) != 1:
        raise ValueError(f"{what} needs unit column stride")


def _prelimbed_operands(a: torch.Tensor, limbs: torch.Tensor):
    """Checked operands of a pre-limbed launch: a (M, K) f32 with unit
    column stride, the (L, K, N) bf16 stack as it is, and the output."""
    a = _f32(a)
    if a.stride(-1) != 1:
        a = a.contiguous()
    _check_stack(limbs, "limb stack")
    M, K = a.shape
    L, K2, N = limbs.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ limb "
                         f"stack {tuple(limbs.shape)}")
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


def prelimbed_route(a: torch.Tensor) -> str:
    """The pre-limbed and mixed-lane matmuls' route: the cluster-split
    decode tile at M <= 16 rows (csrc/mp_matmul_hopper.cu), the mma.sync
    prefill tile above (csrc/mp_matmul.cu).  Both give every output the
    same bits (the pre-limbed matmul's the fused matmul's)."""
    return SPLIT if a.shape[0] <= DEC_M else MMA


def launch_prelimbed_routed(stream: int, a: torch.Tensor,
                            limbs: torch.Tensor, fmt: MPFormat,
                            tune: Optional[Sequence[int]] = None, *,
                            libs=None):
    """One pre-limbed matmul by its route (:func:`prelimbed_route`), on
    this tree's libraries or ``libs`` (as :func:`launch_routed`).
    ``tune``: the split tile's ``(dk, S)`` (None or (0, 0): the plan's,
    ``decode_plan(..., kind="prelimbed")``); the prefill tile takes none
    and raises on another.  Returns (output, route)."""
    route = prelimbed_route(a)
    tune = tuple(tune) if tune is not None else (0, 0)
    if route == MMA:
        if tune != (0, 0):
            raise ValueError(f"the {route} prefill tile takes no launch "
                             f"parameters, got {tune}")
        return launch_prelimbed_matmul(_lib(libs, "mp_matmul"), stream, a,
                                       limbs, fmt), route
    lib = _lib(libs, "mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    a, c = _prelimbed_operands(a, limbs)
    (M, K), (L, _, N) = a.shape, limbs.shape
    err = lib.mp_hopper_prelimbed_launch(
        a.data_ptr(), a.stride(0), limbs.data_ptr(), limbs.stride(0),
        limbs.stride(1), L, c.data_ptr(), c.stride(0), M, N, K,
        fmt.n_limbs, fmt.max_order, int(tune[0]), int(tune[1]), stream)
    build.check(err, "mp_prelimbed_matmul")
    return c, route


def launch_mixed_prelimbed_matmul(lib, stream: int, a: torch.Tensor,
                                  limbs: torch.Tensor, env: MPFormat,
                                  lane_n: torch.Tensor,
                                  lane_ord: torch.Tensor) -> torch.Tensor:
    """Marshal one ``mp_mixed_prelimbed_matmul_launch`` call (the mma.sync
    prefill tile, M > 16; an older version of the source runs its decode
    tile there too): as :func:`launch_prelimbed_matmul` at the envelope
    ``env``, plus the per-row lanes (M,) int32, read in place."""
    _set_argtypes(lib)
    a, c = _prelimbed_operands(a, limbs)
    (M, K), (L, _, N) = a.shape, limbs.shape
    _check_lanes(lane_n, lane_ord, M)
    err = lib.mp_mixed_prelimbed_matmul_launch(
        a.data_ptr(), a.stride(0), limbs.data_ptr(), limbs.stride(0),
        limbs.stride(1), L, lane_n.data_ptr(), lane_ord.data_ptr(),
        c.data_ptr(), c.stride(0), M, N, K, env.n_limbs, env.max_order,
        stream)
    build.check(err, "mp_mixed_prelimbed_matmul")
    return c


def _check_lanes(lane_n: torch.Tensor, lane_ord: torch.Tensor, M: int
                 ) -> None:
    for lane in (lane_n, lane_ord):
        if (lane.dtype != torch.int32 or lane.shape != (M,)
                or not lane.is_contiguous()):
            raise ValueError(f"lanes must be contiguous ({M},) int32, got "
                             f"{tuple(lane.shape)} {lane.dtype}")


def launch_mixed_routed(stream: int, a: torch.Tensor, limbs: torch.Tensor,
                        env: MPFormat, lane_n: torch.Tensor,
                        lane_ord: torch.Tensor,
                        tune: Optional[Sequence[int]] = None, *, libs=None):
    """One mixed-lane pre-limbed matmul by its route (the pre-limbed
    matmul's, :func:`prelimbed_route`), on this tree's libraries or
    ``libs`` (as :func:`launch_routed`).  ``tune``: the split tile's
    ``(dk, S)`` (None or (0, 0): the plan's); the prefill tile takes none
    and raises on another.  Returns (output, route)."""
    route = prelimbed_route(a)
    tune = tuple(tune) if tune is not None else (0, 0)
    if route == MMA:
        if tune != (0, 0):
            raise ValueError(f"the {route} prefill tile takes no launch "
                             f"parameters, got {tune}")
        return launch_mixed_prelimbed_matmul(
            _lib(libs, "mp_matmul"), stream, a, limbs, env, lane_n,
            lane_ord), route
    lib = _lib(libs, "mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    a, c = _prelimbed_operands(a, limbs)
    (M, K), (L, _, N) = a.shape, limbs.shape
    _check_lanes(lane_n, lane_ord, M)
    err = lib.mp_hopper_mixed_prelimbed_launch(
        a.data_ptr(), a.stride(0), limbs.data_ptr(), limbs.stride(0),
        limbs.stride(1), L, lane_n.data_ptr(), lane_ord.data_ptr(),
        c.data_ptr(), c.stride(0), M, N, K, env.n_limbs, env.max_order,
        int(tune[0]), int(tune[1]), stream)
    build.check(err, "mp_mixed_prelimbed_matmul")
    return c, route


def _both_operands(al: torch.Tensor, bl: torch.Tensor):
    """Checked stacks of a both-prelimbed launch, (La, M, K) and (Lb, K,
    N) bf16, read in place; the entries' argument list up to K and the
    output."""
    _check_stack(al, "A limb stack")
    _check_stack(bl, "B limb stack")
    (La, M, K), (Lb, K2, N) = al.shape, bl.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: limb stacks "
                         f"{tuple(al.shape)} @ {tuple(bl.shape)}")
    c = torch.empty((M, N), dtype=torch.float32, device=al.device)
    args = (al.data_ptr(), al.stride(0), al.stride(1), La, bl.data_ptr(),
            bl.stride(0), bl.stride(1), Lb, c.data_ptr(), c.stride(0), M, N,
            K)
    return args, c


def launch_both_prelimbed_matmul(lib, stream: int, al: torch.Tensor,
                                 bl: torch.Tensor, fmt: MPFormat
                                 ) -> torch.Tensor:
    """Marshal one ``mp_both_prelimbed_matmul_launch`` call (the mma.sync
    tile of csrc/mp_matmul.cu; every shape of an older version): the
    (La, M, K) and (Lb, K, N) bf16 limb stacks, read in place (planes the
    format does not need are never read)."""
    _set_argtypes(lib)
    args, c = _both_operands(al, bl)
    err = lib.mp_both_prelimbed_matmul_launch(*args, fmt.n_limbs,
                                              fmt.max_order, stream)
    build.check(err, "mp_both_prelimbed_matmul")
    return c


def _planes_mappable(x: torch.Tensor, n_used: int) -> bool:
    """Can a tensor map read the first ``n_used`` planes of the stack ``x``
    (``planes_mappable`` of csrc/mp_matmul_hopper.cu): a 16-byte aligned
    base, rows and (past one plane) the plane stride a multiple of 16
    bytes."""
    def ok(st):
        return 0 < st < 2 ** 39 and st % 8 == 0
    return (x.data_ptr() % 16 == 0 and ok(x.stride(1))
            and (n_used <= 1 or ok(x.stride(0))))


def both_route(al: torch.Tensor, bl: torch.Tensor, fmt: FormatLike) -> str:
    """The both-prelimbed matmul's route, from the stacks' layout and the
    format, before the launch: the TMA + wgmma tile of
    csrc/mp_matmul_hopper.cu for a built-in format whose used planes a
    tensor map reads (:func:`_planes_mappable`; K >= 1, sizes within 31
    bits), else the mma.sync tile of csrc/mp_matmul.cu (a run-time format,
    rows off 16 bytes, a misaligned base).  Both give every output the same
    bits."""
    fmt = resolve(fmt)
    (La, M, K), (Lb, _, N) = al.shape, bl.shape
    nl = fmt.n_limbs
    if ((nl, fmt.max_order) in _BUILTIN and 0 < K < 2 ** 31
            and M < 2 ** 31 and N < 2 ** 31
            and _planes_mappable(al, min(La, nl))
            and _planes_mappable(bl, min(Lb, nl))):
        return TMA
    return MMA


def launch_both_routed(stream: int, al: torch.Tensor, bl: torch.Tensor,
                       fmt: MPFormat, *, libs=None):
    """One both-prelimbed matmul by its route (:func:`both_route`), on this
    tree's libraries or ``libs`` (as :func:`launch_routed`).  Returns
    (output, route)."""
    route = both_route(al, bl, fmt)
    if route == MMA:
        return launch_both_prelimbed_matmul(_lib(libs, "mp_matmul"), stream,
                                            al, bl, fmt), route
    lib = _lib(libs, "mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    args, c = _both_operands(al, bl)
    err = lib.mp_hopper_both_prelimbed_launch(*args, fmt.n_limbs,
                                              fmt.max_order, stream)
    build.check(err, "mp_both_prelimbed_matmul")
    return c, route


def both_tile(fmt: FormatLike) -> Optional[dict]:
    """The both-prelimbed TMA tile's pins as the library exports them
    (``mp_both_tile``): rows, columns, ring stages, dynamic shared memory
    and each consumer warpgroup's orders; None where the format has no
    tile.  Builds the library (needs ``nvcc``: the machine
    with the card); ``autotune.both_tile`` mirrors it."""
    fmt = resolve(fmt)
    lib = build.load("mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    out = (_I * 6)()
    if lib.mp_both_tile(fmt.n_limbs, fmt.max_order, out) != 0:
        return None
    bm, bn, st, smem, m0, m1 = (int(v) for v in out)
    return dict(bm=bm, bn=bn, stages=st, smem=smem,
                orders=[[o for o in range(fmt.n_orders) if m >> o & 1]
                        for m in (m0, m1)])


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
# the device checks read ``is_cuda`` / ``get_device`` / ``is_cpu`` /
# ``is_meta``, not ``device``: every launch asks, and building a
# ``torch.device`` costs microseconds of host time on the decode path
def _cuda_stream(*tensors: torch.Tensor) -> int:
    idx = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != idx:
            raise ValueError(
                "CUDA kernel wrappers take tensors on one CUDA device, got "
                f"{[str(t.device) for t in tensors]}")
    return torch.cuda.current_stream(idx).cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    for t in tensors:
        if not t.is_cpu:
            return False
    return True


def _on_meta(*tensors: torch.Tensor) -> bool:
    """Meta tensors (the dry run's): a wrapper returns its output's shape
    and dtype on ``meta`` and neither launches nor runs a plain version."""
    for t in tensors:
        if t.is_meta:
            return True
    return False


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _row_major(x: torch.Tensor) -> torch.Tensor:
    """A 2-D operand stored column by column (a transposed view: the
    training backward's W^T and x^T) as a row-major copy.  The kernel reads
    any strides, but off unit column stride it copies one 4-byte element
    at a time; one pass of the copy costs less (on an H100,
    ``chip_smoke.py`` times both: the dgrad of ``lm_head`` takes 4.8 ms
    through the view, 2.5 ms with the copy).  Batched operands (decode
    attention's K^T) are read as they are."""
    if x.ndim == 2 and x.stride(-1) != 1 and x.stride(-2) == 1:
        return x.contiguous()
    return x


def mp_fused_matmul(a: torch.Tensor, b: torch.Tensor, fmt: FormatLike, *,
                    tune: Optional[Sequence[int]] = None) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) at ``fmt`` -> (..., M, N) f32, leading
    dims broadcast.  CPU tensors run :func:`fused_matmul_plain`; CUDA
    tensors launch the kernel (one launch, batch dims included; a
    column-major 2-D operand copied to row-major first, which moves no
    bit: the kernel's sums do not depend on the operands' strides), by the
    route :func:`fused_route` gives (counted in ``routes``).  ``tune``: the
    autotuner's launch parameters (:func:`launch_hopper_matmul`)."""
    fmt = resolve(fmt)
    if _on_meta(a, b):
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return _meta(tuple(lead) + (a.shape[-2], b.shape[-1]))
    if _on_cpu(a, b):
        mp_fused_matmul.plain_calls += 1
        return fused_matmul_plain(a, b, fmt)
    stream = _cuda_stream(a, b)
    out, route = launch_routed(stream, _row_major(a), _row_major(b), fmt,
                               tune)
    mp_fused_matmul.launches += 1
    mp_fused_matmul.routes[route] += 1
    return out


mp_fused_matmul.launches = 0      # kernel launches
mp_fused_matmul.routes = dict.fromkeys(ROUTES, 0)   # launches per route
mp_fused_matmul.plain_calls = 0   # CPU calls that ran the plain version


def mp_fused_matmul_partials(a: torch.Tensor, b: torch.Tensor,
                             fmt: FormatLike) -> torch.Tensor:
    """a (M, K) @ b (K, N) at ``fmt`` -> the (n_orders, M, N) f32 stack of
    per-order sums, uncombined: the K-sharded backend's local step, which
    ``ref.combine_partials`` joins after the cross-rank reduce.  CPU
    tensors run :func:`fused_matmul_partials_plain`; CUDA tensors launch
    the fused matmul's partials epilogue by its route (a column-major
    operand copied to row-major first, as :func:`mp_fused_matmul` does)."""
    fmt = resolve(fmt)
    if _on_meta(a, b):
        return _meta((fmt.n_orders, a.shape[0], b.shape[1]))
    if _on_cpu(a, b):
        mp_fused_matmul_partials.plain_calls += 1
        return fused_matmul_partials_plain(a, b, fmt)
    stream = _cuda_stream(a, b)
    out, route = launch_routed(stream, _row_major(a), _row_major(b), fmt,
                               parts=True)
    mp_fused_matmul_partials.launches += 1
    mp_fused_matmul_partials.routes[route] += 1
    return out


mp_fused_matmul_partials.launches = 0
mp_fused_matmul_partials.routes = dict.fromkeys(ROUTES, 0)
mp_fused_matmul_partials.plain_calls = 0


def mp_fused_proj(a: torch.Tensor, ws: Sequence[torch.Tensor],
                  fmt: FormatLike, *, gate: str = "none", biases=None,
                  residual: Optional[torch.Tensor] = None,
                  tune: Optional[Sequence[int]] = None) -> torch.Tensor:
    """a (M, K) against 1..3 equal-width (K, N) weights at ``fmt`` with the
    fused epilogue -> (n_out, M, N), or (M, N) when ``gate="swiglu"``.  CPU
    tensors run :func:`fused_proj_plain`; CUDA tensors launch the kernel
    by the route :func:`proj_route` gives (counted in ``routes``;
    ``tune``: the autotuner's ``(dec_dk, tile_e)``, None the default)."""
    fmt = resolve(fmt)
    extra: Tuple[torch.Tensor, ...] = tuple(biases or ()) + (
        (residual,) if residual is not None else ())
    if _on_meta(a, *ws, *extra):
        M, N = a.shape[0], ws[0].shape[1]
        return _meta((M, N) if gate != "none" else (len(ws), M, N))
    if _on_cpu(a, *ws, *extra):
        mp_fused_proj.plain_calls += 1
        return fused_proj_plain(a, ws, fmt, gate=gate, biases=biases,
                                residual=residual)
    stream = _cuda_stream(a, *ws, *extra)
    out, route = launch_proj_routed(stream, a, ws, fmt, gate=gate,
                                    biases=biases, residual=residual,
                                    tune=tune)
    mp_fused_proj.launches += 1
    mp_fused_proj.routes[route] += 1
    return out


mp_fused_proj.launches = 0
mp_fused_proj.routes = dict.fromkeys(PROJ_ROUTES, 0)
mp_fused_proj.plain_calls = 0


def mp_prelimbed_matmul(a: torch.Tensor, limbs: torch.Tensor,
                        fmt: FormatLike) -> torch.Tensor:
    """a (M, K) f32 @ a (K, N) weight given as its (L, K, N) bf16 limb
    stack, at ``fmt`` -> (M, N) f32.  Limbs the stack lacks are zero, limbs
    past the format's are ignored.  CPU tensors run
    :func:`prelimbed_matmul_plain`; CUDA tensors launch the kernel by the
    route :func:`prelimbed_route` gives (counted in ``routes``)."""
    fmt = resolve(fmt)
    if _on_meta(a, limbs):
        return _meta((a.shape[0], limbs.shape[-1]))
    if _on_cpu(a, limbs):
        mp_prelimbed_matmul.plain_calls += 1
        return prelimbed_matmul_plain(a, limbs, fmt)
    stream = _cuda_stream(a, limbs)
    out, route = launch_prelimbed_routed(stream, a, limbs, fmt)
    mp_prelimbed_matmul.launches += 1
    mp_prelimbed_matmul.routes[route] += 1
    return out


mp_prelimbed_matmul.launches = 0
mp_prelimbed_matmul.routes = dict.fromkeys(PRELIMBED_ROUTES, 0)
mp_prelimbed_matmul.plain_calls = 0


def mp_mixed_prelimbed_matmul(a: torch.Tensor, limbs: torch.Tensor,
                              env: FormatLike, lane_n: torch.Tensor,
                              lane_ord: torch.Tensor) -> torch.Tensor:
    """a (M, K) f32 @ a (K, N) weight given as its (L, K, N) bf16 limb
    stack, row m at its own lane format (``lane_n[m]`` limbs, order cut
    ``lane_ord[m]``, (M,) int32 each) at or below the envelope ``env`` ->
    (M, N) f32.  A row equals :func:`mp_prelimbed_matmul`'s row at the
    lane's format bit for bit.  CPU tensors run
    :func:`mixed_prelimbed_matmul_plain`; CUDA tensors launch the kernel by
    the route :func:`prelimbed_route` gives (counted in ``routes``)."""
    env = resolve(env)
    if _on_meta(a, limbs, lane_n, lane_ord):
        return _meta((a.shape[0], limbs.shape[-1]))
    if _on_cpu(a, limbs, lane_n, lane_ord):
        mp_mixed_prelimbed_matmul.plain_calls += 1
        return mixed_prelimbed_matmul_plain(a, limbs, env, lane_n, lane_ord)
    stream = _cuda_stream(a, limbs, lane_n, lane_ord)
    out, route = launch_mixed_routed(stream, a, limbs, env, lane_n, lane_ord)
    mp_mixed_prelimbed_matmul.launches += 1
    mp_mixed_prelimbed_matmul.routes[route] += 1
    return out


mp_mixed_prelimbed_matmul.launches = 0
mp_mixed_prelimbed_matmul.routes = dict.fromkeys(PRELIMBED_ROUTES, 0)
mp_mixed_prelimbed_matmul.plain_calls = 0


def mp_both_prelimbed_matmul(al: torch.Tensor, bl: torch.Tensor,
                             fmt: FormatLike) -> torch.Tensor:
    """(M, K) @ (K, N) at ``fmt`` -> (M, N) f32, both operands given as
    their bf16 limb stacks, (La, M, K) and (Lb, K, N): the DD operand path
    (modes 5 and 6 on operands wider than f32).  Limbs a stack lacks are
    zero, limbs past the format's are ignored.  CPU tensors run
    :func:`both_prelimbed_matmul_plain`; CUDA tensors launch the kernel by
    the route :func:`both_route` gives (counted in ``routes``)."""
    fmt = resolve(fmt)
    if _on_meta(al, bl):
        return _meta((al.shape[1], bl.shape[2]))
    if _on_cpu(al, bl):
        mp_both_prelimbed_matmul.plain_calls += 1
        return both_prelimbed_matmul_plain(al, bl, fmt)
    stream = _cuda_stream(al, bl)
    out, route = launch_both_routed(stream, al, bl, fmt)
    mp_both_prelimbed_matmul.launches += 1
    mp_both_prelimbed_matmul.routes[route] += 1
    return out


mp_both_prelimbed_matmul.launches = 0
mp_both_prelimbed_matmul.routes = dict.fromkeys(BOTH_ROUTES, 0)
mp_both_prelimbed_matmul.plain_calls = 0


def mp_decompose(w: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """(..., C) f32 -> (n_limbs, ..., C) bf16 limb stack (the RNE cascade,
    bitwise ``limbs.decompose``).  CPU tensors run
    :func:`decompose_plain`; CUDA tensors launch the kernel."""
    from repro_torch.analysis import accounting

    accounting.record_decompose(w, n_limbs)
    if _on_meta(w):
        return _meta((n_limbs,) + tuple(w.shape), torch.bfloat16)
    if _on_cpu(w):
        mp_decompose.plain_calls += 1
        return decompose_plain(w, n_limbs)
    stream = _cuda_stream(w)
    out = launch_decompose(build.load("mp_matmul"), stream, w, n_limbs)
    mp_decompose.launches += 1
    return out


mp_decompose.launches = 0
mp_decompose.plain_calls = 0


def split_regs(kind: str, fmt: FormatLike, nout: int = 1) -> int:
    """Registers a thread of the split kernel of ``kind`` (a key of
    :data:`SPLIT_KINDS`; the projection's at ``nout`` weights a block) at
    ``fmt``'s instantiation, as the card reads them (``mp_split_regs``).
    Builds the library (needs ``nvcc``: the machine with the card)."""
    fmt = resolve(fmt)
    lib = build.load("mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    return int(lib.mp_split_regs(SPLIT_KINDS[kind], nout, fmt.n_limbs,
                                 fmt.max_order))


def decode_plan(M: int, N: int, K: int, fmt: FormatLike, batch: int = 1,
                *, kind: str = "fused", n_out: int = 1, gate: bool = False
                ) -> Tuple[int, int]:
    """The split decode tile's default launch for an (M <= 16, K, N) matmul
    of ``kind`` (:data:`SPLIT_KINDS`: "prelimbed" and "mixed" read stored
    bf16 planes; "proj" is the projection of ``n_out`` weights, gated or
    not: both weights a block gated, else one a block) on this card
    (``mp_split_plan`` of ``csrc/mp_matmul_hopper.cu`` on the kernel's
    registers): the cluster size S that splits K's chunks and the k per
    ring stage (0: the single-block tile's own choice at S = 1).  Builds
    the library (needs ``nvcc``: the machine with the card)."""
    fmt = resolve(fmt)
    lib = build.load("mp_matmul_hopper")
    _set_hopper_argtypes(lib)
    props = torch.cuda.get_device_properties(0)
    nout, ny = (2, 1) if gate else (1, n_out) if kind == "proj" else (1, 1)
    dk = ctypes.c_int(0)
    S = lib.mp_split_plan(
        int(kind in ("prelimbed", "mixed")), -(-N // 16) * ny * batch, K,
        fmt.n_limbs, fmt.max_order, M, nout, split_regs(kind, fmt, nout),
        props.multi_processor_count, props.shared_memory_per_multiprocessor,
        props.shared_memory_per_block_optin, ctypes.byref(dk))
    return int(S), int(dk.value)


def chunk_k() -> int:
    """The K of one chunk of the CUDA kernels (``KC`` in
    ``csrc/mp_matmul.cu``): each limb product is one tensor-core chain over
    this many k, and the chains are summed by f32 adds.  Builds the library
    (needs ``nvcc``: the machine with the card)."""
    lib = build.load("mp_matmul")
    lib.mp_chunk_k.restype = ctypes.c_int
    return int(lib.mp_chunk_k())
