"""Autotuner over the CUDA kernels' bit-neutral launch parameters (port of
``repro.kernels.autotune``, which sweeps the Pallas kernels' block sizes).

The order contract (``csrc/mp_matmul.cu``'s header) fixes every add of
every output: K runs in chunks of KC from k = 0, one f32 sum per order.
What is left free moves work between stages and blocks, never an add, so a
launch at any of these parameters gives the default launch's bits:

  * the fused matmul's decode tile (M <= 16 rows, csrc/mp_matmul_hopper.cu):
    ``[dk, S]``, the k of one ring stage (a multiple of KC up to the ring's
    most: 256 for the built-in formats up to three limbs, 128 for deeper
    ones) and the cluster size S that splits K's chunks (1..8, each rank
    at least one chunk);
  * its prefill tiles (M > 16, TMA or strided) have no free parameter:
    their keys hold the default, ``[0, 0]``, timed alone;
  * the fused projection: ``[dk, S]`` at its decode tile, split over a
    cluster as the fused matmul's (csrc/mp_matmul_hopper.cu); none at its
    TMA prefill tile
    (csrc/mp_matmul_hopper.cu: the shapes a tensor map reads, rows of a
    multiple of 16 bytes), whose keys hold ``[0, 0]``; ``[0, E]`` at its
    strided prefill tile (the other shapes), E the outputs per thread,
    the tile's default (where ptxas stopped spilling) or half of it, for
    the built-in formats (the library instantiates both);
  * flash attention: ``[block_q]``, the query rows per block (16, 32, 64).

``[0, 0]`` is a matmul's default launch (the plan's choice), an attention
entry's default is the kernel's own ``block_q``; a launch at its default
passes zeros to the launch entry and makes no other call.  The feasibility
filter plays the part of the JAX package's VMEM budget: a candidate's
dynamic shared memory, by the kernels' own formulas (mirrored here, and
exported by the libraries as ``mp_split_smem_bytes``,
``mp_tma_smem_bytes``, ``mp_tile_smem_bytes``, ``mp_decode_smem_bytes``
and ``mp_flash_smem_bytes``), must fit the card's opt-in limit, and an
instantiation of its own (the projection's E / 2) must build without a
spill (``build.ptxas_summary``).

A sweep first holds each candidate's output bitwise against the default
launch's (a difference raises: it is a kernel fault, not a slower
candidate), then times the default and the candidates in turn on the
port's device timer (``kernels/timing.py``: calls queued behind a sleep
kernel, so the card's time and not the host's), ``iters`` rounds, and
keeps the fastest of all of them, the default among them, by its median,
as the JAX package's sweep keeps the fastest of its candidates.  Winners
persist in one JSON table per card, keyed by
``torch.cuda.get_device_name()`` (spaces and slashes replaced), under
``REPRO_AUTOTUNE_CACHE_DIR`` or ``~/.cache/repro_torch/autotune/``;
tables are written atomically (tmp file, then rename).  The file name
carries the entries' layout (``TABLE_LAYOUT``), so a table written for
other kernels' parameters is never read.  Sweeps run only
when the context's switch is on (``mp.configure(autotune=True)`` or
``REPRO_MP_AUTOTUNE=1``); :func:`lookup` never sweeps, and a miss keeps
today's launch choice (dispatch skips the lookup while the table is empty
and the switch off, so an untuned process pays nothing for it).
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import FormatLike, MPFormat, resolve

MatmulParams = Tuple[int, int]   # (p0, p1); (0, 0) = the default launch
AttnParams = Tuple[int]          # (block_q,)
# the layout of a table's entries, in its file name: 4 = the decode tiles'
# (dk, S), the projection's among them, the TMA tiles' (0, 0); 3 had the
# projection's decode (dk, 0) on its single-block tile; 2 the projection's
# prefill E; 1 (no tag) the old tiles' (dk, E)
TABLE_LAYOUT = 4

# csrc/mp_matmul.cu
KC = 64
PADE = 8
SMEM_MAX = 232448
WGM, WGN = 2, 4
DEC_M = 16
GEN_NL = 8
GEN_NO = 2 * GEN_NL - 1
DEC_SLOTS = 3
DEC_N = 16
BUILTIN = ((1, 0), (2, 1), (3, 2), (5, 4), (7, 6))
# csrc/mp_matmul_hopper.cu
HM = 128          # rows of the TMA tile
HALIGN = 1024     # the swizzle's alignment (slack in the shared memory)
SPLIT_MAX = 8     # the portable cluster size
DEC_CT = 64       # the decode tile's compute threads
DEC_TMA_SLACK = 64 + 1024   # the pre-limbed split tile's TMA ring: mbarriers
                            # and the 1024-byte alignment
H100_SMS = 132
H100_SM_SMEM = 233472   # shared memory of one H100 SM
# csrc/mp_attention.cu
BKV, WR = 32, 16
PTS, PFS = WR + 4, BKV + 4
FLASH_BLOCK_QS = (16, 32, 64)

_memory_table: Dict[str, Dict[str, List[int]]] = {}
_STATS = {"sweeps": 0, "lookups": 0, "hits": 0}
_HIT_KEYS: set = set()


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------
@functools.cache
def device_kind() -> str:
    """The card's name with spaces and slashes replaced ("cpu" without
    one), e.g. ``NVIDIA_H100_80GB_HBM3``; read once per process (every
    dispatch on the card looks a key up)."""
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    return name.replace(" ", "_").replace("/", "_")


def cache_dir() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune"))


def _cache_path(kind: Optional[str] = None) -> str:
    return os.path.join(cache_dir(),
                        f"{kind or device_kind()}.v{TABLE_LAYOUT}.json")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def epilogue_desc(gate: str = "none", has_bias: bool = False,
                  has_residual: bool = False) -> str:
    """The epilogue's key string ("none", "bias", "swiglu+bias+res", ...),
    the JAX package's ``kernels.mp_matmul.epilogue_desc``."""
    parts = [gate] if gate != "none" else []
    if has_bias:
        parts.append("bias")
    if has_residual:
        parts.append("res")
    return "+".join(parts) if parts else "none"


def table_key(M: int, K: int, N: int, mode: FormatLike, dtype, *,
              n_out: int = 1, epilogue: str = "none") -> str:
    """Cache key, the JAX package's string: the resolved format name, the
    folded shape and the operand dtype, plus ``|out{n}|{epilogue}`` for a
    fused projection that is not one plain output."""
    base = f"{resolve(mode).name}|{M}x{K}x{N}|{_dtype_name(dtype)}"
    if n_out != 1 or epilogue != "none":
        base += f"|out{n_out}|{epilogue}"
    return base


def attention_table_key(B_H: int, S: int, T: int, Dh: int,
                        mode_qk: FormatLike, mode_pv: FormatLike, *,
                        causal: bool, paged: bool = False) -> str:
    """Cache key of one attention cell (the JAX package's string): both
    format names, the folded batch x heads / sequence / head-dim shape and
    the causal / paged bits.  No sweep writes ``paged=True`` entries."""
    return (f"attn|{resolve(mode_qk).name}/{resolve(mode_pv).name}"
            f"|{B_H}x{S}x{T}x{Dh}|c{int(bool(causal))}|p{int(bool(paged))}")


def load_table(kind: Optional[str] = None) -> Dict[str, List[int]]:
    kind = kind or device_kind()
    if kind not in _memory_table:
        try:
            with open(_cache_path(kind)) as f:
                _memory_table[kind] = {
                    k: list(map(int, v)) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            _memory_table[kind] = {}
    return _memory_table[kind]


def save_table(table: Dict[str, List[int]], kind: Optional[str] = None
               ) -> str:
    """Atomic write (tmp + rename): concurrent processes never see a torn
    table, last writer wins."""
    path = _cache_path(kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def clear_memory_cache() -> None:
    """Drop the in-process table cache (tests re-point the cache dir)."""
    _memory_table.clear()


def stats() -> dict:
    """Sweeps run, lookups made and hits, and the keys hit, since
    :func:`reset_stats`."""
    return {**_STATS, "hit_keys": sorted(_HIT_KEYS)}


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0
    _HIT_KEYS.clear()


def _get(key: str) -> Optional[List[int]]:
    _STATS["lookups"] += 1
    entry = load_table().get(key)
    if entry is not None:
        _STATS["hits"] += 1
        _HIT_KEYS.add(key)
    return entry


# ---------------------------------------------------------------------------
# the kernels' shared-memory formulas (mirrors of csrc)
# ---------------------------------------------------------------------------
def _builtin(fmt: MPFormat) -> bool:
    return (fmt.n_limbs, fmt.max_order) in BUILTIN


def tile_e(nl: int, no: int, nout: int) -> int:
    """``tile_e``: the prefill tile's outputs per thread."""
    c = nout * no + (1 if nl == 1 else 3 if nl == 2 else 2)
    budget = 144 if nl >= 3 else 160 if nout == 1 else 128
    for e in (64, 32, 16, 8):
        if c * e <= budget:
            return e
    return 4


def format_tile_e(fmt: FormatLike, n_out: int = 1) -> int:
    """``mp_tile_e``: the default E of the instantiation ``fmt`` runs."""
    fmt = resolve(fmt)
    if _builtin(fmt):
        return tile_e(fmt.n_limbs, fmt.n_orders, n_out)
    return tile_e(GEN_NL, GEN_NO, n_out)


def format_tile_e_alt(fmt: FormatLike, n_out: int = 1) -> int:
    """``mp_tile_e_alt``: the other E the library builds (0: none)."""
    fmt = resolve(fmt)
    e = format_tile_e(fmt, n_out)
    return e // 2 if _builtin(fmt) and e >= 8 else 0


def _tile_wm(e: int) -> int:
    return 64 if e == 64 else 32 if e >= 16 else 16


def tile_smem(nl: int, nout: int, e: int, pl: bool = False,
              pla: bool = False) -> int:
    """``tile_smem`` / ``Tile::smem``: one prefill-tile block's dynamic
    shared memory."""
    bm = WGM * _tile_wm(e)
    bn = WGN * (e * 32 // _tile_wm(e))
    raw = (0 if pla else bm * KC * 4) + (0 if pl else nout * KC * bn * 4)
    planes = nl * bm * (KC + PADE) * 2 + nout * nl * KC * (bn + PADE) * 2
    npb = 2 if not pl and not pla and raw + 2 * planes <= SMEM_MAX else 1
    rs = 2 if 2 * raw + npb * planes <= SMEM_MAX else 1
    return rs * raw + npb * planes


def _nl_no(fmt: MPFormat) -> Tuple[int, int]:
    """(limbs, orders) of the instantiation ``fmt`` runs."""
    return (fmt.n_limbs, fmt.n_orders) if _builtin(fmt) else (GEN_NL, GEN_NO)


def tma_tile_n(fmt: FormatLike, nout: int = 1) -> int:
    """``hp_bn``: the TMA prefill tile's columns for ``fmt`` at ``nout``
    weights a block (96 at M8; the projection's gated block holds 2)."""
    no = nout * _nl_no(resolve(fmt))[1]
    return 96 if no == 1 else 64 if no == 2 else 48 if no == 3 \
        else 32 if no <= 5 else 24 if no <= 7 else 8


def _tma_plane_b(bn: int) -> int:
    """``hp_plane_b``: one B plane, N-major in 64-column atoms of 8 KB at 64
    columns or more, else K-major."""
    return -(-bn // 64) * 64 * KC * 2 if bn >= 64 else bn * KC * 2


def _tma_planes(nl: int, bn: int, nout: int = 1) -> int:
    return nl * (HM * KC * 2 + nout * _tma_plane_b(bn))


def _tma_stage(bn: int, nout: int = 1) -> int:
    return (HM + nout * bn) * KC * 4


def tma_smem(fmt: FormatLike, nout: int = 1) -> int:
    """``mp_tma_smem_bytes``: one TMA-tile block's dynamic shared memory at
    ``nout`` weights a block (``hp_smem`` at ``hp_rs``): one or two plane
    buffers, whichever fits with two f32 stages; three f32 stages where
    they fit, else two; four mbarriers."""
    fmt = resolve(fmt)
    nl, bn = _nl_no(fmt)[0], tma_tile_n(fmt, nout)
    planes, stage = _tma_planes(nl, bn, nout), _tma_stage(bn, nout)
    npb = 2 if HALIGN + 2 * planes + 2 * stage + 64 <= SMEM_MAX else 1
    three = HALIGN + npb * planes + 3 * stage + 8 * 4
    return three if three <= SMEM_MAX else three - stage


def both_tile(fmt: FormatLike) -> Optional[dict]:
    """``mp_both_tile``: the both-prelimbed TMA tile's pins at a built-in
    format, None for a run-time format (which keeps the mma.sync tile).
    Rows, columns, ring stages (as many 4-at-most as fit), dynamic shared
    memory (the swizzle's slack, the ring, the mbarriers) and each consumer
    warpgroup's orders.  M36 and M52 split their orders, which fill two
    warpgroups, over 64 rows: warpgroup 1 takes M52's {3, 4, 5} (15
    products) and warpgroup 0 {0, 1, 2, 6} (13), M36's {2, 3} (7) and {0,
    1, 4} (8).  The others split rows: each warpgroup 64 rows and every
    order."""
    fmt = resolve(fmt)
    nl, no = fmt.n_limbs, fmt.n_orders
    if (nl, fmt.max_order) not in BUILTIN:
        return None
    os_ = no in (5, 7)
    bm = 64 if os_ else 128
    bn = 48 if no == 7 else 128 if no == 1 else 64
    stage = nl * (bm * KC * 2 + -(-bn // 64) * 64 * KC * 2)
    stages = min(4, (SMEM_MAX - HALIGN - 64) // stage)
    if os_:
        lo, hi = (3, 5) if no == 7 else (2, 3)
        orders = [[o for o in range(no) if not lo <= o <= hi],
                  list(range(lo, hi + 1))]
    else:
        orders = [list(range(no))] * 2
    return dict(bm=bm, bn=bn, stages=stages,
                smem=HALIGN + stages * stage + 64, orders=orders)


def split_norm(K: int, s: int) -> int:
    """``split_norm``: cluster size s as the split tile runs it, every rank
    at least one chunk (S = ceil(chunks / ceil(chunks / s)))."""
    nch = -(-K // KC)
    if nch <= 1 or s <= 1:
        return 1
    s = min(s, nch)
    cpr = -(-nch // s)
    return -(-nch // cpr)


def split_smem(fmt: FormatLike, M: int, kr: int, dk: int, cpr: int,
               pl: bool = False, nout: int = 1) -> int:
    """``split_smem_bytes``: one split-tile block's dynamic shared memory:
    the decode tile's for a K range of ``kr`` at ``dk`` k per stage and
    ``nout`` weights a block (``pl``: on stored planes, their bf16 ring and
    the TMA ring's slack), 16-aligned, then the chunk sums of ``cpr``
    chunks of each weight."""
    fmt = resolve(fmt)
    slots = min(DEC_SLOTS, -(-kr // dk))
    base = dec_smem_bytes(pl, fmt.n_limbs, M, dk, slots, nout) + (
        DEC_TMA_SLACK if pl else 0)
    return -(-base // 16) * 16 + \
        cpr * nout * _nl_no(fmt)[1] * DEC_M * DEC_N * 4


def split_dk(fmt: FormatLike, M: int, kr: int, cpr: int,
             optin: int = SMEM_MAX, pl: bool = False, nout: int = 1) -> int:
    """``split_dk``: the split tile's k per stage for a rank's K range: the
    ring's most, or the range rounded up to KC when shorter, halved in
    multiples of KC until the block fits ``optin`` bytes."""
    ring = decode_ring_k(fmt)
    dk = -(-kr // KC) * KC if kr < ring else ring
    while dk > KC and split_smem(fmt, M, kr, dk, cpr, pl, nout) > optin:
        dk = -(-(dk // 2) // KC) * KC
    return dk


def split_per_sm(pl: bool = False, regs: int = 64) -> int:
    """``split_per_sm``: split-tile blocks an SM holds by registers at
    ``regs`` a thread (the kernel's, at least 64, in steps of 8): at 64, 5
    of the f32 weights' 192 threads, 8 of the stored planes' 128."""
    r = 64 if regs < 64 else -(-regs // 8) * 8
    return 65536 // ((DEC_CT + 32 * (2 if pl else 4)) * r)


def split_plan(slabs: int, K: int, fmt: FormatLike = "M8", M: int = 8,
               sms: int = H100_SMS, sm_smem: int = H100_SM_SMEM,
               optin: int = SMEM_MAX, pl: bool = False, nout: int = 1,
               regs: int = 64) -> Tuple[int, int]:
    """``split_plan``: the decode tile's default (cluster size, k per stage)
    for ``slabs`` 16-column slabs (times grid.y and the batch) of a split
    kernel (``pl``: on stored planes, the pre-limbed and mixed-lane
    matmuls'; ``nout`` weights a block, the projection's gated block two;
    ``regs`` the kernel's registers a thread): the largest S <= 8, as the
    tile runs it, whose blocks all fit on the card at once at
    :func:`split_dk`'s stage or a shorter one (blocks per SM by shared
    memory, at most :func:`split_per_sm`) and, on f32 weights, with fewer
    stages a rank than the single block runs (:func:`dec_stage_k`) where
    that one runs more than one; (1, 0) where none does (lm_head's 2,000
    slabs: the single-block tile at its own stage)."""
    nch = -(-K // KC)
    d1 = dec_stage_k(fmt, M, K, nout, slabs, pl, sms, sm_smem, optin)
    st1 = 0 if pl else -(-K // d1)
    for s in range(SPLIT_MAX, 1, -1):
        if split_norm(K, s) != s:
            continue
        cpr = -(-nch // s)
        kr = cpr * KC
        dk = split_dk(fmt, M, kr, cpr, optin, pl, nout)
        while True:
            if st1 > 1 and -(-kr // dk) >= st1:
                break
            smem = split_smem(fmt, M, kr, dk, cpr, pl, nout)
            per_sm = min(sm_smem // (smem + 1024), split_per_sm(pl, regs))
            if smem <= optin and s * slabs <= per_sm * sms:
                return s, dk
            if dk <= KC:
                break
            dk = -(-(dk // 2) // KC) * KC
    return 1, 0


def dec_stage_k(fmt: FormatLike, M: int, K: int, nout: int, blocks: int,
                pl: bool = False, sms: int = H100_SMS,
                sm_smem: int = H100_SM_SMEM, optin: int = SMEM_MAX) -> int:
    """``dec_stage_k``: the single-block decode tile's k per stage for
    ``blocks`` blocks of ``nout`` weights: the ring's most (K rounded up to
    KC when shorter), halved in multiples of KC until the block fits
    ``optin`` bytes and, with more blocks than SMs, two fit on one SM."""
    fmt = resolve(fmt)

    def smem(dk):
        return dec_smem_bytes(pl, fmt.n_limbs, M, dk,
                              min(DEC_SLOTS, -(-K // dk)), nout)
    ring = decode_ring_k(fmt)
    dk = -(-K // KC) * KC if K < ring else ring
    while dk > KC and smem(dk) > optin:
        dk = -(-(dk // 2) // KC) * KC
    if blocks > sms:
        while dk > KC and 2 * (smem(dk) + 1024) > sm_smem:
            dk = -(-(dk // 2) // KC) * KC
    return dk


def decode_ring_k(fmt: FormatLike) -> int:
    """``DecRing<NL>::K`` of the instantiation ``fmt`` runs."""
    fmt = resolve(fmt)
    return 256 if _builtin(fmt) and fmt.n_limbs <= 3 else 128


def dec_smem_bytes(pl: bool, nl: int, M: int, dk: int, slots: int,
                   nout: int) -> int:
    """``dec_smem_bytes``: one decode-tile block's dynamic shared memory."""
    ring_b = slots * nl * dk * 16 * 2 if pl else nout * slots * dk * 16 * 4
    return (ring_b + slots * M * dk * 4 + 2 * nl * M * (dk + PADE) * 2
            + (0 if pl else 2 * nout * nl * dk * 16 * 2) + 16)


def _padded_d(Dh: int) -> int:
    for d in (16, 32, 64, 128):
        if Dh <= d:
            return d
    return 192


def flash_smem(Dh: int, bq: int, fmt_qk: FormatLike, fmt_pv: FormatLike
               ) -> int:
    """``mp_flash_smem_bytes``: one flash block's dynamic shared memory."""
    fq, fp = resolve(fmt_qk), resolve(fmt_pv)
    D = _padded_d(Dh)
    serving = [1 <= f.n_limbs <= 3 and f.max_order == f.n_limbs - 1
               for f in (fq, fp)]
    sq = sp = 4 if D == 64 and all(serving) else 2
    dv = max(D, 32)
    p_limbs = fp.n_limbs * BKV * PTS * sp
    p_f32 = WR * PFS * 4
    o = 2 * BKV * (D + 4) * 4 + fq.n_limbs * D * BKV * sq \
        + fp.n_limbs * BKV * dv * sp
    per_warp = fq.n_limbs * D * WR * sq + max(p_limbs, p_f32)
    return o + (bq // WR) * per_warp


def smem_limit() -> int:
    """The card's opt-in shared memory per block (:data:`SMEM_MAX` without
    a card)."""
    if not torch.cuda.is_available():
        return SMEM_MAX
    props = torch.cuda.get_device_properties(0)
    return int(getattr(props, "shared_memory_per_block_optin", SMEM_MAX))


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------
def _entry_spills(summary: Dict[str, List[int]], kernel: str,
                  targs: Sequence) -> Optional[List[int]]:
    """[registers, spill stores, spill loads] of the instantiation
    ``kernel<targs...>`` in a ``build.ptxas_summary`` (None: not built).
    Template arguments mangle as ``Li<int>E`` / ``Lb<0|1>E``."""
    enc = "".join(f"Lb{int(a)}E" if isinstance(a, bool) else f"Li{a}E"
                  for a in targs)
    # the summary's key lost, with nvcc's file tag, the name's length and
    # its leading hex letters ("fused_..." keys as "used_...")
    want = f"{kernel.lstrip('abcdef')}I{enc}E"
    for entry, regs in summary.items():
        if want in entry:
            return regs
    return None


def _tile_builds(fmt: MPFormat, n_out: int, e: int,
                 summary: Optional[Dict[str, List[int]]]) -> bool:
    """Does the projection's prefill instantiation at E build without a
    spill?"""
    if summary is None:
        return True
    nl, no = _nl_no(fmt)
    regs = _entry_spills(summary, "fused_proj_kernel",
                         (nl, no, n_out, not _builtin(fmt), e))
    return regs is not None and regs[1] == 0 and regs[2] == 0


def _split_candidates(M: int, K: int, N: int, fmt: MPFormat, limit: int,
                      sms: int, nout: int = 1, ny: int = 1
                      ) -> List[MatmulParams]:
    """A split decode tile on f32 weights (the fused matmul's, or the
    projection's at ``nout`` weights a block and ``ny`` blocks of weights):
    cluster sizes (the plan's, 1, 2, 4 and 8 as the tile runs them) and,
    for each, the stages of KC up to the ring's most and the rank's K
    range, within ``limit`` bytes."""
    sizes = sorted({split_norm(K, s) for s in
                    (split_plan(-(-N // DEC_N) * ny, K, fmt, M, sms,
                                nout=nout)[0], 1, 2, 4, 8)})
    out: List[MatmulParams] = []
    nch = -(-K // KC)
    for S in sizes:
        cpr = -(-nch // S)
        kr = K if S == 1 else cpr * KC
        kmax = min(decode_ring_k(fmt), -(-kr // KC) * KC)
        for dk in range(KC, kmax + 1, KC):
            need = (dec_smem_bytes(False, fmt.n_limbs, M, dk,
                                   min(DEC_SLOTS, -(-kr // dk)), nout)
                    if S == 1 else split_smem(fmt, M, kr, dk, cpr,
                                              nout=nout))
            if need <= limit:
                out.append((dk, S))
    return out


def candidate_blocks(M: int, K: int, N: int, mode: FormatLike, *,
                     n_out: int = 1, epilogue: str = "none",
                     smem: Optional[int] = None,
                     ptxas: Optional[Dict[str, List[int]]] = None,
                     sms: int = H100_SMS) -> List[MatmulParams]:
    """The feasible launch parameters of one matmul cell, each within
    ``smem`` bytes of shared memory (the card's opt-in limit by default)
    and, given a ``ptxas`` summary, an instantiation of its own only if it
    built without a spill (the projection's E / 2).  The fused
    matmul: at M <= 16 the decode tile's ``(dk, S)``, at larger M none (its
    prefill tiles have no free parameter).  The fused projection: at M <=
    16 its split decode tile's ``(dk, S)`` (gated, both weights a block;
    else one, the grid walking them); at larger M none on its TMA tile
    (K and N multiples of 4, as the contiguous operands a sweep makes: a
    tensor map reads them), else the strided tile's ``(0, E)`` at the
    default E and E / 2 (built-in formats)."""
    fmt = resolve(mode)
    limit = smem if smem is not None else smem_limit()
    gated = "swiglu" in epilogue
    proj = n_out != 1 or epilogue != "none"
    if not proj:
        if M <= DEC_M:
            return _split_candidates(M, K, N, fmt, limit, sms)
        return []
    if M <= DEC_M:
        return _split_candidates(M, K, N, fmt, limit, sms,
                                 *((2, 1) if gated else (1, min(n_out, 3))))
    out: List[MatmulParams] = []
    if K % 4 == 0 and N % 4 == 0:
        return []       # the TMA tile (mp_matmul.proj_route)
    width = min(n_out, 3)   # ops.mp_fused_proj_cuda: 3 weights per launch
    nl = _nl_no(fmt)[0]
    for e in (format_tile_e(fmt, width), format_tile_e_alt(fmt, width)):
        if e and tile_smem(nl, width, e) <= limit and _tile_builds(
                fmt, width, e, ptxas):
            out.append((0, e))
    return out


def attention_candidate_blocks(S: int, T: int, Dh: int, mode_qk: FormatLike,
                               mode_pv: FormatLike, *,
                               smem: Optional[int] = None) -> List[AttnParams]:
    """The flash kernel's query rows per block within ``smem`` bytes of
    shared memory; rows past S rounded up to 16 are left out (but 16)."""
    limit = smem if smem is not None else smem_limit()
    sp = -(-S // 16) * 16
    return [(bq,) for bq in FLASH_BLOCK_QS
            if (bq == FLASH_BLOCK_QS[0] or bq <= sp)
            and flash_smem(Dh, bq, mode_qk, mode_pv) <= limit]


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------
def _sweep(key: str, cands, run, iters: int, record: Optional[dict],
           default):
    """Hold each candidate bitwise against the default launch (``run(None)``),
    then time the default and every candidate in turn on the device timer,
    ``iters`` rounds, each round starting at the next one (so neither a
    drift of the card's clock nor the place in a round favours one), and
    keep the fastest of all by its median: ``default`` (the table's value
    for the default launch) where the default is fastest."""
    from repro_torch.kernels.timing import device_ms

    ref = run(None)
    for cand in cands:
        if not torch.equal(run(cand), ref):
            raise RuntimeError(
                f"autotune {key}: the launch at {list(cand)} differs from "
                f"the default launch (a kernel fault: these parameters "
                f"must change no bit)")
    configs = [None] + list(cands)
    samples = {i: [] for i in range(len(configs))}
    for r in range(iters):
        for k in range(len(configs)):
            i = (r + k) % len(configs)     # each round starts one later
            samples[i].append(device_ms(lambda: run(configs[i]))[0])
    med = {i: sorted(v)[len(v) // 2] for i, v in samples.items()}
    best = min(range(len(configs)), key=lambda i: med[i])
    _STATS["sweeps"] += 1
    winner = tuple(default) if best == 0 else tuple(configs[best])
    if record is not None:
        record.update(key=key, default_ms=med[0], winner=list(winner),
                      winner_ms=med[best], default_won=best == 0,
                      candidates={str(list(c)): med[i + 1]
                                  for i, c in enumerate(cands)})
    return winner


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def autotune(M: int, K: int, N: int, mode: FormatLike, *,
             dtype=torch.float32, iters: int = 5,
             candidates: Optional[Sequence[MatmulParams]] = None,
             n_out: int = 1, epilogue: str = "none",
             record: Optional[dict] = None) -> MatmulParams:
    """Sweep one (format, shape, dtype, n_out, epilogue) matmul cell on the
    card and persist the winner; returns the cached winner when the table
    has the key.  A cell without candidates (a prefill tile's) records
    the default launch.  ``record`` (a dict) receives the default's and
    each candidate's milliseconds."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mp_matmul as kern

    fmt = resolve(mode)
    key = table_key(M, K, N, fmt, dtype, n_out=n_out, epilogue=epilogue)
    cached = _get(key)
    if cached is not None:
        dk, e = cached
        return dk, e
    if candidates is None:
        ptxas = build.ptxas_summary(build.ptxas_log("mp_matmul"))
        candidates = candidate_blocks(
            M, K, N, fmt, n_out=n_out, epilogue=epilogue, ptxas=ptxas,
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
    g = _gen()     # no candidate: the default launch, timed alone
    a = torch.randn((M, K), generator=g, device="cuda")
    if n_out == 1 and epilogue == "none":
        b = torch.randn((K, N), generator=g, device="cuda")

        def run(tune):
            return kern.mp_fused_matmul(a, b, fmt, tune=tune)
    else:
        gate = "swiglu" if "swiglu" in epilogue else "none"
        ws = [torch.randn((K, N), generator=g, device="cuda")
              for _ in range(n_out)]
        biases = [torch.randn((N,), generator=g, device="cuda")
                  for _ in range(n_out)] if "bias" in epilogue else None
        residual = torch.randn((M, N), generator=g, device="cuda") \
            if "res" in epilogue else None

        def run(tune):
            from repro_torch.kernels import ops

            out = ops.mp_fused_proj_cuda(a, ws, fmt, gate=gate,
                                         biases=biases, residual=residual,
                                         tune=tune)
            return torch.stack(out) if isinstance(out, tuple) else out
    best = _sweep(key, candidates, run, iters, record, (0, 0))
    table = load_table()
    table[key] = list(best)
    save_table(table)
    return best


def lookup(M: int, K: int, N: int, mode: FormatLike, dtype=torch.float32, *,
           n_out: int = 1, epilogue: str = "none"
           ) -> Optional[MatmulParams]:
    """Cached winner or None; never sweeps (the serving-safe path)."""
    entry = _get(table_key(M, K, N, mode, dtype, n_out=n_out,
                           epilogue=epilogue))
    if entry is None:
        return None
    dk, e = entry
    return dk, e


def autotune_attention(B_H: int, S: int, T: int, Dh: int,
                       mode_qk: FormatLike,
                       mode_pv: Optional[FormatLike] = None, *,
                       causal: bool = True, iters: int = 5,
                       candidates: Optional[Sequence[AttnParams]] = None,
                       record: Optional[dict] = None) -> AttnParams:
    """Sweep the flash kernel's query rows per block for one attention cell
    (run as B = 1 with B_H heads, as the JAX tuner runs it) and persist the
    winner in the same per-card table."""
    from repro_torch.kernels import mp_attention as attn

    mode_qk = resolve(mode_qk)
    mode_pv = resolve(mode_pv if mode_pv is not None else mode_qk)
    key = attention_table_key(B_H, S, T, Dh, mode_qk, mode_pv, causal=causal)
    cached = _get(key)
    if cached is not None:
        return (cached[0],)
    if candidates is None:
        candidates = attention_candidate_blocks(S, T, Dh, mode_qk, mode_pv)
    if not candidates:
        raise ValueError(f"no feasible attention blocks for {key}")
    g = _gen()
    q = torch.randn((1, S, B_H, Dh), generator=g, device="cuda")
    k = torch.randn((1, T, B_H, Dh), generator=g, device="cuda")
    v = torch.randn((1, T, B_H, Dh), generator=g, device="cuda")

    def run(cand):
        return attn.mp_flash_attention(
            q, k, v, mode_qk, mode_pv, causal=causal,
            block_q=None if cand is None else cand[0])
    default = (attn.flash_block_q(1, S, B_H, Dh, mode_qk, mode_pv)[0],)
    best = _sweep(key, candidates, run, iters, record, default)
    table = load_table()
    table[key] = list(best)
    save_table(table)
    return best


def lookup_attention(B_H: int, S: int, T: int, Dh: int, mode_qk: FormatLike,
                     mode_pv: Optional[FormatLike] = None, *,
                     causal: bool = True, paged: bool = False
                     ) -> Optional[AttnParams]:
    """Cached attention winner or None; never sweeps (serving-safe)."""
    mode_pv = mode_pv if mode_pv is not None else mode_qk
    entry = _get(attention_table_key(B_H, S, T, Dh, mode_qk, mode_pv,
                                     causal=causal, paged=paged))
    return None if entry is None else (entry[0],)
