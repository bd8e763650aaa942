#!/usr/bin/env python3
"""Time this tree's kernels against other versions of one of their CUDA
sources on one card, and check that they give the same bits.

    python3 compare_kernels.py [OTHER.cu ...]
    python3 compare_kernels.py --source mp_attention OTHER.cu [...]

``--source`` names the source (``mp_matmul``, the default: the limb
matmuls; ``mp_attention``: paged and mixed paged decode attention and flash
attention).  Each other version is compiled with the tree's flags into
``build/compare_kernels/``, all at once, beside this tree's libraries (for
``mp_matmul``: another version's ``mp_matmul.cu`` with the
``mp_matmul_hopper.cu`` beside it, where it has one; each version runs
each case by the routes the port's wrappers take, through the entries it
has).  Every case runs on each version through the port's launch
marshalling, timed on the port's device timer
(``repro_torch/kernels/timing.py``: calls queued behind a sleep kernel),
and each other version's output is compared with this tree's bit for bit;
the SM clock and power draw are sampled while each case of this tree runs
back to back, and this tree's matmul lines carry the case's route, its
bound, its plain version's time and, at M8, the time of ``torch.mm`` on
bf16 operands with f32 out (M8's function; the projection's on its
weights concatenated along N, SwiGLU's the product only).  An older
version without the split projection or mixed-lane entries of
``mp_matmul_hopper.cu`` runs those decode shapes on its ``mp_matmul.cu``.
With no other version, this tree's cases alone; ``--match TEXT`` keeps
the cases whose label holds TEXT.

    python3 compare_kernels.py PARENT/src/repro_torch/kernels/csrc/mp_matmul.cu

with the parent commit unpacked under ``build/`` (``git archive``) times a
change against its parent in one call.  A version
whose order of sums differs is reported, not rejected: the tool serves to
time a redesign (the parent's source, or a copy with one part removed) and
to check that a new instruction keeps the order's bits.  Each version's
``[ptxas]`` lines show its registers and spills.  Needs the card and
``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class Version:
    """One version of the limb matmul sources: its ``mp_matmul`` library
    and, where the version has one, its ``mp_matmul_hopper`` library (the
    Hopper tiles).  Each case runs on it by the routes the port's wrappers
    take, through the entries the version has: an older version's
    ``mp_matmul.cu`` runs the projection and the pre-limbed matmul at every
    shape itself."""

    def __init__(self, matmul, hopper=None):
        self.libs = {"mp_matmul": matmul, "mp_matmul_hopper": hopper}

    def has(self, entry: str) -> bool:
        hopper = self.libs["mp_matmul_hopper"]
        return hopper is not None and hasattr(hopper, entry)


def matmul_cases(torch, randn):
    """The model's prefill and decode shapes (paper-mpfp-100m), as in
    chip_smoke.py's [time] lines: the fused matmul, the partials epilogue
    at the K-sharded prefill's shapes (two ranks: half of K), the fused
    projection (QKV, SwiGLU, the training step's; at decode also with
    bias, residual and both), the pre-limbed matmul at the decode shapes
    on ``mp_decompose``d planes (two stored limbs, as the serving path
    stores them), the mixed-lane matmul at the mixed tick's decode shapes
    (two rows per mode of chip_smoke.MODES, envelope (3, 2), three stored
    limbs; and four rows, one per mode), and the order's edges: a row
    whose products are all -0.0, and the subnormal products of
    tests/test_torch_gpu.py::test_subnormal_products_are_kept (an f32 and
    bf16 subnormal column, rows of +-3.39e38 and an inf), each at a
    prefill and a decode row count, through the fused matmul, the
    projection (70, 8 and 4 rows), the pre-limbed matmul (8 and 4 rows),
    the mixed-lane matmul (70, 8 and 4 rows, the four lanes in turn) and
    the both-prelimbed matmul (70 and 8 rows, M16 and M52); and the
    both-prelimbed matmul on DD stacks (``decompose_dd`` of seeded float64
    data) at chip_smoke.py's five [modes] shapes and at two decode shapes
    (8 rows), and on ``mp_decompose``'d f32 stacks at lm_head M52.  A
    design of the both-prelimbed tile other than the tree's is timed as
    another version: a copy of the sources with that design in place.
    Returns {label: (run, spec or None)}; ``run(version, stream)``
    launches on a :class:`Version`; ``spec`` describes the case for
    :func:`matmul_extras`."""
    from chip_smoke import CUSTOM, MODES
    from repro_torch.core import lanes
    from repro_torch.core.formats import register_format
    from repro_torch.core.formats import resolve as f
    from repro_torch.kernels import mp_matmul as mm

    def fused(a, b, fmt):
        def run(v, st):
            return mm.launch_routed(st, a, b, f(fmt), libs=v.libs)[0]
        return run, dict(kind="fused", a=a, b=b, fmt=f(fmt))

    def partials(a, b, fmt):
        def run(v, st):
            return mm.launch_routed(st, a, b, f(fmt), parts=True,
                                    libs=v.libs)[0]
        return run, dict(kind="parts", a=a, b=b, fmt=f(fmt))

    def proj(a, ws, fmt, gate="none", biases=None, residual=None):
        epi = dict(gate=gate, biases=biases, residual=residual)
        # an older version runs its own decode tile, or every shape, on
        # mp_matmul.cu
        entry = ("mp_hopper_proj_decode_launch" if a.shape[0] <= mm.DEC_M
                 else "mp_hopper_proj_launch")

        def run(v, st):
            if v.has(entry):
                return mm.launch_proj_routed(st, a, ws, f(fmt), libs=v.libs,
                                             **epi)[0]
            return mm.launch_fused_proj(v.libs["mp_matmul"], st, a, ws,
                                        f(fmt), **epi)
        return run, dict(kind="proj", a=a, ws=ws, fmt=f(fmt), **epi)

    def prelimbed(a, w, fmt, n_stored=2):
        limbs = mm.mp_decompose(w, n_stored)

        def run(v, st):
            if v.has("mp_hopper_prelimbed_launch"):
                return mm.launch_prelimbed_routed(st, a, limbs, f(fmt),
                                                  libs=v.libs)[0]
            return mm.launch_prelimbed_matmul(v.libs["mp_matmul"], st, a,
                                              limbs, f(fmt))
        return run, dict(kind="prelimbed", a=a, limbs=limbs, w=w,
                         fmt=f(fmt))

    def mixed(a, w, names, n_stored=3):
        """Row i of a at the format names[i % len(names)] under their
        envelope, against w's mp_decompose'd planes."""
        fmts = [f(n) for n in (list(names) * a.shape[0])[:a.shape[0]]]
        env = lanes.envelope_format(max(x.n_limbs for x in fmts),
                                    max(x.max_order for x in fmts))
        ln, lo = (torch.tensor(v, dtype=torch.int32, device=a.device)
                  for v in ([x.n_limbs for x in fmts],
                            [x.max_order for x in fmts]))
        limbs = mm.mp_decompose(w, n_stored)

        def run(v, st):
            if a.shape[0] > mm.DEC_M or v.has(
                    "mp_hopper_mixed_prelimbed_launch"):
                return mm.launch_mixed_routed(st, a, limbs, env, ln, lo,
                                              libs=v.libs)[0]
            return mm.launch_mixed_prelimbed_matmul(
                v.libs["mp_matmul"], st, a, limbs, env, ln, lo)
        return run, dict(kind="mixed", a=a, limbs=limbs, fmt=env, fmts=fmts,
                         lanes=(ln, lo))

    def both(al, bl, fmt):
        """The both-prelimbed matmul on the stacks (al, bl) by its route.  A
        version without mp_hopper_both_prelimbed_launch runs its
        mp_matmul.cu."""
        def run(v, st):
            if v.has("mp_hopper_both_prelimbed_launch"):
                return mm.launch_both_routed(st, al, bl, f(fmt),
                                             libs=v.libs)[0]
            return mm.launch_both_prelimbed_matmul(v.libs["mp_matmul"], st,
                                                   al, bl, f(fmt))
        return run, dict(kind="both", a=al[0], al=al, bl=bl, fmt=f(fmt))

    def dd(M, K, N, fmt, seed=1):
        """Stacks of decompose_dd at the format's limbs of a seeded float64
        (M, K) @ (K, N) pair, as the [modes] phase makes its DD operands."""
        import numpy as np

        from repro_torch.core import limbs as limbs_lib

        rng = np.random.default_rng(seed)
        n = f(fmt).n_limbs
        return tuple(limbs_lib.decompose_dd(limbs_lib.dd_from_f64(
            rng.standard_normal(shape), device=x.device), n)
            for shape in ((M, K), (K, N)))

    spec = dict(CUSTOM)
    register_format(spec.pop("name"), **spec)
    tick = [m for m in MODES for _ in range(2)]   # two rows per mode
    x, a_ff = randn(2048, 768), randn(2048, 3072)
    w_o, w_down = randn(768, 768) * 0.03, randn(3072, 768) * 0.02
    w_up = randn(768, 3072) * 0.03
    w_lm = randn(768, 32000) * 0.03
    wq = [randn(768, 768) * 0.03 for _ in range(3)]
    wg = [randn(768, 3072) * 0.03 for _ in range(2)]
    bq = [randn(768) for _ in range(3)]
    bg = [randn(3072) for _ in range(2)]
    qh = randn(8, 1, 12, 64).permute(0, 2, 1, 3)
    kt = randn(8, 512, 12, 64).permute(0, 2, 1, 3).transpose(-1, -2)
    xa7, wl7 = mm.mp_decompose(x, 7), mm.mp_decompose(w_lm, 7)
    neg = randn(70, 256)
    neg[3] = -0.0
    pos = randn(256, 64).abs() + 0.1
    pos2 = randn(256, 64).abs() + 0.1
    sub = randn(70, 16)
    sub[0] = 3.39e38 * torch.sign(sub[0])
    sub[1, 3] = float("inf")
    sub_b = randn(16, 8)
    sub_b[:, 4] = 1e-40
    sub_b2 = randn(16, 8)
    sub_b2[:, 2] = 1e-40
    return {
        "prefill w_down 2048x3072x768 M8": fused(a_ff, w_down, "M8"),
        "prefill wo 2048x768x768 M8": fused(x, w_o, "M8"),
        "prefill lm_head 2048x768x32000 M16": fused(x, w_lm, "M16"),
        "prefill wo 2048x768x768 M23": fused(x, w_o, "M23"),
        "prefill QKV 2048x768 vs 3x768x768 M8": proj(x, wq, "M8"),
        "prefill SwiGLU 2048x768 vs 2x768x3072 M8": proj(x, wg, "M8",
                                                         "swiglu"),
        "train QKV 1024x768 vs 3x768x768 M16": proj(x[:1024], wq, "M16"),
        "train gate/up 1024x768 vs 2x768x3072 M16": proj(x[:1024], wg,
                                                         "M16"),
        "prefill QKV 2048x768 vs 3x768x768 M23": proj(x, wq, "M23"),
        "decode QKV 8x768 vs 3x768x768 M8": proj(x[:8], wq, "M8"),
        "decode SwiGLU 8x768 vs 2x768x3072 M8": proj(x[:8], wg, "M8",
                                                     "swiglu"),
        "decode QKV+bias 8x768 vs 3x768x768 M8": proj(
            x[:8], wq, "M8", biases=bq),
        "decode SwiGLU+bias+res 8x768 vs 2x768x3072 M8": proj(
            x[:8], wg, "M8", "swiglu", biases=bg, residual=randn(8, 3072)),
        "decode 1 out+bias+res 8x768 vs 768x768 M8": proj(
            x[:8], wq[:1], "M8", biases=bq[:1], residual=randn(8, 768)),
        "decode QKV 4x768 vs 3x768x768 M8": proj(x[:4], wq, "M8"),
        "decode QKV 8x768 vs 3x768x768 M23": proj(x[:8], wq, "M23"),
        "decode SwiGLU 8x768 vs 2x768x3072 M16": proj(x[:8], wg, "M16",
                                                      "swiglu"),
        "partials lm_head K/2 2048x384x32000 M16": partials(
            x[:, :384], w_lm[:384], "M16"),
        "partials w_down K/2 2048x1536x768 M8": partials(
            a_ff[:, :1536], w_down[:1536], "M8"),
        "partials wo K/2 2048x384x768 M8": partials(x[:, :384], w_o[:384],
                                                    "M8"),
        "decode lm_head 8x768x32000 M16": fused(x[:8], w_lm, "M16"),
        "decode w_down 8x3072x768 M8": fused(a_ff[:8], w_down, "M8"),
        "decode wo 8x768x768 M8": fused(x[:8], w_o, "M8"),
        "decode QK 96 x 1x64x512 M16": fused(qh, kt, "M16"),
        "pre-limbed decode w_down 8x3072x768 M8": prelimbed(a_ff[:8],
                                                            w_down, "M8"),
        "pre-limbed decode wo 8x768x768 M8": prelimbed(x[:8], w_o, "M8"),
        "pre-limbed decode w_up 8x768x3072 M8": prelimbed(x[:8], w_up,
                                                          "M8"),
        "pre-limbed decode lm_head 8x768x32000 M16": prelimbed(x[:8], w_lm,
                                                               "M16"),
        "pre-limbed decode w_down 8x3072x768 M23": prelimbed(
            a_ff[:8], w_down, "M23", 3),
        "row of -0.0 products 70x256x64 M8": fused(neg, pos, "M8"),
        "row of -0.0 products 8x256x64 M8": fused(neg[:8], pos, "M8"),
        "row of -0.0 products, projection 70x256 vs 2x256x64 M8": proj(
            neg, [pos, pos2], "M8"),
        "row of -0.0 products, pre-limbed 8x256x64 M8": prelimbed(
            neg[:8], pos, "M8", 1),
        "row of -0.0 products, pre-limbed 4x256x64 M8": prelimbed(
            neg[:4], pos, "M8", 1),
        "subnormal products 70x16x8 M16": fused(sub, sub_b, "M16"),
        "subnormal products 4x16x8 M16": fused(sub[:4], sub_b, "M16"),
        "subnormal products, projection 70x16 vs 2x16x8 M16": proj(
            sub, [sub_b, sub_b2], "M16"),
        "subnormal products, SwiGLU 70x16 vs 2x16x8 M16": proj(
            sub, [sub_b, sub_b2], "M16", "swiglu"),
        "subnormal products, pre-limbed 8x16x8 M16": prelimbed(
            sub[:8], sub_b, "M16"),
        "subnormal products, pre-limbed 4x16x8 M16": prelimbed(
            sub[:4], sub_b, "M16"),
        "row of -0.0 products, projection 8x256 vs 2x256x64 M8": proj(
            neg[:8], [pos, pos2], "M8"),
        "row of -0.0 products, projection 4x256 vs 2x256x64 M8": proj(
            neg[:4], [pos, pos2], "M8"),
        "subnormal products, projection 8x16 vs 2x16x8 M16": proj(
            sub[:8], [sub_b, sub_b2], "M16"),
        "subnormal products, SwiGLU 4x16 vs 2x16x8 M16": proj(
            sub[:4], [sub_b, sub_b2], "M16", "swiglu"),
        "mixed decode wq 8x768x768, two rows per mode": mixed(
            x[:8], w_o, tick),
        "mixed decode w_gate 8x768x3072, two rows per mode": mixed(
            x[:8], w_up, tick),
        "mixed decode w_down 8x3072x768, two rows per mode": mixed(
            a_ff[:8], w_down, tick),
        "mixed decode lm_head 8x768x32000, two rows per mode": mixed(
            x[:8], w_lm, tick),
        "mixed decode wq 4x768x768, one row per mode": mixed(
            x[:4], w_o, MODES),
        "row of -0.0 products, mixed 8x256x64": mixed(neg[:8], pos, MODES),
        "row of -0.0 products, mixed 4x256x64": mixed(neg[:4], pos, MODES),
        "row of -0.0 products, mixed 70x256x64": mixed(neg, pos, MODES),
        "subnormal products, mixed 8x16x8": mixed(sub[:8], sub_b, MODES),
        "subnormal products, mixed 4x16x8": mixed(sub[:4], sub_b, MODES),
        "DD lm_head 2048x768x32000 M52 on mp_decompose'd f32": both(
            xa7, wl7, "M52"),
        **{f"DD {k} {M}x{K}x{N} {fmt} on decompose_dd": both(
            *dd(M, K, N, fmt), fmt)
           for k, (M, K, N), fmts in (
               ("w_up", (2048, 768, 3072), ("M36", "M52")),
               ("w_down", (2048, 3072, 768), ("M36", "M52")),
               ("lm_head", (2048, 768, 32000), ("M52",)),
               ("decode w_up", (8, 768, 3072), ("M52",)),
               ("decode w_down", (8, 3072, 768), ("M36",)))
           for fmt in fmts},
        **{f"{what}, both-prelimbed {M}x{a.shape[1]}x{b.shape[1]} {fmt}":
           both(mm.mp_decompose(a[:M], f(fmt).n_limbs),
                mm.mp_decompose(b, f(fmt).n_limbs), fmt)
           for what, a, b in (("row of -0.0 products", neg, pos),
                              ("subnormal products", sub, sub_b))
           for M in (70, 8) for fmt in ("M16", "M52")},
    }


def matmul_extras(torch, spec) -> str:
    """This tree's line's tail: the case's route, its bound, its plain
    version's time and, at M8 on 2-D operands (not the partials stack),
    torch.mm on bf16 operands with f32 out (the function M8 computes; for
    the projection on its weights concatenated along N, and for SwiGLU the
    product only, without the gate)."""
    from chip_smoke import bound
    from repro_torch.kernels import mp_matmul as mm
    from repro_torch.kernels.timing import device_ms

    kind, fmt, a = spec["kind"], spec["fmt"], spec["a"]
    M, K = a.shape[-2:]
    lib_b = None
    if kind in ("fused", "parts"):
        b = spec["b"]
        A, B, _, sizes, strides = mm._marshal(a, b)
        route = mm.fused_route(A, B, sizes, strides,
                               parts_limbs=fmt.n_limbs if kind == "parts"
                               else 0)
        N = b.shape[-1]
        nb = A.numel() // (M * K)
        n_out = fmt.n_orders if kind == "parts" else 1
        b_ms, b_by = bound(2 * nb * M * K * N * fmt.n_products,
                           4 * (a.numel() + b.numel() + n_out * nb * M * N))
        plain = mm.fused_matmul_partials_plain if kind == "parts" \
            else mm.fused_matmul_plain
        plain_ms = device_ms(lambda: plain(a, b, fmt))[0]
        if a.ndim == 2 and b.ndim == 2 and kind == "fused":
            lib_b = b
    elif kind == "proj":
        ws, gate = spec["ws"], spec["gate"]
        biases, res = spec["biases"], spec["residual"]
        route = mm.proj_route(a.contiguous(), [w.contiguous() for w in ws])
        N = ws[0].shape[1]
        n_out = 1 if gate != "none" else len(ws)
        b_ms, b_by = bound(2 * M * K * N * fmt.n_products * len(ws),
                           4 * (a.numel() + sum(w.numel() for w in ws)
                                + n_out * M * N
                                + (len(ws) * N if biases else 0)
                                + (M * N if res is not None else 0)))
        plain_ms = device_ms(lambda: mm.fused_proj_plain(
            a, ws, fmt, gate=gate, biases=biases, residual=res))[0]
        lib_b = torch.cat(ws, dim=1)
    elif kind == "mixed":
        # the products each row keeps (its own lane), the envelope's planes
        # read once, A and C, and the two lane vectors
        limbs, (ln, lo) = spec["limbs"], spec["lanes"]
        route = mm.prelimbed_route(a)
        N = limbs.shape[-1]
        b_ms, b_by = bound(2 * K * N * sum(x.n_products
                                           for x in spec["fmts"]),
                           4 * (a.numel() + M * N) + 8 * M
                           + 2 * min(limbs.shape[0], fmt.n_limbs) * K * N)
        plain_ms = device_ms(lambda: mm.mixed_prelimbed_matmul_plain(
            a, limbs, fmt, ln, lo))[0]
    elif kind == "both":
        # the planes the format reads, once each, and C; the yardstick: one
        # torch.mm of plane 0 by plane 0 (bf16, f32 out) times the format's
        # products, the library's rate for the same bf16 products without
        # the per-order adds or the combine
        al, bl = spec["al"], spec["bl"]
        route = mm.both_route(al, bl, fmt) if hasattr(mm, "both_route") \
            else "mma"
        N = bl.shape[-1]
        b_ms, b_by = bound(2 * M * K * N * fmt.n_products,
                           2 * (min(al.shape[0], fmt.n_limbs) * M * K
                                + min(bl.shape[0], fmt.n_limbs) * K * N)
                           + 4 * M * N)
        plain_ms = device_ms(lambda: mm.both_prelimbed_matmul_plain(
            al, bl, fmt))[0]
        one_ms = device_ms(lambda: torch.mm(al[0], bl[0],
                                            out_dtype=torch.float32))[0]
        return (f"; {route} route, bound {b_ms:.4f} ms ({b_by}), "
                f"plain {plain_ms:.4f} ms, products only (torch.mm bf16, "
                f"f32 out) x{fmt.n_products} {one_ms * fmt.n_products:.4f} "
                f"ms")
    else:
        limbs = spec["limbs"]
        route = mm.prelimbed_route(a)
        N = limbs.shape[-1]
        b_ms, b_by = bound(2 * M * K * N * fmt.n_products,
                           4 * (a.numel() + M * N)
                           + 2 * min(limbs.shape[0], fmt.n_limbs) * K * N)
        plain_ms = device_ms(lambda: mm.prelimbed_matmul_plain(
            a, limbs, fmt))[0]
        lib_b = spec["w"]
    out = (f"; {route} route, bound {b_ms:.4f} ms ({b_by}), plain "
           f"{plain_ms:.4f} ms")
    if fmt.name == "M8" and lib_b is not None:
        ab, bb = a.bfloat16(), lib_b.bfloat16()
        lib_ms = device_ms(lambda: torch.mm(ab, bb,
                                            out_dtype=torch.float32))[0]
        what = " (product only)" if spec.get("gate", "none") != "none" \
            else ""
        out += f", torch.mm bf16 (f32 out){what} {lib_ms:.4f} ms"
    return out


def attention_cases(torch, randn):
    """chip_smoke.py's paged decode cases (the scheduler's and the mixed
    tick's main case, chunk edges, GQA) and every one of its flash cases."""
    import numpy as np

    from chip_smoke import CUSTOM, FLASH_CASES, flash_inputs, paged_inputs
    from repro_torch.core import lanes
    from repro_torch.core.formats import register_format, resolve
    from repro_torch.kernels import mp_attention as ma

    spec = dict(CUSTOM)
    register_format(spec.pop("name"), **spec)
    decode = [int(n) for n in np.linspace(64, 288, 8)]
    edge = ma.PAGED_CHUNK_POS                 # the chunk at bs 16
    edges = [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 2 * edge + 1,
             1, 16]
    cases = {}

    def paged(label, lengths, hkv, qk, pv):
        q, kp, vp, table, ln = paged_inputs(torch, randn, lengths, 12, hkv)
        fq, fp = resolve(qk), resolve(pv)
        cases[f"paged {label} {qk}/{pv}"] = lambda lib, st: (
            ma.launch_paged_attention(lib, st, q, kp, vp, table, ln, fq, fp,
                                      scale=0.125))

    def mixed(label, lengths, modes):
        q, kp, vp, table, ln = paged_inputs(torch, randn, lengths, 12, 12)
        fmts = [resolve(m) for m in (modes * 8)[:len(lengths)]]
        env = lanes.envelope_format(max(f.n_limbs for f in fmts),
                                    max(f.max_order for f in fmts))
        lane = (torch.tensor([f.n_limbs for f in fmts], dtype=torch.int32,
                             device=q.device),
                torch.tensor([f.max_order for f in fmts], dtype=torch.int32,
                             device=q.device))
        cases[f"mixed paged {label}"] = lambda lib, st: (
            ma.launch_paged_attention(lib, st, q, kp, vp, table, ln, env,
                                      env, scale=0.125, lanes=lane * 2))

    paged("decode 8 slots H12 lengths 64..288", decode, 12, "M16", "M8")
    paged(f"chunk edges {edges[0]}..{edges[5]}", edges, 12, "M16", "M8")
    paged("GQA n_rep 2 lengths 64..288", decode, 6, "M23", "M16")
    mixed("decode 8 slots H12 lengths 64..288 two per mode", decode,
          ["M8", "M8", "M16", "M16", "M23", "M23", CUSTOM["name"],
           CUSTOM["name"]])
    for label, B, S, T, H, Dh, qk, pv, causal, q_off, plant in FLASH_CASES:
        qf, kf, vf = flash_inputs(torch, randn, B, S, T, H, Dh, plant)
        cases[f"flash {label} {qk}/{pv}"] = (
            lambda lib, st, qf=qf, kf=kf, vf=vf, fq=resolve(qk),
            fp=resolve(pv), c=causal, o=q_off, sc=Dh ** -0.5:
            ma.launch_flash_attention(lib, st, qf, kf, vf, fq, fp, causal=c,
                                      scale=sc, q_offset=o))
    return cases


def clocks_while(fn, torch, seconds: float = 1.0) -> str:
    """The card's SM clock (MHz) and power draw (W), sampled by
    ``nvidia-smi`` every 100 ms while ``fn`` runs back to back for about
    ``seconds``: the median of each."""
    import statistics

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [line.split(",") for line in out.strip().splitlines()[2:]]
    if not rows:
        return "clock not sampled"
    mhz = statistics.median(float(r[0]) for r in rows)
    watts = statistics.median(float(r[1]) for r in rows)
    return f"SM clock {mhz:.0f} MHz, {watts:.0f} W ({len(rows)} samples)"


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", default="mp_matmul",
                        choices=("mp_matmul", "mp_attention"))
    parser.add_argument("others", nargs="*", type=Path,
                        help="other versions of csrc/<source>.cu (for "
                        "mp_matmul: with mp_matmul_hopper.cu beside it, "
                        "where it has one); none: this tree's alone")
    parser.add_argument("--match", action="append", default=[],
                        help="run only the cases whose label holds this "
                        "text (repeatable: any of them)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.timing import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "compare_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    # (version, library) -> source; another version's mp_matmul.cu brings
    # the mp_matmul_hopper.cu beside it
    sources = {}
    for o in args.others:
        sources[(str(o), args.source)] = o
        hopper = o.parent / "mp_matmul_hopper.cu"
        if args.source == "mp_matmul" and hopper.exists():
            sources[(str(o), "mp_matmul_hopper")] = hopper
    if args.source != "mp_matmul":
        sources = {("this tree", args.source): build.CSRC /
                   f"{args.source}.cu", **sources}
    procs = {key: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         str(out_dir / f"{key[1]}_{i}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (key, src) in enumerate(sources.items())}
    libs = {}
    if args.source == "mp_matmul":
        # this tree's libraries, built in parallel with the others
        for rep in build.build(("mp_matmul", "mp_matmul_hopper")).values():
            for entry, (regs, st, ld) in sorted(
                    build.ptxas_summary(rep.ptxas).items()):
                print(f"[ptxas] this tree: {entry[:90]} regs {regs} spill "
                      f"{st}/{ld}")
        libs["this tree"] = Version(build.load("mp_matmul"),
                                    build.load("mp_matmul_hopper"))
    built = {}
    for i, (key, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key[0]} ({key[1]}) failed:\n{log}")
        built[key] = ctypes.CDLL(str(out_dir / f"{key[1]}_{i}.so"))
        for entry, (regs, st, ld) in sorted(build.ptxas_summary(log).items()):
            print(f"[ptxas] {key[0]}: {entry[:90]} regs {regs} spill "
                  f"{st}/{ld}")
    for (name, lib_name), lib in built.items():
        if args.source != "mp_matmul":
            libs[name] = lib
        elif lib_name == "mp_matmul":
            libs[name] = Version(lib, built.get((name, "mp_matmul_hopper")))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = (matmul_cases if args.source == "mp_matmul"
             else attention_cases)(torch, randn)
    if args.match:
        cases = {k: v for k, v in cases.items()
                 if any(m in k for m in args.match)}
    stream = torch.cuda.current_stream().cuda_stream
    differ = 0
    for case, fn in cases.items():
        fn, operands = fn if isinstance(fn, tuple) else (fn, None)
        # each case on every version in turn, this tree's first
        ref = fn(libs["this tree"], stream)
        for name, lib in libs.items():
            out = fn(lib, stream)
            torch.cuda.synchronize()
            ms, ahead = device_ms(lambda: fn(lib, stream))
            same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
            differ += not same
            tail = ""
            if name == "this tree":
                tail = f"; {clocks_while(lambda: fn(lib, stream), torch)}"
                if operands is not None:
                    tail += matmul_extras(torch, operands)
            else:
                tail = f", bitwise this tree's: {same}"
            print(f"[compare] {name}: {case}: {ms:.4f} ms"
                  + ("" if ahead else " (host behind the card)") + tail,
                  flush=True)
    print(f"[compare] {differ} case(s) of another version differ from this "
          f"tree's bits")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
