#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero and the last
line is not printed):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: every CUDA source of ``src/repro_torch/kernels/csrc`` compiled
   in parallel into ``build/torch_kernels/`` (seconds, registers, spills);
3. each kernel against its plain PyTorch version on the card, at the serving
   path's shapes and formats plus M23/M36 (and more) for the matmul kernels;
   the decompose kernel bitwise, the pre-limbed matmul bitwise against the
   fused matmul on the raw weight, and each row (slot) of the two mixed-lane
   kernels bitwise against the homogeneous kernel at its own format;
4. the static path: ``ServeEngine.generate`` of the full-width
   ``paper-mpfp-100m`` (random weights from seed 0, raw decode weights) on 8
   prompts of 64..256 tokens, 32 new tokens each, under ``serve_default``;
   launch counts must be what the config implies, and the prefill logits
   must agree with the same engine on the ``ref`` backend;
4b. the scheduler path: ``ContinuousScheduler`` over a pre-limbed engine
   (8 slots, a 160-block pool of 16 positions) serving 16 requests of
   64..256 prompt tokens and 32 new tokens, arriving two ticks apart; launch
   counts must be what the scheduler's own counters imply, two streams must
   equal their solo runs bit for bit, and one paged prefill's logits must
   agree with the ``ref`` backend; then a decode-only tick probe;
4c. mixed traffic: a fresh pre-limbed engine under the same scheduler
   serving the same 16 requests with modes M8 / M16 / M23 / a custom 2-limb
   format in turn; one decode launch per tick, the mixed-lane and
   homogeneous kernels' launches what the counts of mixed and bucket decode
   launches imply, two requests of different modes equal to their solo runs
   bit for bit; then a mixed decode-tick probe (8 slots, two per mode) timed
   against the one-launch-per-policy plan on the same slots, tokens equal;
5. a ``kernels`` JSON line: per kernel its launches on its main path, its
   time, the plain version's time, the card's bound and a library call's
   time where one PyTorch call computes the same function.

The last line is ``{"ok": true, "device": {...}}``.  A report with every
number goes to ``chiprun_out/chip_smoke.json``.  Exits non-zero without a
CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_OPS = 989e12      # H100 SXM dense bf16 tensor-core rate (ops/s)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 (bytes/s)
PEAK_F32 = 67e12       # H100 SXM f32 outside the tensor cores (ops/s)
U32 = 2.0 ** -24       # f32 unit roundoff
SOURCES = {
    "mp_fused_matmul": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                        "src/repro/kernels/mp_matmul.py:76"),
    "mp_fused_proj": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                      "src/repro/kernels/mp_matmul.py:227"),
    "mp_flash_attention": ("src/repro_torch/kernels/csrc/mp_attention.cu",
                           "src/repro/kernels/mp_attention.py:93"),
    "mp_decompose": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                     "src/repro/kernels/mp_matmul.py:514"),
    "mp_prelimbed_matmul": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                            "src/repro/kernels/mp_matmul.py:108"),
    "mp_paged_attention": ("src/repro_torch/kernels/csrc/mp_attention.cu",
                           "src/repro/kernels/mp_attention.py:230"),
    "mp_mixed_prelimbed_matmul": (
        "src/repro_torch/kernels/csrc/mp_matmul.cu",
        "src/repro/kernels/mp_matmul.py:137"),
    "mp_mixed_paged_attention": (
        "src/repro_torch/kernels/csrc/mp_attention.cu",
        "src/repro/kernels/mp_attention.py:346"),
}
# the path whose run gives each kernel's ``launches``: the three kernels of
# slice 1 report the static ``generate`` path, the three of the scheduler
# slice the scheduler path, the two mixed-lane kernels the mixed-traffic path
LAUNCH_PATH = {"mp_decompose": "scheduler", "mp_prelimbed_matmul": "scheduler",
               "mp_paged_attention": "scheduler",
               "mp_mixed_prelimbed_matmul": "mixed",
               "mp_mixed_paged_attention": "mixed"}
# launches of one generate(8 prompts, max_new=32) at 12 layers: prefill
# QKV + SwiGLU per layer; wo, w_down per layer + lm_head; decode adds QK
# and PV per layer
EXPECTED = {"mp_fused_proj": 24 + 32 * 24, "mp_flash_attention": 12,
            "mp_fused_matmul": 25 + 32 * 49, "mp_decompose": 0,
            "mp_prelimbed_matmul": 0, "mp_paged_attention": 0,
            "mp_mixed_prelimbed_matmul": 0, "mp_mixed_paged_attention": 0}
# the scheduler path: one prelimb decomposes 7 matrices per layer + lm_head;
# a B=1 paged prefill runs QKV and SwiGLU fused projections, flash attention
# and wo, w_down per layer + lm_head; a decode launch runs 7 pre-limbed
# matmuls and one paged attention per layer + the pre-limbed lm_head
PER_PRELIMB = {"mp_decompose": 12 * 7 + 1}
PER_PREFILL = {"mp_fused_proj": 24, "mp_flash_attention": 12,
               "mp_fused_matmul": 25}
PER_DECODE = {"mp_prelimbed_matmul": 12 * 7 + 1, "mp_paged_attention": 12}
# a mixed decode launch runs the same call sites on the mixed-lane kernels
PER_MIXED = {"mp_mixed_prelimbed_matmul": 12 * 7 + 1,
             "mp_mixed_paged_attention": 12}
# the mixed-traffic modes, request i at MODES[i % 4]: the serving builtins
# and a custom format that keeps all four 2-limb products (M16 keeps three)
CUSTOM = dict(name="M16FULL", mantissa_bits=16, n_limbs=2, max_order=2)
MODES = ("M8", "M16", "M23", CUSTOM["name"])


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, torch, min_ms: float = 30.0) -> float:
    """Mean device milliseconds per call, from CUDA events over a run of
    calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = max(3, min(200, int(min_ms / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_busy_ms(fn):
    """Milliseconds of device time on the card while ``fn`` runs, summed
    over what ``torch.profiler`` records (kernels and copies), and the
    same by name, largest first (fails when it records none: a busy time
    is read from the card or not at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            name = name.split("::")[-1].strip()
            by_name[name] = by_name.get(name, 0.0) \
                + e.self_device_time_total / 1e3
    total = sum(by_name.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total, dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def bound(ops: float, nbytes: float, peak_ops: float = PEAK_OPS):
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import paper_mpfp
    from repro_torch.core import lanes
    from repro_torch.core.formats import register_format, resolve
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels import build, mp_attention, mp_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve import primitives as prim
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}

    # ---- 1. the card ------------------------------------------------------
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name}")
    report["card"] = smi

    # ---- 2. the build -----------------------------------------------------
    t0 = time.perf_counter()
    builds = build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s wall "
        + ", ".join(f"{b.name} {b.seconds:.1f} s" for b in builds.values()))
    for b in builds.values():
        for entry, (regs, st, ld) in sorted(
                build.ptxas_summary(b.ptxas).items()):
            log(f"[ptxas] {b.name}: {entry[:90]} regs {regs} "
                f"spill st {st} ld {ld}")

    # ---- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    checks = {k: [] for k in SOURCES}
    cases = {k: [] for k in SOURCES}

    def hold(kernel, label, out, ref, tol, extra):
        err = (out - ref).abs()
        bad = (err > tol).sum().item()
        row = {"case": label, "max_abs_err": err.max().item(),
               "max_rel_err": (err / ref.abs().clamp_min(1e-30)).max().item(),
               "violations": bad, **extra}
        checks[kernel].append(row)
        log(f"[check] {kernel} {label}: max_abs {row['max_abs_err']:.3e} "
            f"max_rel {row['max_rel_err']:.3e} tol_max "
            f"{tol.max().item() if torch.is_tensor(tol) else tol:.3e} "
            f"violations {bad}")
        if bad or not torch.isfinite(out).all():
            raise AssertionError(f"{kernel} {label} disagrees with its "
                                 "plain version")

    def mm_tol(ref, K):
        # the repo's f32 accumulation floor (tests/test_kernels.py
        # _err_bound): two orders of summing the same exact limb products
        rms = ref.pow(2).mean().sqrt()
        return 2e-6 * ref.abs() + 8 * U32 * math.sqrt(K) * rms

    def matmul_case(label, a, b, fmt, main=False, library=False, per=None):
        fmt = resolve(fmt)
        out = mp_matmul.mp_fused_matmul(a, b, fmt)
        ref = mp_matmul.fused_matmul_plain(a, b, fmt)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_fused_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": fmt.name})
        nb = out.numel() // (out.shape[-1] * out.shape[-2])
        M, N = out.shape[-2:]
        ops = 2 * nb * M * K * N * fmt.n_products
        nbytes = 4 * (a.numel() + b.numel() + out.numel())
        cases["mp_fused_matmul"].append(dict(
            case=label, fmt=fmt.name, a=list(a.shape), b=list(b.shape),
            ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_matmul.mp_fused_matmul(a, b, fmt),
            plain=lambda: mp_matmul.fused_matmul_plain(a, b, fmt),
            library=(lambda ar=a.bfloat16().float(), br=b.bfloat16().float():
                     torch.matmul(ar, br)) if library else None))

    def proj_case(label, a, ws, fmt, gate="none", biases=None,
                  residual=None, main=False, library=False, per=None):
        fmt = resolve(fmt)
        kw = dict(gate=gate, biases=biases, residual=residual)
        out = mp_matmul.mp_fused_proj(a, ws, fmt, **kw)
        ref = mp_matmul.fused_proj_plain(a, ws, fmt, **kw)
        torch.cuda.synchronize()
        K = a.shape[-1]
        if gate == "none":
            tol = mm_tol(ref, K)
        else:
            # propagate each raw output's floor through silu(g) * u
            # (|silu'| <= 1.1), plus the f32 rounding of the epilogue
            g, u = mp_matmul.fused_proj_plain(a, ws, fmt, biases=biases)
            tol = (1.1 * u.abs() * mm_tol(g, K)
                   + (g / (1 + torch.exp(-g))).abs() * mm_tol(u, K)
                   + 2e-6 * ref.abs())
        hold("mp_fused_proj", label, out, ref, tol, {"fmt": fmt.name})
        M, N = a.shape[0], ws[0].shape[1]
        ops = 2 * M * K * N * fmt.n_products * len(ws)
        nbytes = 4 * (a.numel() + sum(w.numel() for w in ws) + out.numel()
                      + (0 if biases is None else N * len(ws))
                      + (0 if residual is None else residual.numel()))
        stack = torch.stack([w.bfloat16().float() for w in ws])
        cases["mp_fused_proj"].append(dict(
            case=label, fmt=fmt.name, a=list(a.shape), n_out=len(ws),
            N=N, gate=gate, ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_matmul.mp_fused_proj(a, ws, fmt, **kw),
            plain=lambda: mp_matmul.fused_proj_plain(a, ws, fmt, **kw),
            library=(lambda ar=a.bfloat16().float(): torch.matmul(ar, stack))
            if library else None))

    def flash_case(label, B, S, T, H, Dh, qk, pv, causal, q_offset=0,
                   main=False, per=None):
        q, k, v = randn(B, S, H, Dh), randn(B, T, H, Dh), randn(B, T, H, Dh)
        fq, fp = resolve(qk), resolve(pv)
        out = mp_attention.mp_flash_attention(q, k, v, fq, fp, causal=causal,
                                              q_offset=q_offset)
        ref = mp_attention.flash_attention_plain(q, k, v, fq, fp,
                                                 causal=causal,
                                                 q_offset=q_offset)
        torch.cuda.synchronize()
        # same blocking on both sides (tests/test_mp_attention.py's
        # same-blocking tolerance): only f32 summation order differs
        hold("mp_flash_attention", label, out, ref,
             2e-5 + 2e-5 * ref.abs(), {"fmt": f"{qk}/{pv}"})
        qpos = q_offset + np.arange(S)
        pairs = (np.minimum(qpos + 1, T).sum() if causal else S * T)
        ops = 2 * B * H * int(pairs) * Dh * (fq.n_products + fp.n_products)
        nbytes = 4 * (q.numel() + k.numel() + v.numel() + out.numel())
        cases["mp_flash_attention"].append(dict(
            case=label, fmt=f"{qk}/{pv}", shape=[B, S, T, H, Dh],
            causal=causal, ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_attention.mp_flash_attention(
                q, k, v, fq, fp, causal=causal, q_offset=q_offset),
            plain=lambda: mp_attention.flash_attention_plain(
                q, k, v, fq, fp, causal=causal, q_offset=q_offset),
            library=None))

    def decompose_case(label, w, n_limbs, main=False):
        out = mp_matmul.mp_decompose(w, n_limbs)
        ref = mp_matmul.decompose_plain(w, n_limbs)
        torch.cuda.synchronize()
        # the same round-to-nearest-even cascade: bitwise
        diff = (out.view(torch.int16) != ref.view(torch.int16)).sum().item()
        err = (out.float() - ref.float()).abs().max().item()
        checks["mp_decompose"].append(dict(case=label, max_abs_err=err,
                                           bit_mismatches=diff))
        log(f"[check] mp_decompose {label}: bit mismatches {diff}")
        if diff:
            raise AssertionError(f"mp_decompose {label} is not bitwise its "
                                 "plain version")
        n = w.numel()
        cases["mp_decompose"].append(dict(
            case=label, fmt=f"L{n_limbs}", shape=list(w.shape),
            ops=2 * n_limbs * n, bytes=4 * n + 2 * n_limbs * n,
            peak=PEAK_F32, main=main, per=None,
            fn=lambda: mp_matmul.mp_decompose(w, n_limbs),
            plain=lambda: mp_matmul.decompose_plain(w, n_limbs),
            library=None))

    def prelimbed_case(label, a, w, fmt, n_stored, main=False,
                       library=False, per=None):
        fmt = resolve(fmt)
        limbs = mp_matmul.mp_decompose(w, n_stored)
        out = mp_matmul.mp_prelimbed_matmul(a, limbs, fmt)
        ref = mp_matmul.prelimbed_matmul_plain(a, limbs, fmt)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_prelimbed_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": fmt.name, "n_stored": n_stored})
        if n_stored >= fmt.n_limbs:
            # every limb the format needs is stored: the fused kernel's
            # products in the fused kernel's order, so its bits
            fused = mp_matmul.mp_fused_matmul(a, w, fmt)
            torch.cuda.synchronize()
            if not torch.equal(out, fused):
                raise AssertionError(f"mp_prelimbed_matmul {label} is not "
                                     "bitwise mp_fused_matmul")
            checks["mp_prelimbed_matmul"][-1]["bitwise_vs_fused"] = True
        M, N = out.shape
        ops = 2 * M * K * N * fmt.n_products
        # only the planes the format reads leave device memory
        nbytes = (4 * (a.numel() + out.numel())
                  + 2 * min(n_stored, fmt.n_limbs) * K * N)
        cases["mp_prelimbed_matmul"].append(dict(
            case=label, fmt=fmt.name, n_stored=n_stored, a=list(a.shape),
            b=list(w.shape), ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_matmul.mp_prelimbed_matmul(a, limbs, fmt),
            plain=lambda: mp_matmul.prelimbed_matmul_plain(a, limbs, fmt),
            library=(lambda ar=a.bfloat16().float(), br=w.bfloat16().float():
                     torch.matmul(ar, br)) if library else None))

    def paged_case(label, lengths, H, Hkv, qk, pv, Dh=64, bs=16, main=False,
                   per=None):
        B = len(lengths)
        cols = [-(-n // bs) for n in lengths]
        W = prim.pow2_at_least(max(max(cols), 1))
        n_blocks = sum(cols) + 1 + 8
        q = randn(B, H, Dh)
        kp, vp = randn(n_blocks, bs, Hkv, Dh), randn(n_blocks, bs, Hkv, Dh)
        perm = (torch.randperm(n_blocks - 1, generator=torch.Generator()
                               .manual_seed(B)) + 1).tolist()
        table = np.zeros((B, W), np.int32)     # trash-padded
        for b, c in enumerate(cols):
            table[b, :c] = [perm.pop() for _ in range(c)]
        table = torch.from_numpy(table).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        fq, fp = resolve(qk), resolve(pv)
        out = mp_attention.mp_paged_attention(q, kp, vp, table, ln, fq, fp)
        ref = mp_attention.paged_attention_plain(q, kp, vp, table, ln, fq, fp,
                                                 scale=Dh ** -0.5)
        torch.cuda.synchronize()
        # the same pool blocks and online-softmax steps on both sides: only
        # f32 summation order differs (flash's same-blocking tolerance)
        hold("mp_paged_attention", label, out, ref, 2e-5 + 2e-5 * ref.abs(),
             {"fmt": f"{qk}/{pv}"})
        for b, n in enumerate(lengths):
            if n == 0 and out[b].any():
                raise AssertionError(f"mp_paged_attention {label}: a "
                                     "length-0 slot is not exact zeros")
        toks = sum(lengths)
        ops = 2 * H * toks * Dh * (fq.n_products + fp.n_products)
        # blocks below each slot's length only, plus q, out, table, lengths
        nbytes = (4 * 2 * Hkv * Dh * toks + 4 * (q.numel() + out.numel())
                  + 4 * (table.numel() + B))
        cases["mp_paged_attention"].append(dict(
            case=label, fmt=f"{qk}/{pv}", lengths=list(lengths), H=H,
            Hkv=Hkv, bs=bs, W=W, ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_attention.mp_paged_attention(q, kp, vp, table, ln,
                                                       fq, fp),
            plain=lambda: mp_attention.paged_attention_plain(
                q, kp, vp, table, ln, fq, fp, scale=Dh ** -0.5),
            library=None))

    def lane_vectors(fmts):
        """(M,) int32 device lanes of per-row formats."""
        return (torch.tensor([f.n_limbs for f in fmts], dtype=torch.int32,
                             device=dev),
                torch.tensor([f.max_order for f in fmts], dtype=torch.int32,
                             device=dev))

    def envelope(fmts):
        return lanes.envelope_format(max(f.n_limbs for f in fmts),
                                     max(f.max_order for f in fmts))

    def mixed_case(label, a, w, names, n_stored, main=False, per=None):
        """Rows of a at the formats ``names`` (cycled; "PAD" = PAD_LANE)
        against the stored limbs of w: each row bitwise the homogeneous
        pre-limbed kernel at its format, all rows against the plain
        version at the matmul tolerance."""
        pad = lanes.envelope_format(*lanes.PAD_LANE)
        fmts = [pad if n == "PAD" else resolve(n) for n in names]
        fmts = (fmts * a.shape[0])[:a.shape[0]]
        env = envelope(fmts)
        limbs = mp_matmul.mp_decompose(w, n_stored)
        ln, lo = lane_vectors(fmts)
        out = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env, ln, lo)
        ref = mp_matmul.mixed_prelimbed_matmul_plain(a, limbs, env, ln, lo)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_mixed_prelimbed_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": env.name, "n_stored": n_stored})
        for f in sorted(set(fmts), key=lambda f: f.name):
            rows = [i for i, x in enumerate(fmts) if x == f]
            homo = mp_matmul.mp_prelimbed_matmul(a[rows], limbs, f)
            torch.cuda.synchronize()
            if not torch.equal(out[rows].view(torch.int32),
                               homo.view(torch.int32)):
                raise AssertionError(
                    f"mp_mixed_prelimbed_matmul {label}: the {f.name} rows "
                    "are not bitwise mp_prelimbed_matmul's")
        checks["mp_mixed_prelimbed_matmul"][-1]["rows_bitwise"] = True
        M, N = out.shape
        # the products each row keeps (its own lane), the envelope's planes
        # read once, A and C, and the two lane vectors
        ops = 2 * K * N * sum(f.n_products for f in fmts)
        nbytes = (4 * (a.numel() + out.numel()) + 8 * M
                  + 2 * min(n_stored, env.n_limbs) * K * N)
        cases["mp_mixed_prelimbed_matmul"].append(dict(
            case=label, fmt=env.name, lanes=[f.name for f in fmts],
            n_stored=n_stored, a=list(a.shape), b=list(w.shape), ops=ops,
            bytes=nbytes, main=main, per=per,
            fn=lambda: mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env,
                                                           ln, lo),
            plain=lambda: mp_matmul.mixed_prelimbed_matmul_plain(
                a, limbs, env, ln, lo),
            library=None))

    def mixed_paged_case(label, lengths, H, Hkv, slot_modes, Dh=64, bs=16,
                         main=False, per=None):
        """Slot b at the (qk, pv) formats ``slot_modes[b]``: each slot
        bitwise the paged kernel at its formats, all slots against the plain
        version at 2e-5, a length-0 slot exact zeros."""
        B = len(lengths)
        cols = [-(-n // bs) for n in lengths]
        W = prim.pow2_at_least(max(max(cols), 1))
        n_blocks = sum(cols) + 1 + 8
        q = randn(B, H, Dh)
        kp, vp = randn(n_blocks, bs, Hkv, Dh), randn(n_blocks, bs, Hkv, Dh)
        perm = (torch.randperm(n_blocks - 1, generator=torch.Generator()
                               .manual_seed(B + 1)) + 1).tolist()
        table = np.zeros((B, W), np.int32)     # trash-padded
        for b, c in enumerate(cols):
            table[b, :c] = [perm.pop() for _ in range(c)]
        table = torch.from_numpy(table).to(dev)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        fq = [resolve(a) for a, _ in slot_modes]
        fp = [resolve(b) for _, b in slot_modes]
        eq, ep = envelope(fq), envelope(fp)
        lv = (*lane_vectors(fq), *lane_vectors(fp))
        out = mp_attention.mp_mixed_paged_attention(q, kp, vp, table, ln, eq,
                                                    ep, *lv)
        ref = mp_attention.mixed_paged_attention_plain(
            q, kp, vp, table, ln, eq, ep, *lv, scale=Dh ** -0.5)
        torch.cuda.synchronize()
        hold("mp_mixed_paged_attention", label, out, ref,
             2e-5 + 2e-5 * ref.abs(), {"fmt": f"{eq.name}/{ep.name}"})
        for b in range(B):
            homo = mp_attention.mp_paged_attention(q, kp, vp, table, ln,
                                                   fq[b], fp[b])
            torch.cuda.synchronize()
            if not torch.equal(out[b].view(torch.int32),
                               homo[b].view(torch.int32)):
                raise AssertionError(
                    f"mp_mixed_paged_attention {label}: slot {b} is not "
                    "bitwise mp_paged_attention's")
            if lengths[b] == 0 and out[b].any():
                raise AssertionError(f"mp_mixed_paged_attention {label}: a "
                                     "length-0 slot is not exact zeros")
        checks["mp_mixed_paged_attention"][-1]["slots_bitwise"] = True
        ops = sum(2 * H * n * Dh * (a.n_products + b.n_products)
                  for n, a, b in zip(lengths, fq, fp))
        toks = sum(lengths)
        nbytes = (4 * 2 * Hkv * Dh * toks + 4 * (q.numel() + out.numel())
                  + 4 * (table.numel() + B) + 16 * B)
        cases["mp_mixed_paged_attention"].append(dict(
            case=label, fmt=f"{eq.name}/{ep.name}",
            slots=[f"{a}/{b}" for a, b in slot_modes],
            lengths=list(lengths), H=H, Hkv=Hkv, bs=bs, W=W, ops=ops,
            bytes=nbytes, main=main, per=per,
            fn=lambda: mp_attention.mp_mixed_paged_attention(
                q, kp, vp, table, ln, eq, ep, *lv),
            plain=lambda: mp_attention.mixed_paged_attention_plain(
                q, kp, vp, table, ln, eq, ep, *lv, scale=Dh ** -0.5),
            library=None))

    cfg = paper_mpfp.CONFIG
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    x = randn(2048, d)
    matmul_case("prefill lm_head 2048x768x32000", x, randn(d, V) * 0.03,
                "M16", main=True, per=("prefill", 1))
    cache_k = randn(8, 512, 12, 64)
    qh = randn(8, 1, 12, 64).permute(0, 2, 1, 3) * 0.125
    matmul_case("decode QK 96 x 1x64x512", qh,
                cache_k.permute(0, 2, 1, 3).transpose(-1, -2), "M16",
                per=("decode", L))
    p = torch.softmax(randn(8, 12, 1, 512), dim=-1)
    matmul_case("decode PV 96 x 1x512x64", p,
                randn(8, 512, 12, 64).permute(0, 2, 1, 3), "M8",
                per=("decode", L))
    w_o, w_down = randn(d, d) * 0.03, randn(ff, d) * 0.02
    matmul_case("prefill wo 2048x768x768", x, w_o, "M8", library=True,
                per=("prefill", L))
    matmul_case("prefill w_down 2048x3072x768", randn(2048, ff), w_down,
                "M8", library=True, per=("prefill", L))
    matmul_case("decode wo 8x768x768", randn(8, d), w_o, "M8", library=True,
                per=("decode", L))
    matmul_case("decode w_down 8x3072x768", randn(8, ff), w_down, "M8",
                library=True, per=("decode", L))
    matmul_case("decode lm_head 8x768x32000", randn(8, d),
                randn(d, V) * 0.03, "M16", per=("decode", 1))
    matmul_case("wo 2048x768x768 M23", x, randn(d, d), "M23")
    matmul_case("wo 2048x768x768 M36", x, randn(d, d), "M36")
    matmul_case("ragged 1000x700x300 M23", randn(1000, 700),
                randn(700, 300), "M23")
    matmul_case("ragged 200x333x77 M52", randn(200, 333), randn(333, 77),
                "M52")

    wq = [randn(d, d) * 0.03 for _ in range(3)]
    proj_case("prefill QKV 2048x768 vs 3x768x768", x, wq, "M8", main=True,
              library=True, per=("prefill", L))
    wg = [randn(d, ff) * 0.03 for _ in range(2)]
    proj_case("prefill SwiGLU 2048x768 vs 2x768x3072", x, wg, "M8",
              gate="swiglu", per=("prefill", L))
    proj_case("decode SwiGLU 8x768 vs 2x768x3072", randn(8, d), wg, "M8",
              gate="swiglu", per=("decode", L))
    proj_case("decode QKV 8x768 vs 3x768x768", randn(8, d), wq, "M8",
              library=True, per=("decode", L))
    proj_case("QKV 512x768 M23", x[:512], wq, "M23")
    proj_case("QKV 512x768 M36", x[:512], wq, "M36")
    proj_case("SwiGLU+bias+res 300x768 M16", x[:300], wg, "M16",
              gate="swiglu", biases=[randn(ff), randn(ff)],
              residual=randn(300, ff))
    proj_case("1 out+bias+res 300x768 M23", x[:300], wq[:1], "M23",
              biases=[randn(d)], residual=randn(300, d))

    flash_case("prefill (8,256,12,64) causal", 8, 256, 256, 12, 64, "M16",
               "M8", True, main=True, per=("prefill", L))
    flash_case("(2,37,4,64) q_offset 63 causal", 2, 37, 100, 4, 64, "M23",
               "M16", True, q_offset=63)
    flash_case("(2,100,4,64) bidirectional", 2, 100, 100, 4, 64, "M8", "M8",
               False)
    flash_case("(1,70,2,64) causal M36/M52", 1, 70, 70, 2, 64, "M36", "M52",
               True)

    # the scheduler slice's kernels at the decode path's shapes: serve_default
    # pre-limbs at 2 limbs (lm_head M16), so M8 matmuls run with one extra
    # stored plane and read plane 0 only
    w_up, w_lm = randn(d, ff) * 0.03, randn(d, V) * 0.03
    decompose_case("lm_head 768x32000 L2", w_lm, 2, main=True)
    decompose_case("w_up 768x3072 L2", w_up, 2)
    decompose_case("w_down 3072x768 L2", w_down, 2)
    decompose_case("wo 768x768 L2", w_o, 2)
    decompose_case("ragged 37x300 L1", randn(37, 300), 1)
    decompose_case("ragged 37x300 L3", randn(37, 300), 3)
    x8 = randn(8, d)
    prelimbed_case("decode wq/wk/wv/wo 8x768x768 M8", x8, w_o, "M8", 2,
                   library=True, per=("tick", 4 * L))
    prelimbed_case("decode w_gate/w_up 8x768x3072 M8", x8, w_up, "M8", 2,
                   library=True, per=("tick", 2 * L))
    prelimbed_case("decode w_down 8x3072x768 M8", randn(8, ff), w_down, "M8",
                   2, main=True, library=True, per=("tick", L))
    prelimbed_case("decode lm_head 8x768x32000 M16", x8, w_lm, "M16", 2,
                   per=("tick", 1))
    prelimbed_case("decode wo M16 from 1 stored limb", x8, w_o, "M16", 1)
    # the formats of the mixed-traffic tick, homogeneous, at w_down's shape:
    # what each launch of the per-policy plan runs and what the mixed kernel
    # at the (3 limbs, order 2) envelope is compared with
    spec = dict(CUSTOM)
    custom = register_format(spec.pop("name"), **spec)
    x_ff = randn(8, ff)
    for m in ("M16", "M23", custom.name):
        prelimbed_case(f"decode w_down 8x3072x768 {m}", x_ff, w_down, m, 3)
    prelimbed_case("wo 512x768x768 M23", x[:512], randn(d, d), "M23", 3)
    prelimbed_case("wo 256x768x768 M36", x[:256], randn(d, d), "M36", 5)
    prelimbed_case("ragged 37x300x77 M16", randn(37, 300), randn(300, 77),
                   "M16", 3)
    decode_lengths = [int(n) for n in np.linspace(64, 288, 8)]
    paged_case(f"decode 8 slots H12 lengths {decode_lengths[0]}.."
               f"{decode_lengths[-1]}", decode_lengths, 12, 12, "M16", "M8",
               main=True, per=("tick", L))
    paged_case("GQA n_rep 2, a length-0 slot, mid-block ends",
               [0, 37, 16, 1, 100], 12, 6, "M16", "M8")
    paged_case("M23/M16 lengths 5, 250", [5, 250], 4, 4, "M23", "M16")

    # the mixed-lane kernels: the mixed-traffic tick's rows (two per mode,
    # envelope M23's 3 limbs, stored at 3), then M36, PAD_LANE rows, a
    # ragged shape and the generic instantiation
    tick_modes = [m for m in MODES for _ in range(2)]
    mixed_case("decode wq/wk/wv/wo 8x768x768 mixed", x8, w_o, tick_modes, 3,
               per=("mtick", 4 * L))
    mixed_case("decode w_gate/w_up 8x768x3072 mixed", x8, w_up, tick_modes,
               3, per=("mtick", 2 * L))
    mixed_case("decode w_down 8x3072x768 mixed", x_ff, w_down,
               tick_modes, 3, main=True, per=("mtick", L))
    mixed_case("decode lm_head 8x768x32000 mixed", x8, w_lm, tick_modes, 3,
               per=("mtick", 1))
    mixed_case("8x768x768 M8/M16/M23/M36/custom/PAD", x8, w_o,
               ["M8", "M16", "M23", "M36", custom.name, "PAD", "PAD", "M8"],
               5)
    mixed_case("ragged 13x300x77 M8/custom/PAD/M16 (generic)",
               randn(13, 300), randn(300, 77),
               ["M8", custom.name, "PAD", "M16"], 2)
    mixed_case("ragged 13x700x300 M16/M52/M8 from 5 stored", randn(13, 700),
               randn(700, 300), ["M16", "M52", "M8"], 5)
    slot_modes = [(m, m) for m in tick_modes]
    mixed_paged_case(f"decode 8 slots H12 lengths {decode_lengths[0]}.."
                     f"{decode_lengths[-1]} two per mode", decode_lengths,
                     12, 12, slot_modes, main=True, per=("mtick", L))
    mixed_paged_case(
        "GQA n_rep 2, a length-0 slot, mixed qk/pv",
        [0, 37, 16, 1, 100, 64, 5, 200], 12, 6,
        [("M16", "M8"), ("M8", "M8"), ("M23", "M16"), (custom.name, "M23"),
         ("M16", custom.name), ("M8", "M23"), ("M23", "M23"),
         ("M36", "M8")])

    # ---- 4. the main path -------------------------------------------------
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                      prelimb_weights=False,
                      policy=PrecisionPolicy.serve_default())
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in np.linspace(64, 256, 8)]
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
               for n in lengths]
    assert max(lengths) == 256
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] generate 8 prompts {lengths} x 32 new: {gen_s:.3f} s, "
        f"{8 * 32 / gen_s:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, "
        f"launches {launches}")
    if launches != EXPECTED:
        raise AssertionError(f"launches {launches} != expected {EXPECTED}")
    if len(outs) != 8 or any(len(o) != 32 for o in outs) or any(
            not 0 <= t < cfg.vocab for o in outs for t in o):
        raise AssertionError("generate returned malformed token streams")

    toks = eng.pad_prompts(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(toks, eng.make_cache())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    probe = eng.decode_throughput_probe(steps=16)
    ref_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                          matmul_backend="ref", prelimb_weights=False,
                          policy=PrecisionPolicy.serve_default())
    ref_logits, _ = ref_eng.prefill(toks, ref_eng.make_cache())
    a, b = logits[:, -1].double(), ref_logits[:, -1].double()
    rel = ((a - b).norm() / b.norm()).item()
    # the repo-wide convention: 4x the loosest format bound in the policy
    # (M8: 2^-6) on the tensor norm; ref runs unblocked attention and plain
    # adds, the kernels blocked attention and compensated order sums
    rel_tol = 4 * 2.0 ** -6
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[main] prefill {prefill_ms:.1f} ms; decode "
        f"{probe['ms_per_step']:.3f} ms/step {probe['tokens_per_s']:.1f} "
        f"tokens/s; last-token logits vs ref backend: rel {rel:.3e} "
        f"(tol {rel_tol:.3e}), top-1 agreement {agree:.3f}")
    if not torch.isfinite(logits).all() or rel > rel_tol:
        raise AssertionError("prefill logits disagree with the ref backend")
    report["main"] = dict(lengths=lengths, max_new=32, generate_s=gen_s,
                          tokens_per_s=8 * 32 / gen_s, prefill_ms=prefill_ms,
                          decode_ms_per_step=probe["ms_per_step"],
                          decode_tokens_per_s=probe["tokens_per_s"],
                          peak_bytes=peak, launches=launches,
                          logits_rel_vs_ref=rel, top1_agree_vs_ref=agree)

    # ---- 4b. the scheduler path -------------------------------------------
    policy = PrecisionPolicy.serve_default()
    n_req, sched_new = 16, 32
    sched_lengths = [int(n) for n in np.linspace(64, 256, n_req)]
    sched_prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
                     for n in sched_lengths]

    def requests(ids, spaced=True):
        return [ScheduledRequest(rid=i, prompt=sched_prompts[i],
                                 max_new=sched_new,
                                 arrival=2 * i if spaced else 0)
                for i in ids]

    del eng  # the static path's engine: its memory is not this path's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # resident before the path: the f32 weights and phase 3's inputs
    s_base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                        prelimb_weights=True, policy=policy)
    torch.cuda.synchronize()
    prelimb_s = time.perf_counter() - t0
    sched = ContinuousScheduler(s_eng, n_blocks=160, block_size=16)
    t1 = time.perf_counter()
    done = sched.run(requests(range(n_req)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    s_launches = kernels.launch_counts()
    s_plain = kernels.plain_call_counts()
    s_peak = torch.cuda.max_memory_allocated()
    stats = sched.stats()
    n_dec = stats["decode_launches"]
    want = {k: PER_PRELIMB.get(k, 0) + stats["prefills"] * PER_PREFILL.get(
        k, 0) + n_dec * PER_DECODE.get(k, 0) for k in kernels.KERNELS}
    log(f"[sched] {n_req} requests, prompts {sched_lengths[0]}.."
        f"{sched_lengths[-1]} x {sched_new} new, arrivals 2 ticks apart: "
        f"prelimb {prelimb_s * 1e3:.1f} ms, run {run_s:.3f} s, "
        f"{stats['useful_tokens'] / run_s:.1f} tokens/s, {stats['steps']} "
        f"ticks, {stats['prefills']} prefills, {n_dec} decode launches, "
        f"peak {s_peak / 2**30:.2f} GiB ({(s_peak - s_base) / 2**30:.2f} "
        f"GiB above the {s_base / 2**30:.2f} GiB resident before the path), "
        f"launches {s_launches}")
    if s_launches != want or any(s_plain.values()):
        raise AssertionError(f"scheduler launches {s_launches} != expected "
                             f"{want} (plain calls {s_plain})")
    out = {r.rid: r.out for r in done}
    if (len(out) != n_req or stats["completed"] != n_req
            or any(len(o) != sched_new for o in out.values())
            or any(not 0 <= t < cfg.vocab for o in out.values() for t in o)
            or stats["blocks_live"] != 0):
        raise AssertionError(f"scheduler run malformed: {stats}")
    lat = {k: stats[k] for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                                 "tpot_p95_ms", "itl_p50_ms", "itl_p95_ms",
                                 "queue_wait_p50_steps",
                                 "queue_wait_p95_steps")}
    log(f"[sched] latency {lat}")

    # port-internal bitwise: streams decoded in micro-batches of up to 8
    # equal their solo scheduled runs
    solo_ids = (0, n_req - 1)
    for i in solo_ids:
        solo = ContinuousScheduler(s_eng, n_blocks=160, block_size=16).run(
            requests([i], spaced=False))[0].out
        if solo != out[i]:
            first = next(t for t, (a, b) in enumerate(zip(solo, out[i]))
                         if a != b)
            raise AssertionError(f"request {i}: batched stream differs from "
                                 f"its solo run at token {first}")
    log(f"[sched] requests {list(solo_ids)}: batched streams == solo runs "
        f"bitwise")

    # one paged prefill's last-token logits against the ref backend
    def paged_prefill_logits(engine, prompt):
        pool = PagedKVPool(L, 24, 16, cfg.n_kv_heads, cfg.resolved_head_dim,
                           max_blocks_per_seq=32, device=dev)
        req = ScheduledRequest(rid=0, prompt=prompt, max_new=sched_new)
        if not prim.try_reserve(pool, req):
            raise AssertionError("the probe pool cannot hold the prompt")
        prefill_fn, _ = engine.paged_steps_for(policy)
        n = len(prompt)
        tokens = np.zeros((1, prim.pow2_at_least(n)), np.int64)
        tokens[0, :n] = prompt
        table = pool.table_row(req.blocks)[None, :prim.table_width(pool,
                                                                  [req])]
        logits, stat, _, _ = prefill_fn(
            engine.params, pool.k, pool.v, engine.to_device(table),
            engine.to_device(np.zeros((1,), np.int32)),
            engine.to_device(tokens), n - 1)
        return logits[0, 0].double()

    a = paged_prefill_logits(s_eng, sched_prompts[-1])
    b = paged_prefill_logits(ref_eng, sched_prompts[-1])
    s_rel = ((a - b).norm() / b.norm()).item()
    log(f"[sched] paged prefill ({sched_lengths[-1]} tokens) last-token "
        f"logits vs ref backend: rel {s_rel:.3e} (tol {rel_tol:.3e}), "
        f"top-1 {'agrees' if a.argmax() == b.argmax() else 'differs'}")
    if not torch.isfinite(a).all() or s_rel > rel_tol:
        raise AssertionError("paged prefill logits disagree with the ref "
                             "backend")

    # decode-only tick probe: 8 active slots (prompts 64..256), no arrivals
    probe = ContinuousScheduler(s_eng, n_blocks=160, block_size=16)
    for r in requests(range(0, n_req, 2), spaced=False):
        r.max_new = 64
        probe.submit(r)
    probe.step()  # admits all 8 (and runs the first tick)
    ticks = 16
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(ticks):
        probe.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t2) / ticks * 1e3
    log(f"[sched] decode tick (8 slots, no admissions): {tick_ms:.3f} ms, "
        f"{8e3 / tick_ms:.1f} tokens/s")
    report["sched"] = dict(
        lengths=sched_lengths, max_new=sched_new, prelimb_ms=prelimb_s * 1e3,
        run_s=run_s, tokens_per_s=stats["useful_tokens"] / run_s,
        stats=stats, launches=s_launches, peak_bytes=s_peak,
        resident_before_bytes=s_base,
        solo_bitwise=list(solo_ids), logits_rel_vs_ref=s_rel,
        decode_tick_ms=tick_ms)
    del s_eng, sched, probe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4c. mixed traffic: one partitioned-lane launch per tick ----------
    def mode_requests(ids, spaced=True, max_new=sched_new):
        reqs = requests(ids, spaced)
        for r in reqs:
            r.mode, r.max_new = MODES[r.rid % len(MODES)], max_new
        return reqs

    step_calls = {"mixed": 0, "bucket": 0}
    real_steps = {"mixed": prim.decode_mixed_step,
                  "bucket": prim.decode_bucket_step}

    def counted(kind):
        def step(*args, **kw):
            step_calls[kind] += 1
            return real_steps[kind](*args, **kw)
        return step

    prim.decode_mixed_step = counted("mixed")
    prim.decode_bucket_step = counted("bucket")
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                            prelimb_weights=True, policy=policy)
        m_sched = ContinuousScheduler(m_eng, n_blocks=160, block_size=16)
        m_done = m_sched.run(mode_requests(range(n_req)))
        torch.cuda.synchronize()
        m_run_s = time.perf_counter() - t0
        m_launches = kernels.launch_counts()
        m_plain = kernels.plain_call_counts()
    finally:
        prim.decode_mixed_step = real_steps["mixed"]
        prim.decode_bucket_step = real_steps["bucket"]
    m_stats = m_sched.stats()
    n_mixed, n_bucket = step_calls["mixed"], step_calls["bucket"]
    misses = m_eng.prelimb_cache_misses
    m_want = {k: misses * PER_PRELIMB.get(k, 0)
              + m_stats["prefills"] * PER_PREFILL.get(k, 0)
              + n_bucket * PER_DECODE.get(k, 0)
              + n_mixed * PER_MIXED.get(k, 0) for k in kernels.KERNELS}
    log(f"[mixed] {n_req} requests, modes {list(MODES)} in turn, prompts "
        f"{sched_lengths[0]}..{sched_lengths[-1]} x {sched_new} new, "
        f"arrivals 2 ticks apart: run {m_run_s:.3f} s (prelimbs included), "
        f"{m_stats['useful_tokens'] / m_run_s:.1f} tokens/s, "
        f"{m_stats['steps']} ticks, {m_stats['decode_launches']} decode "
        f"launches ({n_mixed} mixed, {n_bucket} bucket), launches per tick "
        f"{m_stats['launches_per_tick']}, {misses} prelimbs, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{m_launches} ({smi})")
    if m_stats["launches_per_tick"] != 1.0 or n_mixed == 0:
        raise AssertionError(f"mixed traffic is not one launch per tick: "
                             f"{m_stats}, {step_calls}")
    if m_launches != m_want or any(m_plain.values()):
        raise AssertionError(f"mixed launches {m_launches} != expected "
                             f"{m_want} (plain calls {m_plain})")
    m_out = {r.rid: r.out for r in m_done}
    if (len(m_out) != n_req or m_stats["completed"] != n_req
            or any(len(o) != sched_new for o in m_out.values())
            or any(not 0 <= t < cfg.vocab for o in m_out.values() for t in o)
            or m_stats["blocks_live"] != 0):
        raise AssertionError(f"mixed scheduler run malformed: {m_stats}")
    # two requests of different modes == their solo runs at their modes
    m_solo_ids = (0, n_req - 1)
    for i in m_solo_ids:
        solo = ContinuousScheduler(m_eng, n_blocks=160, block_size=16).run(
            mode_requests([i], spaced=False))[0].out
        if solo != m_out[i]:
            first = next(t for t, (a, b) in enumerate(zip(solo, m_out[i]))
                         if a != b)
            raise AssertionError(f"request {i} ({MODES[i % 4]}): mixed "
                                 f"stream differs from its solo run at "
                                 f"token {first}")
    log(f"[mixed] requests {list(m_solo_ids)} "
        f"({', '.join(MODES[i % 4] for i in m_solo_ids)}): mixed streams == "
        f"solo runs bitwise")

    # mixed decode-tick probe: 8 slots, two per mode, no admissions; the
    # one mixed launch against the per-policy plan on the same slots, in
    # turns (mixed, per-policy, mixed, per-policy), tokens equal
    def per_policy_plan(reqs, base):
        return [("bucket", g) for _, g in prim.bucket_by_policy(reqs, base)]

    mixed_plan = prim.decode_tick_plan
    probes = {}
    probe_ids = (0, 1, 2, 3, n_req - 4, n_req - 3, n_req - 2, n_req - 1)
    for kind in ("mixed", "per_policy"):
        pr = ContinuousScheduler(m_eng, n_blocks=160, block_size=16)
        for r in mode_requests(probe_ids, spaced=False, max_new=64):
            pr.submit(r)
        probes[kind] = pr

    def ticks_of(kind, n):
        prim.decode_tick_plan = (mixed_plan if kind == "mixed"
                                 else per_policy_plan)
        try:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                probes[kind].step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            return ms, sum(kernels.launch_counts().values()) / n
        finally:
            prim.decode_tick_plan = mixed_plan

    for kind in probes:  # admits all 8 (and runs the first tick)
        ticks_of(kind, 1)
    probe_ticks = 12
    tick = {"mixed": [], "per_policy": []}
    per_tick = {}
    for kind in ("mixed", "per_policy", "mixed", "per_policy"):
        ms, n_launch = ticks_of(kind, probe_ticks)
        tick[kind].append(ms)
        per_tick[kind] = n_launch
    busy_ms, busy_by_name = {}, {}
    for k in probes:
        total, names = device_busy_ms(lambda k=k: ticks_of(k, 4))
        busy_ms[k] = total / 4
        busy_by_name[k] = {n: ms / 4 for n, ms in names.items()}
        log(f"[mixed] {k} tick, device ms by name: "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in
                        list(busy_by_name[k].items())[:6]) + f" ({smi})")
    outs = {k: {r.rid: list(r.out) for r in pr._slots if r is not None}
            for k, pr in probes.items()}
    if outs["mixed"] != outs["per_policy"] or len(outs["mixed"]) != 8:
        raise AssertionError("mixed tick tokens differ from the per-policy "
                             "plan's")
    if per_tick["mixed"] != 97 or per_tick["per_policy"] != 4 * 97:
        raise AssertionError(f"kernel launches per tick {per_tick} != "
                             "97 (mixed) and 4 x 97 (per-policy)")
    log(f"[mixed] decode tick (8 slots, two per mode, no admissions), in "
        f"turns: mixed {tick['mixed'][0]:.3f} / {tick['mixed'][1]:.3f} ms "
        f"({per_tick['mixed']:.0f} kernel launches, kernels busy "
        f"{busy_ms['mixed']:.3f} ms); per-policy plan "
        f"{tick['per_policy'][0]:.3f} / {tick['per_policy'][1]:.3f} ms "
        f"({per_tick['per_policy']:.0f} launches, busy "
        f"{busy_ms['per_policy']:.3f} ms); tokens equal bitwise ({smi})")
    report["mixed"] = dict(
        modes=list(MODES), lengths=sched_lengths, max_new=sched_new,
        run_s=m_run_s, tokens_per_s=m_stats["useful_tokens"] / m_run_s,
        stats=m_stats, launches=m_launches, mixed_launches=n_mixed,
        bucket_launches=n_bucket, prelimb_misses=misses,
        solo_bitwise=list(m_solo_ids), tick_ms=tick,
        kernel_launches_per_tick=per_tick, kernel_busy_ms_per_tick=busy_ms,
        device_ms_per_tick_by_name=busy_by_name)

    # ---- 5. the kernels line -----------------------------------------------
    line = []
    for kname, (src, replaces) in SOURCES.items():
        rows = []
        for c in cases[kname]:
            ms = timed(c["fn"], torch)
            plain_ms = timed(c["plain"], torch)
            lib_ms = timed(c["library"], torch) if c["library"] else None
            b_ms, b_by = bound(c["ops"], c["bytes"],
                               c.get("peak", PEAK_OPS))
            row = {k: v for k, v in c.items()
                   if k not in ("fn", "plain", "library", "peak")}
            row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"[time] {kname} {c['case']} {c['fmt']}: {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by})")
        main_row = next(r for r in rows if r["main"])
        by_path = {"generate": launches[kname],
                   "scheduler": s_launches[kname],
                   "mixed": m_launches[kname]}
        line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[LAUNCH_PATH.get(kname, "generate")],
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in checks[kname]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "main_case": main_row["case"]})
        report.setdefault("cases", {})[kname] = rows
    # kernel time of one prefill and one decode step at these shapes: the
    # device-busy lower bound the measured step times are read against
    busy = {"prefill": 0.0, "decode": 0.0, "tick": 0.0, "mtick": 0.0}
    for rows in report["cases"].values():
        for r in rows:
            if r["per"]:
                busy[r["per"][0]] += r["ms"] * r["per"][1]
    report["main"]["kernel_ms_per_prefill"] = busy["prefill"]
    report["main"]["kernel_ms_per_decode_step"] = busy["decode"]
    report["sched"]["kernel_ms_per_tick"] = busy["tick"]
    report["mixed"]["kernel_ms_per_tick_from_cases"] = busy["mtick"]
    log(f"[busy] kernel ms per prefill {busy['prefill']:.3f} "
        f"(measured {report['main']['prefill_ms']:.3f} ms); per decode step "
        f"{busy['decode']:.3f} (measured "
        f"{report['main']['decode_ms_per_step']:.3f} ms); per scheduler "
        f"decode tick {busy['tick']:.3f} (measured {tick_ms:.3f} ms, idle "
        f"share {max(0.0, 1 - busy['tick'] / tick_ms):.3f}); per mixed tick "
        f"{busy['mtick']:.3f} (profiled {busy_ms['mixed']:.3f}, measured "
        f"{tick['mixed'][0]:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms['mixed'] / tick['mixed'][0]):.3f}; "
        f"per-policy plan: profiled {busy_ms['per_policy']:.3f}, measured "
        f"{tick['per_policy'][0]:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms['per_policy'] / tick['per_policy'][0]):.3f})"
        f" ({smi})")
    report["kernels"] = line
    report["checks"] = checks
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": line}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
