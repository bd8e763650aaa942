#!/usr/bin/env python3
"""Time this tree's kernels against other versions of one of their CUDA
sources on one card, and check that they give the same bits.

    python3 compare_kernels.py OTHER.cu [OTHER.cu ...]
    python3 compare_kernels.py --source mp_attention OTHER.cu [...]

``--source`` names the source (``mp_matmul``, the default: the limb
matmuls; ``mp_attention``: paged and mixed paged decode attention and flash
attention).  This tree's ``csrc/<source>.cu`` and each other one are
compiled with the tree's flags, all at once, into
``build/compare_kernels/``; every case of the source runs on each library
through the port's launch marshalling, timed with ``chip_smoke.py``'s ``ms``
timer (calls queued behind a sleep kernel), and each other version's output
is compared with this tree's bit for bit; the SM clock and power draw are
sampled while each case of this tree runs back to back.  A version
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


def matmul_cases(torch, randn):
    """The model's prefill and decode shapes (paper-mpfp-100m), as in
    chip_smoke.py's [time] lines."""
    from repro_torch.core.formats import resolve as f
    from repro_torch.kernels import mp_matmul as mm

    x, a_ff = randn(2048, 768), randn(2048, 3072)
    w_o, w_down = randn(768, 768) * 0.03, randn(3072, 768) * 0.02
    w_lm = randn(768, 32000) * 0.03
    wq = [randn(768, 768) * 0.03 for _ in range(3)]
    wg = [randn(768, 3072) * 0.03 for _ in range(2)]
    qh = randn(8, 1, 12, 64).permute(0, 2, 1, 3)
    kt = randn(8, 512, 12, 64).permute(0, 2, 1, 3).transpose(-1, -2)
    xa7, wl7 = mm.mp_decompose(x, 7), mm.mp_decompose(w_lm, 7)
    return {
        "prefill w_down 2048x3072x768 M8": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, a_ff, w_down, f("M8"))),
        "prefill wo 2048x768x768 M8": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, x, w_o, f("M8"))),
        "prefill lm_head 2048x768x32000 M16": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, x, w_lm, f("M16"))),
        "prefill wo 2048x768x768 M23": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, x, w_o, f("M23"))),
        "prefill QKV 2048x768 vs 3x768x768 M8": lambda lib, st: (
            mm.launch_fused_proj(lib, st, x, wq, f("M8"))),
        "prefill SwiGLU 2048x768 vs 2x768x3072 M8": lambda lib, st: (
            mm.launch_fused_proj(lib, st, x, wg, f("M8"), gate="swiglu")),
        "decode lm_head 8x768x32000 M16": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, x[:8], w_lm, f("M16"))),
        "decode w_down 8x3072x768 M8": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, a_ff[:8], w_down, f("M8"))),
        "decode QK 96 x 1x64x512 M16": lambda lib, st: (
            mm.launch_fused_matmul(lib, st, qh, kt, f("M16"))),
        "DD lm_head 2048x768x32000 M52": lambda lib, st: (
            mm.launch_both_prelimbed_matmul(lib, st, xa7, wl7, f("M52"))),
    }


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
    parser.add_argument("others", nargs="+", type=Path,
                        help="other versions of csrc/<source>.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import device_ms
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "compare_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"this tree": build.CSRC / f"{args.source}.cu"}
    sources.update((str(o), o) for o in args.others)
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         str(out_dir / f"{args.source}_{i}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (name, src) in enumerate(sources.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{args.source}_{i}.so"))
        for entry, (regs, st, ld) in sorted(build.ptxas_summary(log).items()):
            print(f"[ptxas] {name}: {entry[:90]} regs {regs} spill {st}/{ld}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cases = (matmul_cases if args.source == "mp_matmul"
             else attention_cases)(torch, randn)
    stream = torch.cuda.current_stream().cuda_stream
    for case, fn in cases.items():
        ref = fn(libs["this tree"], stream)
        for name, lib in libs.items():
            out = fn(lib, stream)
            torch.cuda.synchronize()
            ms, ahead = device_ms(lambda: fn(lib, stream), torch)
            same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
            print(f"[compare] {name}: {case}: {ms:.4f} ms"
                  + ("" if ahead else " (host behind the card)")
                  + (f"; {clocks_while(lambda: fn(lib, stream), torch)}"
                     if name == "this tree" else "")
                  + ("" if name == "this tree" else
                     f", bitwise this tree's: {same}"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
