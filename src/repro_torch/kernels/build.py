"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers: a build takes seconds, not minutes)
under ``build/torch_kernels/`` at the root of the checkout.  The library's
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built when this module
is imported: :func:`load` builds at first use, :func:`build` builds several
sources in parallel (one ``nvcc`` process each, all started together).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("mp_matmul", "mp_attention")

# sm_90a (not sm_90): the Hopper-only instructions exist only for that
# target.  No --use_fast_math: expf and the divisions stay accurate.
# --fmad=false: a*b+c outside explicit fmaf() calls rounds twice, as the
# PyTorch plain versions do.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-lineinfo", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildReport:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas: str          # nvcc's -Xptxas -v report ("" when reused)


_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, BuildReport]:
    """Compile the named sources, all ``nvcc`` processes at once.  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = BuildReport(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                            f"{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        reports[name] = BuildReport(name, out, seconds, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name].path
        lib = _LOADED.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
