"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers: a build takes seconds, not minutes)
under ``build/torch_kernels/`` at the root of the checkout.  The library's
file name carries a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is built when this module
is imported: :func:`load` builds at first use, :func:`build` builds several
sources in parallel (one ``nvcc`` process each, all started together).

    python -m repro_torch.kernels.build --against OTHER/csrc

compiles these sources and another version of them with the same flags and
prints every kernel entry whose registers or spills differ (run it on the
machine with the card: it needs ``nvcc``).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("mp_matmul", "mp_matmul_hopper", "mp_attention")

# sm_90a (not sm_90): the Hopper-only instructions exist only for that
# target.  No --use_fast_math: expf and the divisions stay accurate.
# --fmad=false: every a*b+c rounds twice, as the PyTorch plain versions
# do.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-lineinfo", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildReport:
    name: str
    path: Path
    seconds: float      # 0.0 when an earlier build was reused
    ptxas: str          # nvcc's -Xptxas -v report (kept beside the library)


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
    # the headers a source may include (csrc/*.cuh) are part of its hash
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built library of ``csrc/<name>.cu``
    (builds it first if needed)."""
    return build([name])[name].ptxas


def _nvcc(src: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(out),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str] = SOURCES) -> Dict[str, BuildReport]:
    """Compile the named sources, all ``nvcc`` processes at once.  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = _log_path(out)
            reports[name] = BuildReport(
                name, out, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = _nvcc(CSRC / f"{name}.cu", tmp)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                            f"{log}")
            continue
        _log_path(tmp).write_text(log)
        os.replace(_log_path(tmp), _log_path(out))
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


# the per-file tag nvcc gives the anonymous namespace of a mangled entry name
_ANON_TAG = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def ptxas_summary(log_text: str) -> Dict[str, List[int]]:
    """[registers, spill stores, spill loads] per kernel entry of an
    ``-Xptxas -v`` report, keyed by the mangled entry name without the
    anonymous-namespace tag (which changes with the file's contents), so
    two versions of a source compare entry by entry."""
    merged: Dict[str, List[int]] = {}
    entry = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _ANON_TAG.sub("", m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            merged.setdefault(entry, [0, 0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            merged.setdefault(entry, [0, 0, 0])[1:] = [int(m.group(1)),
                                                       int(m.group(2))]
    return merged


def compare_registers(other_csrc: Path) -> int:
    """Compile :data:`SOURCES` from here and from ``other_csrc`` with the
    same flags, print the entries of the other version whose registers or
    spills differ here, and return their number."""
    out_dir = BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {(tag, name): _nvcc(base / f"{name}.cu",
                                out_dir / f"{tag}_{name}.so")
             for tag, base in (("here", CSRC), ("other", Path(other_csrc)))
             for name in SOURCES if (base / f"{name}.cu").exists()}
    regs: Dict[str, Dict[str, List[int]]] = {"here": {}, "other": {}}
    for (tag, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag} {name}.cu failed:\n{log}")
        regs[tag].update(ptxas_summary(log))
    differ = 0
    for entry, theirs in sorted(regs["other"].items()):
        ours = regs["here"].get(entry)
        if ours != theirs:
            differ += 1
            print(f"[regs] {entry[:100]}: other {theirs}, here {ours}")
    print(f"[regs] {len(regs['other']) - differ} of {len(regs['other'])} "
          f"entries of the other version keep their registers and spills; "
          f"{len(set(regs['here']) - set(regs['other']))} entries are new "
          f"here")
    return differ


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", required=True, type=Path,
                        help="csrc directory of another version")
    compare_registers(parser.parse_args().against)
