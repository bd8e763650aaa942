"""IEEE exception signals — the paper's Zero / Infinity / NaN / Denormal
outputs (port of ``repro.core.classify``).

The FPGA raises four wires; the framework raises four boolean masks plus
aggregate health counters that the fault-tolerant trainer consumes (a NaN
blow-up triggers checkpoint rollback and precision escalation).  The masks
are read off the f32 bit patterns, so subnormals are seen as subnormals
whether or not the arithmetic around them flushes them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch import tree as tree_lib


class ExceptionSignals(NamedTuple):
    zero: torch.Tensor      # exactly ±0
    infinity: torch.Tensor  # ±inf
    nan: torch.Tensor       # NaN
    denormal: torch.Tensor  # subnormal (biased exponent 0, significand != 0)


def classify(x: torch.Tensor) -> ExceptionSignals:
    """Bit-pattern classification, exactly as the paper specifies:
    Zero:     exponent+bias == 0 and significand == 0
    Infinity: exponent+bias == max and significand == 0
    NaN:      exponent+bias == max and significand != 0
    Denormal: exponent+bias == 0 and significand != 0"""
    bits = x.float().contiguous().view(torch.int32)
    exp = (bits >> 23) & 0xFF
    sig = bits & 0x7FFFFF
    exp_zero, exp_max, sig_zero = exp == 0, exp == 0xFF, sig == 0
    return ExceptionSignals(zero=exp_zero & sig_zero,
                            infinity=exp_max & sig_zero,
                            nan=exp_max & ~sig_zero,
                            denormal=exp_zero & ~sig_zero)


def exception_counts(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    s = classify(x)
    return {"zero": s.zero.sum(), "infinity": s.infinity.sum(),
            "nan": s.nan.sum(), "denormal": s.denormal.sum()}


def all_finite(tree) -> torch.Tensor:
    """True iff every floating leaf of the tree (nested dicts, lists,
    tuples) is finite (the trainer's health check): a 0-d bool tensor on
    the leaves' device, read without a host sync."""
    ok = None
    for leaf in tree_lib.leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            fin = torch.isfinite(leaf).all()
            ok = fin if ok is None else ok & fin
    return torch.tensor(True) if ok is None else ok
