"""The paper's six precision modes as a view of the format registry (port
of ``repro.core.modes``; no JAX in it, but the port keeps its own copy over
its own registry).

Paper mapping (Arish & Sharma 2019, Table I):
    Mode 1 (000) AUTO  -> operand analysis selects among the static modes
    Mode 2 (001) M8    -> 8-bit mantissa   -> 1 bf16 limb,  1 product
    Mode 3 (010) M16   -> 16-bit mantissa  -> 2 limbs, order cut: 3 products
    Mode 4 (011) M23   -> 23-bit mantissa  -> 3 limbs, 6 products
    Mode 5 (100) M36   -> 36-bit mantissa  -> 5 limbs, 15 products
    Mode 6 (101) M52   -> 52-bit mantissa  -> 7 limbs, 28 products

A bf16 limb carries about 8 mantissa bits (7 stored and the hidden 1) with
the full f32 exponent range.  The order cut drops limb products
``li*mj`` with ``i + j > max_order``.  New code should use the
``repro_torch.mp`` facade: ``mp.register_format`` mints formats beyond this
table and ``mp.resolve`` canonicalizes any spelling.
"""
from __future__ import annotations

from repro_torch.core.formats import (  # noqa: F401  (re-exported)
    FormatLike,
    MPFormat,
    PrecisionMode,
    available_formats,
    get_format,
    is_auto,
    register_format,
    resolve,
    unregister_format,
)

# the JAX package's v1 name for the format dataclass
ModeSpec = MPFormat

# the static mode table, keyed by the paper enum: views of the registry's
# built-in entries (``MODE_TABLE[M16] is resolve("M16")``)
MODE_TABLE = {
    m: get_format(m.name) for m in PrecisionMode if m != PrecisionMode.AUTO
}

STATIC_MODES = tuple(MODE_TABLE)  # ordered M8..M52 (ascending cost)


def spec(mode: FormatLike) -> MPFormat:
    """Resolve a mode, name or format to its MPFormat (AUTO raises)."""
    return resolve(mode)


def mode_for_limbs(n_limbs: int) -> PrecisionMode:
    """Smallest built-in mode whose limb count covers ``n_limbs``
    significant limbs (AUTO's built-in ladder; custom formats take part
    through the AUTO candidates)."""
    for m in STATIC_MODES:
        if MODE_TABLE[m].n_limbs >= n_limbs:
            return m
    return PrecisionMode.M52


def validate_mode_pair(mode_a: FormatLike, mode_b: FormatLike) -> FormatLike:
    """Paper: 'mode select bits for both inputs must be the same, otherwise
    a mode select error signal will be generated'.  Tensor-granularity
    analogue: both operands must carry the same requested mode."""
    if is_auto(mode_a) != is_auto(mode_b) or (
            not is_auto(mode_a) and resolve(mode_a) != resolve(mode_b)):
        raise ValueError(
            f"mode-select error: operand modes disagree ({mode_a!r} vs "
            f"{mode_b!r})")
    return mode_a
