"""Custom floating-point format registry — the paper's mode table as an *open*
runtime interface (PyTorch port; the same registry as ``repro.core.formats``).

An :class:`MPFormat` describes any limb-decomposed multiplier configuration,
the paper's modes are the *built-in* entries of one process-wide registry,
and :func:`register_format` mints new formats at run time that are usable
everywhere a built-in mode is — dispatch, policies and the CUDA kernels.

    from repro_torch.core import formats
    M30 = formats.register_format("M30", mantissa_bits=30, n_limbs=4,
                                  max_order=3)
    mp_matmul(a, b, M30)                 # or mp_matmul(a, b, "M30")

The port keeps its own copy of this module: importing the JAX package pulls
in jax, which the port never imports.  Everything downstream keys on the
*format* (via :func:`resolve`), never on the legacy ``PrecisionMode`` enum,
which survives only as the paper's 3-bit select code and the ``AUTO``
sentinel.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, Optional, Tuple, Union


class PrecisionMode(enum.IntEnum):
    """The paper's six Table-I select codes (built-in formats + AUTO).

    Custom formats registered at run time live outside this enum — it is kept
    for the paper mapping and for backward compatibility; every internal code
    path keys on :class:`MPFormat` via :func:`resolve`.
    """

    AUTO = 0  # paper mode 1 (000)
    M8 = 1    # paper mode 2 (001)
    M16 = 2   # paper mode 3 (010)
    M23 = 3   # paper mode 4 (011)
    M36 = 4   # paper mode 5 (100)
    M52 = 5   # paper mode 6 (101)

    @property
    def mode_bits(self) -> str:
        """The 3 mode-select bits from the paper's 67-bit operand format."""
        return format(int(self), "03b")


@dataclasses.dataclass(frozen=True)
class MPFormat:
    """One multiplier configuration: a named, registrable precision format.

    Hashable and immutable so it can key caches and dispatch.  ``name`` is
    the registry identity — two formats with the same name must have
    identical parameters (enforced by ``register_format``).
    """

    name: str
    mantissa_bits: int      # nominal operand mantissa width
    n_limbs: int            # bf16 limbs per operand
    max_order: int          # keep limb products with i + j <= max_order

    # relative-error budget asserted by tests (builtins: empirically
    # calibrated, see tests/test_accuracy_modes.py; modes >=M36 are bounded by
    # compensated fp32 accumulation, not the nominal width — DESIGN.md §2)
    rel_err_bound: float = 0.0
    mode_bits: str = ""     # paper 3-bit select code ("" for custom formats)

    @property
    def n_products(self) -> int:
        """Number of limb products = |{(i,j): i,j < n_limbs, i+j <= max_order}|."""
        return sum(
            1
            for i in range(self.n_limbs)
            for j in range(self.n_limbs)
            if i + j <= self.max_order
        )

    @property
    def n_orders(self) -> int:
        """Number of distinct limb-product orders (= max_order + 1): the f32
        accumulators the fused matmul kernels keep per output."""
        return self.max_order + 1

    @property
    def products(self) -> Tuple[Tuple[int, int], ...]:
        """The kept (i, j) limb-product index pairs, sorted by descending order

        (highest order first so accumulation runs small-magnitude -> large,
        the carry-save-adder analogue, see DESIGN.md)."""
        pairs = [
            (i, j)
            for i in range(self.n_limbs)
            for j in range(self.n_limbs)
            if i + j <= self.max_order
        ]
        return tuple(sorted(pairs, key=lambda p: -(p[0] + p[1])))

    @property
    def flops_factor(self) -> float:
        """FLOP multiplier relative to a single bf16 matmul of the same
        shape."""
        return float(self.n_products)

    @property
    def mode(self) -> Optional[PrecisionMode]:
        """The paper enum value for built-in formats, None for custom ones."""
        try:
            return PrecisionMode[self.name]
        except KeyError:
            return None


FormatLike = Union[MPFormat, PrecisionMode, int, str]

_LOCK = threading.Lock()
_FORMATS: Dict[str, MPFormat] = {}


def _default_rel_err_bound(mantissa_bits: int, n_limbs: int,
                           max_order: int) -> float:
    """Conservative default budget for a registered format.

    Effective precision is capped by the operand width, the limbs actually
    carried, and the orders actually kept; fp32 accumulation floors the
    achievable relative error near 2^-21 regardless of nominal width."""
    effective = min(mantissa_bits, 8 * n_limbs, 8 * (max_order + 1))
    return 2.0 ** -min(effective - 4, 21)


def register_format(
    name: str,
    *,
    mantissa_bits: int,
    n_limbs: int,
    max_order: Optional[int] = None,
    rel_err_bound: Optional[float] = None,
    _mode_bits: str = "",
) -> MPFormat:
    """Mint a new runtime precision format (the paper's reconfigurability
    extended past its 3-bit mode space).

    Returns the registered :class:`MPFormat`.  Re-registering an identical
    format is a no-op (idempotent — serving policy payloads may carry format
    definitions); re-registering a *different* format under an existing name
    raises.
    """
    if not name or not name.replace("_", "").isalnum():
        raise ValueError(f"format name must be alphanumeric, got {name!r}")
    if is_auto(name):
        raise ValueError(
            "'AUTO' is the reserved dispatch sentinel (paper mode 1), not a "
            "registrable static format")
    if n_limbs < 1 or n_limbs > 8:
        raise ValueError(f"n_limbs must be in [1, 8], got {n_limbs}")
    if max_order is None:
        max_order = 2 * (n_limbs - 1)
    if not 0 <= max_order <= 2 * (n_limbs - 1):
        raise ValueError(
            f"max_order must be in [0, {2 * (n_limbs - 1)}] for "
            f"{n_limbs} limbs, got {max_order}")
    if mantissa_bits < 1:
        raise ValueError(f"mantissa_bits must be >= 1, got {mantissa_bits}")
    if rel_err_bound is None:
        rel_err_bound = _default_rel_err_bound(mantissa_bits, n_limbs,
                                               max_order)
    fmt = MPFormat(name, mantissa_bits, n_limbs, max_order,
                   rel_err_bound=rel_err_bound, mode_bits=_mode_bits)
    with _LOCK:
        existing = _FORMATS.get(name)
        if existing is not None:
            if existing != fmt:
                raise ValueError(
                    f"format {name!r} already registered with different "
                    f"parameters: {existing}")
            return existing  # idempotent: keep one canonical object per name
        _FORMATS[name] = fmt
    return fmt


def unregister_format(name: str) -> None:
    """Remove a custom format.  Built-ins are protected — unregistering M16
    would orphan every default policy in the process."""
    if name in _BUILTIN_NAMES:
        raise ValueError(f"cannot unregister built-in format {name!r}")
    with _LOCK:
        _FORMATS.pop(name, None)


def get_format(name: str) -> MPFormat:
    try:
        return _FORMATS[name]
    except KeyError:
        raise KeyError(
            f"unknown format {name!r}; registered: {available_formats()}"
        ) from None


def available_formats() -> Tuple[str, ...]:
    return tuple(_FORMATS)


def builtin_formats() -> Tuple[str, ...]:
    """Names of the immutable builtin ladder (M8..M52) — callers that treat
    custom registered formats differently (e.g. the serving escalation
    ladder) key off this set."""
    return tuple(sorted(_BUILTIN_NAMES))


def format_def(fmt: MPFormat) -> Dict[str, object]:
    """Wire-form definition of a format (the payload ``register_format``
    accepts back) — policies/contexts embed these so JSON payloads that
    reference custom formats are self-contained across processes."""
    return {
        "mantissa_bits": fmt.mantissa_bits,
        "n_limbs": fmt.n_limbs,
        "max_order": fmt.max_order,
        "rel_err_bound": fmt.rel_err_bound,
    }


def collect_defs(names) -> Dict[str, Dict[str, object]]:
    """Definitions for the *custom* (non-built-in) formats among ``names``
    ('AUTO'/None entries skipped) — the shared embed step of every JSON wire
    format (policy and context)."""
    out: Dict[str, Dict[str, object]] = {}
    for name in names:
        if name is None or is_auto(name):
            continue
        fmt = get_format(name)
        if fmt.mode is None:
            out[name] = format_def(fmt)
    return out


def register_defs(defs) -> None:
    """Register embedded wire-format definitions (inverse of
    ``collect_defs``; idempotent, conflicting redefinitions raise)."""
    for name, f in (defs or {}).items():
        register_format(name, mantissa_bits=f["mantissa_bits"],
                        n_limbs=f["n_limbs"], max_order=f["max_order"],
                        rel_err_bound=f.get("rel_err_bound"))


def is_auto(f: object) -> bool:
    """True for the AUTO dispatch sentinel in any spelling."""
    if f is PrecisionMode.AUTO:
        return True
    if isinstance(f, str) and f.upper() == "AUTO":
        return True
    return isinstance(f, int) and not isinstance(f, MPFormat) \
        and int(f) == int(PrecisionMode.AUTO)


def resolve(f: FormatLike) -> MPFormat:
    """Canonicalize any format spelling to its registered :class:`MPFormat`.

    Accepts an MPFormat (identity), a registered name string, or a legacy
    ``PrecisionMode``/int.  This is the single coercion point every backend,
    kernel, and autotune key goes through — formats, not enums, key the
    system.  AUTO is a dispatch sentinel, not a static format: resolve it
    first (core.auto.select_mode_index) or call mp_matmul with mode=AUTO.
    """
    if isinstance(f, MPFormat):
        return f
    if is_auto(f):
        raise ValueError(
            "AUTO is a dispatch mode, not a static format; resolve a static "
            "format first (core.auto.select_mode_index) or call mp_matmul "
            "with mode=AUTO")
    if isinstance(f, str):
        return get_format(f)
    if isinstance(f, (int, PrecisionMode)):
        return get_format(PrecisionMode(f).name)
    raise TypeError(f"cannot resolve {f!r} to a precision format")


# ---------------------------------------------------------------------------
# Built-ins: the paper's Table I as the seed entries of the registry.
# ---------------------------------------------------------------------------
_BUILTIN_SPECS = (
    # name, mantissa_bits, n_limbs, max_order, rel_err_bound
    ("M8", 8, 1, 0, 2.0**-6),
    ("M16", 16, 2, 1, 2.0**-13),
    ("M23", 23, 3, 2, 2.0**-19),
    ("M36", 36, 5, 4, 2.0**-22),
    ("M52", 52, 7, 6, 2.0**-22),
)
_BUILTIN_NAMES = frozenset(s[0] for s in _BUILTIN_SPECS)

for _name, _bits, _limbs, _order, _bound in _BUILTIN_SPECS:
    register_format(_name, mantissa_bits=_bits, n_limbs=_limbs,
                    max_order=_order, rel_err_bound=_bound,
                    _mode_bits=PrecisionMode[_name].mode_bits)
del _name, _bits, _limbs, _order, _bound
