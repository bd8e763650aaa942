"""Per-layer-class precision policy — how a *framework* consumes the paper's
run-time modes (PyTorch port's copy of ``repro.core.policy``; the JSON wire
form is identical, so a policy written by either package loads in the other).

``PrecisionPolicy`` maps op-class *patterns* to formats, and every model layer
resolves its matmuls through it, so an entire network's precision is
reconfigured with one object:

    PrecisionPolicy({"moe_*": "M8", "lm_head": "M23", "*": "M16"})

with per-class backward overrides (dgrad/wgrad may run at different formats
than fwd; the port's forward-only ops do not read them yet) and a lossless
``to_json``/``from_json`` wire format, so the serving engine can hot-swap
precision (serve/engine.set_policy).

Resolution precedence, most specific wins:
  1. an exact user rule for the op class;
  2. the user glob pattern with the most literal (non-wildcard) characters
     (ties: earliest declared);
  3. the built-in defaults (moe_router/lm_head -> M23, ``*`` -> M16), same
     ordering rules — consulted only when NO user rule matches.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.core import formats as formats_lib
from repro_torch.core.formats import (
    FormatLike,
    MPFormat,
    PrecisionMode,
    available_formats,
    get_format,
    is_auto,
    resolve,
)

# resolved value of a policy slot: a concrete format or the AUTO sentinel
ResolvedFormat = Union[MPFormat, PrecisionMode]


def _norm(f: Optional[FormatLike]) -> Optional[str]:
    """Normalize a format spelling to its registry name ('AUTO' for AUTO).

    Policies store *names* (the stable wire identity), so a format object is
    only accepted when the registry resolves its name back to an equal entry
    — an unregistered hand-built MPFormat would otherwise pass construction
    and blow up with KeyError at the first ``.mode()`` lookup, far from the
    mistake."""
    if f is None:
        return None
    if is_auto(f):
        return "AUTO"
    fmt = resolve(f)
    if fmt.name not in available_formats() or get_format(fmt.name) != fmt:
        raise ValueError(
            f"format {fmt.name!r} is not registered (or differs from the "
            f"registered entry); call formats.register_format first")
    return fmt.name


def _denorm(name: Optional[str]) -> Optional[ResolvedFormat]:
    if name is None:
        return None
    if name == "AUTO":
        return PrecisionMode.AUTO
    return get_format(name)


@dataclasses.dataclass(frozen=True)
class OpRule:
    """Formats for one op-class pattern: fwd + optional backward overrides
    (None inherits: dgrad/wgrad <- the policy-wide default <- fwd)."""

    fwd: str
    dgrad: Optional[str] = None
    wgrad: Optional[str] = None


def _to_rule(value) -> OpRule:
    if isinstance(value, OpRule):
        # re-normalize: hand-built rules carry raw names that must pass the
        # same registration check as every other construction path
        rule = OpRule(_norm(value.fwd), _norm(value.dgrad),
                      _norm(value.wgrad))
    elif isinstance(value, Mapping):
        extra = set(value) - {"fwd", "dgrad", "wgrad"}
        if extra:
            raise ValueError(f"unknown rule keys {sorted(extra)}")
        rule = OpRule(_norm(value["fwd"]), _norm(value.get("dgrad")),
                      _norm(value.get("wgrad")))
    elif isinstance(value, tuple):
        fwd, *rest = value
        rule = OpRule(_norm(fwd), *[_norm(v) for v in rest])
    else:
        rule = OpRule(_norm(value))
    # fail at construction, not at the first lookup / backward trace:
    if rule.fwd is None:
        raise ValueError("a policy rule must specify a fwd format")
    if "AUTO" in (rule.dgrad, rule.wgrad):
        raise ValueError(
            "dgrad/wgrad must be static formats (AUTO analyzes *operands*; "
            "backward passes inherit a concrete format)")
    return rule


def _specificity(pattern: str) -> int:
    return sum(1 for ch in pattern if ch not in "*?[]")


def _best_match(rules: Tuple[Tuple[str, OpRule], ...], op_class: str
                ) -> Optional[OpRule]:
    """Exact beats any glob; globs rank by literal count, ties earliest
    (the match-strength variant below is the single implementation)."""
    return _best_match_key(rules, op_class)[0]


# built-in tier: consulted only when no user rule matches (v1 field defaults)
DEFAULT_RULES: Tuple[Tuple[str, OpRule], ...] = (
    ("moe_router", OpRule("M23")),   # routing is precision-sensitive
    ("lm_head", OpRule("M23")),      # logits feed the loss
    ("*", OpRule("M16")),
)

# Attention-kernel op classes and their legacy einsum aliases.  The fused
# flash-attention path resolves its two contractions as ``attn_qk`` (QK^T)
# and ``attn_pv`` (P·V); v1/v2 policies configured those einsums through
# ``attn_logits`` / ``attn_out``, so each new class falls back to its alias:
# an exact rule for the new class wins outright; otherwise the more *specific*
# match between the new-class pattern match and the alias match wins, with
# ties going to the alias — a policy written before the split resolves
# exactly as it always did (``{"attn_logits": "M23", "*": "M8"}`` still puts
# QK^T at M23), while new policies can glob ``attn_qk``/``attn_pv`` like any
# other op class.
ATTN_OP_ALIASES: Dict[str, str] = {"attn_qk": "attn_logits",
                                   "attn_pv": "attn_out"}


def _best_match_key(rules: Tuple[Tuple[str, OpRule], ...], op_class: str):
    """Like :func:`_best_match` but also returns the match strength key
    (exact matches rank above any glob)."""
    best, best_key = None, None
    for i, (pattern, rule) in enumerate(rules):
        if pattern == op_class:
            return rule, (float("inf"), 0)
        if fnmatch.fnmatchcase(op_class, pattern):
            key = (_specificity(pattern), -i)
            if best_key is None or key > best_key:
                best, best_key = rule, key
    return best, best_key

class PrecisionPolicy:
    """Glob-resolved mapping from op-class names to precision formats.

    Construct from a rules mapping, v1-style keyword fields, or both (kwargs
    are exact rules layered over the mapping)::

        PrecisionPolicy({"moe_*": "M8", "*": "M16"}, lm_head="M23")
        PrecisionPolicy(qkv=PrecisionMode.M8)            # v1 spelling
        PrecisionPolicy({"ffn": {"fwd": "M8", "wgrad": "M23"}})

    ``bwd_dgrad``/``bwd_wgrad`` set policy-wide backward defaults; per-rule
    ``dgrad``/``wgrad`` entries override them per class.  Immutable and
    hashable (safe to key step caches).
    """

    __slots__ = ("_rules", "_bwd_dgrad", "_bwd_wgrad")

    def __init__(self, rules: Optional[Mapping[str, object]] = None, *,
                 bwd_dgrad: Optional[FormatLike] = None,
                 bwd_wgrad: Optional[FormatLike] = None,
                 **op_classes: FormatLike):
        # kwargs are exact rules layered OVER the mapping: a same-pattern
        # kwarg replaces the mapping's entry in place (order preserved)
        merged = {p: _to_rule(v) for p, v in (rules or {}).items()}
        for name, value in op_classes.items():
            merged[name] = _to_rule(value)
        object.__setattr__(self, "_rules", tuple(merged.items()))
        object.__setattr__(self, "_bwd_dgrad", _norm(bwd_dgrad))
        object.__setattr__(self, "_bwd_wgrad", _norm(bwd_wgrad))
        if "AUTO" in (self._bwd_dgrad, self._bwd_wgrad):
            raise ValueError(
                "bwd_dgrad/bwd_wgrad must be static formats (AUTO analyzes "
                "*operands*; backward passes inherit a concrete format)")

    def __setattr__(self, name, value):
        raise AttributeError("PrecisionPolicy is immutable")

    # ---- resolution --------------------------------------------------------
    @property
    def rules(self) -> Tuple[Tuple[str, OpRule], ...]:
        return self._rules

    def _rule(self, op_class: str) -> OpRule:
        alias = ATTN_OP_ALIASES.get(op_class)
        if alias is not None:
            rule, key = _best_match_key(self._rules, op_class)
            if key is not None and key[0] == float("inf"):
                return rule  # exact rule for the new class wins outright
            a_rule, a_key = _best_match_key(self._rules, alias)
            # alias wins ties (pre-split policies resolve unchanged); a
            # more-literal glob for the new class wins over it
            if a_rule is not None and (rule is None or a_key >= key):
                rule = a_rule
            if rule is None:
                rule = _best_match(DEFAULT_RULES, alias) \
                    or _best_match(DEFAULT_RULES, op_class)
        else:
            rule = _best_match(self._rules, op_class)
            if rule is None:
                rule = _best_match(DEFAULT_RULES, op_class)
        assert rule is not None  # DEFAULT_RULES ends with "*"
        return rule

    def mode(self, op_class: str) -> ResolvedFormat:
        """The forward format for an op class (AUTO sentinel possible)."""
        return _denorm(self._rule(op_class).fwd)

    def dgrad(self, op_class: str) -> Optional[ResolvedFormat]:
        """Activation-gradient format; None inherits the fwd format."""
        rule = self._rule(op_class)
        return _denorm(rule.dgrad if rule.dgrad is not None
                       else self._bwd_dgrad)

    def wgrad(self, op_class: str) -> Optional[ResolvedFormat]:
        """Weight-gradient format; None inherits the fwd format.

        Fallback chain ends at ``bwd_dgrad``: in v1 the single ``bwd()``
        accessor (= bwd_dgrad) was passed as ``bwd_mode`` and drove BOTH
        backward contractions, so a policy that sets only ``bwd_dgrad`` must
        keep covering wgrad or v1 policies silently lose gradient bits."""
        rule = self._rule(op_class)
        name = rule.wgrad if rule.wgrad is not None else (
            self._bwd_wgrad if self._bwd_wgrad is not None
            else self._bwd_dgrad)
        return _denorm(name)

    # ---- identity ----------------------------------------------------------
    def _key(self):
        return (self._rules, self._bwd_dgrad, self._bwd_wgrad)

    def __eq__(self, other):
        return isinstance(other, PrecisionPolicy) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        rules = {p: dataclasses.asdict(r) for p, r in self._rules}
        return (f"PrecisionPolicy({rules!r}, bwd_dgrad={self._bwd_dgrad!r}, "
                f"bwd_wgrad={self._bwd_wgrad!r})")

    # ---- per-request overlays ---------------------------------------------
    def overlay(self, patch: Union[FormatLike, Mapping[str, object]]
                ) -> "PrecisionPolicy":
        """Derive a policy for one serving request (the paper's mode-select
        bits applied per request instead of per engine).

        ``patch`` is either a single format — the request runs the *whole
        network* at that format — or a rules mapping merged over this
        policy's rules (same-pattern entries replaced, new patterns added;
        resolution precedence is unchanged, so a ``"*"`` patch does NOT
        shadow this policy's more specific rules).

        Backward formats are dropped for the single-format spelling (serving
        never differentiates) and inherited for mapping patches."""
        if isinstance(patch, Mapping):
            merged: Dict[str, object] = {p: r for p, r in self._rules}
            merged.update(dict(patch))
            return PrecisionPolicy(merged, bwd_dgrad=self._bwd_dgrad,
                                   bwd_wgrad=self._bwd_wgrad)
        return PrecisionPolicy({"*": patch})

    # ---- wire format -------------------------------------------------------
    def to_json(self) -> str:
        """Lossless wire form.  Custom formats referenced by any rule are
        embedded so the payload is self-contained — a serving engine can
        apply it in a process that never registered them."""
        referenced = [self._bwd_dgrad, self._bwd_wgrad]
        payload = {"rules": {}, "bwd_dgrad": self._bwd_dgrad,
                   "bwd_wgrad": self._bwd_wgrad}
        for pattern, rule in self._rules:
            payload["rules"][pattern] = {"fwd": rule.fwd, "dgrad": rule.dgrad,
                                         "wgrad": rule.wgrad}
            referenced += [rule.fwd, rule.dgrad, rule.wgrad]
        payload["formats"] = formats_lib.collect_defs(referenced)
        return json.dumps(payload, indent=1)

    @classmethod
    def from_json(cls, payload: Union[str, bytes, Mapping]) -> "PrecisionPolicy":
        """Inverse of ``to_json``.  Embedded custom formats are registered
        first (idempotent; conflicting redefinitions raise)."""
        obj = json.loads(payload) if isinstance(payload, (str, bytes)) \
            else payload
        formats_lib.register_defs(obj.get("formats"))
        # plain dicts, NOT pre-built OpRules: every name in the payload goes
        # through _norm so an unknown format fails here, not at lookup time
        rules = {p: {"fwd": r["fwd"], "dgrad": r.get("dgrad"),
                     "wgrad": r.get("wgrad")}
                 for p, r in (obj.get("rules") or {}).items()}
        return cls(rules, bwd_dgrad=obj.get("bwd_dgrad"),
                   bwd_wgrad=obj.get("bwd_wgrad"))

    # ---- canonical recipes -------------------------------------------------
    @classmethod
    def full_fp32(cls) -> "PrecisionPolicy":
        """Paper mode 4 everywhere — the accuracy baseline."""
        return cls({"*": "M23"})

    @classmethod
    def serve_default(cls) -> "PrecisionPolicy":
        """Decode-optimized: single-pass bf16 with precise logits."""
        return cls({"qkv": "M8", "attn_logits": "M16", "attn_out": "M8",
                    "ffn": "M8", "moe_expert": "M8", "lm_head": "M16"})
