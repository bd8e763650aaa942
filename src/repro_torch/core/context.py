"""Explicit precision context (PyTorch port of ``repro.core.context``).

Carries the dispatch ``backend`` (``"cuda"``, the hand-written kernels, by
default; ``"ref"``, the oracle, only when a caller asks for it;
``"sharded"``, the K-sharded multi-rank path), the active ``policy``, the
AUTO controller's candidate formats and analysis tolerance
(``auto_candidates``, ``auto_tol``), and the sharded backend's default
``mesh`` (a ``torch.distributed`` DeviceMesh; process-local, so it is left
out of the JSON, as in the JAX package).
``configure(...)`` replaces the process default; ``with context(...)``
pushes a scoped override on a ``contextvars`` ContextVar, so concurrent
threads may run under different settings.  ``to_json`` / ``from_json``
round-trip a context in the JAX package's wire form, the ``autotune``
switch included (``true``, ``false`` or ``null``: not configured, so
:func:`autotune_enabled` reads ``REPRO_MP_AUTOTUNE`` live).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
from typing import Any, Optional, Tuple, Union

from repro_torch.core import formats
from repro_torch.core.formats import FormatLike, PrecisionMode, resolve
from repro_torch.core.policy import PrecisionPolicy

# default AUTO candidate set: the fp32-representable built-in modes
DEFAULT_AUTO_CANDIDATES: Tuple[PrecisionMode, ...] = (
    PrecisionMode.M8,
    PrecisionMode.M16,
    PrecisionMode.M23,
)

_UNSET = object()
# backends of the JAX package that the port does not have
JAX_ONLY_BACKENDS = ("pallas", "pallas_interpret")


@dataclasses.dataclass(frozen=True)
class PrecisionContext:
    """One snapshot of the runtime precision configuration."""

    backend: str = "cuda"
    policy: Optional[PrecisionPolicy] = None
    auto_candidates: Tuple[FormatLike, ...] = DEFAULT_AUTO_CANDIDATES
    auto_tol: float = 2.0**-13
    mesh: Any = None  # default mesh for the sharded backend (process-local)
    # sweep launch parameters on a table miss (kernels/autotune.py); None:
    # not configured, the REPRO_MP_AUTOTUNE env var decides per call
    autotune: Optional[bool] = None

    def replace(self, **kw) -> "PrecisionContext":
        return dataclasses.replace(self, **kw)

    # ---- wire format (the JAX package's fields; no mesh) -------------------
    def to_json(self) -> str:
        # custom formats among the AUTO candidates ship their definitions,
        # so the payload hydrates in a process that never registered them
        names = [resolve(c).name for c in self.auto_candidates]
        return json.dumps({
            "backend": self.backend,
            "policy": None if self.policy is None
            else json.loads(self.policy.to_json()),
            "auto_candidates": names,
            "formats": formats.collect_defs(names),
            "auto_tol": self.auto_tol,
            "autotune": self.autotune,
        }, indent=1)

    @classmethod
    def from_json(cls, payload: Union[str, bytes, dict]
                  ) -> "PrecisionContext":
        """Hydrate a payload (validated as ``configure`` validates), from
        either package; the backend must be one of the port's."""
        obj = json.loads(payload) if isinstance(payload, (str, bytes)) \
            else payload
        formats.register_defs(obj.get("formats"))
        policy = obj.get("policy")
        backend = obj.get("backend", cls.backend)
        candidates = tuple(obj.get("auto_candidates")
                           or DEFAULT_AUTO_CANDIDATES)
        _validate({"backend": backend, "auto_candidates": candidates})
        return cls(
            backend=backend,
            policy=None if policy is None
            else PrecisionPolicy.from_json(policy),
            auto_candidates=candidates,
            auto_tol=float(obj.get("auto_tol", 2.0**-13)),
            autotune=None if obj.get("autotune") is None
            else bool(obj["autotune"]))


_process_default: Optional[PrecisionContext] = None
_scoped: contextvars.ContextVar[Optional[PrecisionContext]] = \
    contextvars.ContextVar("repro_torch_mp_context", default=None)


def default_context() -> PrecisionContext:
    global _process_default
    if _process_default is None:
        _process_default = PrecisionContext()
    return _process_default


def current_context() -> PrecisionContext:
    """The innermost ``with context(...)`` scope, else the process
    default."""
    scoped = _scoped.get()
    return scoped if scoped is not None else default_context()


def _validate(kw) -> None:
    unknown = set(kw) - {"backend", "policy", "auto_candidates", "auto_tol",
                         "mesh", "autotune"}
    if unknown:
        raise TypeError(f"unknown context fields {sorted(unknown)}")
    backend = kw.get("backend", _UNSET)
    if backend is not _UNSET:
        from repro_torch.core import dispatch  # lazy: dispatch imports us

        if backend in JAX_ONLY_BACKENDS:
            raise ValueError(
                f"backend {backend!r} is the JAX package's; the port has "
                f"{dispatch.available_backends()}")
        if backend not in dispatch.available_backends():
            raise ValueError(f"unknown backend {backend!r}; have "
                             f"{dispatch.available_backends()}")
    cands = kw.get("auto_candidates", _UNSET)
    if cands is not _UNSET:
        if not cands:
            raise ValueError("auto_candidates must name at least one format")
        for cand in cands:
            # AUTO cannot be its own candidate: select_mode_index ranks
            # static formats by limb count; resolve() raises on AUTO and on
            # unknown names, here rather than at the first AUTO call
            resolve(cand)


def configure(**kw) -> PrecisionContext:
    """Replace fields of the process-default context.  Returns it."""
    global _process_default
    _validate(kw)
    _process_default = default_context().replace(**kw)
    return _process_default


@contextlib.contextmanager
def context(**kw):
    """Scoped override of the current context (thread-/async-safe)."""
    _validate(kw)
    token = _scoped.set(current_context().replace(**kw))
    try:
        yield _scoped.get()
    finally:
        _scoped.reset(token)


@contextlib.contextmanager
def scoped(ctx: PrecisionContext):
    """Make the snapshot ``ctx`` the current context for a scope.  Work run
    later on another thread (the autograd engine's, which runs a CUDA
    backward and sees none of the caller's scopes) takes the caller's
    settings this way: the training ops capture ``current_context()`` when
    their forward runs."""
    token = _scoped.set(ctx)
    try:
        yield ctx
    finally:
        _scoped.reset(token)


def resolve_request_policy(mode=None, policy=None,
                           base: Optional[PrecisionPolicy] = None
                           ) -> PrecisionPolicy:
    """Per-request precision resolution (the serving QoS overlay).

    A request may carry a full ``policy`` (object or JSON wire form; wins
    outright) or a single ``mode`` (any ``formats.resolve`` spelling;
    applied as a whole-network overlay on ``base`` via
    :meth:`PrecisionPolicy.overlay`).  ``base`` defaults to the active
    context's policy, else the serving recipe default."""
    if policy is not None:
        if not isinstance(policy, PrecisionPolicy):
            policy = PrecisionPolicy.from_json(policy)
        return policy
    if base is None:
        base = current_context().policy or PrecisionPolicy.serve_default()
    if mode is None:
        return base
    return base.overlay(mode)


def autotune_enabled() -> bool:
    """The effective autotune switch for dispatch: an explicitly configured
    context flag wins; otherwise the ``REPRO_MP_AUTOTUNE`` env var is read
    live, on every call (``"1"`` turns sweeps on)."""
    flag = current_context().autotune
    if flag is not None:
        return bool(flag)
    return os.environ.get("REPRO_MP_AUTOTUNE", "") == "1"


def reset_context() -> None:
    """Drop the process default (tests)."""
    global _process_default
    _process_default = None
