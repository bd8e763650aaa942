"""Explicit precision context (PyTorch port of ``repro.core.context``).

Carries the two fields the serving slice reads: the dispatch ``backend``
(``"cuda"``, the hand-written kernels, by default; ``"ref"``, the oracle,
only when a caller asks for it) and the active ``policy``.
``configure(...)`` replaces the process default; ``with context(...)``
pushes a scoped override on a ``contextvars`` ContextVar, so concurrent
threads may run under different settings.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

from repro_torch.core.policy import PrecisionPolicy

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class PrecisionContext:
    """One snapshot of the runtime precision configuration."""

    backend: str = "cuda"
    policy: Optional[PrecisionPolicy] = None

    def replace(self, **kw) -> "PrecisionContext":
        return dataclasses.replace(self, **kw)


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
    unknown = set(kw) - {"backend", "policy"}
    if unknown:
        raise TypeError(f"unknown context fields {sorted(unknown)}")
    backend = kw.get("backend", _UNSET)
    if backend is not _UNSET:
        from repro_torch.core import dispatch  # lazy: dispatch imports us

        if backend not in dispatch.available_backends():
            raise ValueError(f"unknown backend {backend!r}; have "
                             f"{dispatch.available_backends()}")


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


def reset_context() -> None:
    """Drop the process default (tests)."""
    global _process_default
    _process_default = None
