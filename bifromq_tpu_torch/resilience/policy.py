"""Per-call deadline budgets (copy of the deadline half of
``bifromq_tpu/resilience/policy.py``; ``RetryPolicy`` and the idempotency
whitelist belong to the RPC fabric, ROADMAP A.5b).

The reference leans on gRPC's deadline propagation (base-rpc, SURVEY.md
§2.4). Here a caller opens ``deadline_scope(budget_s)``; everything
issued inside the scope sees the remaining budget through
``current_deadline`` / ``remaining_budget`` — the dist worker checks it
at each range's dispatch boundary and degrades an exhausted budget to
the host oracle.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

# absolute time.monotonic() deadline for the current logical call tree
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "rpc_deadline", default=None)


def current_deadline() -> Optional[float]:
    """Absolute ``time.monotonic()`` deadline of the active scope (None =
    unbounded)."""
    return _DEADLINE.get()


def remaining_budget() -> Optional[float]:
    """Seconds left in the active deadline scope; None = unbounded.
    Clamped at 0.0 — an exhausted budget never goes negative."""
    d = _DEADLINE.get()
    if d is None:
        return None
    return max(0.0, d - time.monotonic())


@contextlib.contextmanager
def deadline_scope(budget_s: Optional[float]) -> Iterator[Optional[float]]:
    """Bound everything inside to ``budget_s`` seconds from now. Nested
    scopes only ever SHRINK the deadline (a callee cannot outlive its
    caller's budget). ``None`` is a no-op passthrough."""
    if budget_s is None:
        yield _DEADLINE.get()
        return
    new = time.monotonic() + budget_s
    cur = _DEADLINE.get()
    if cur is not None:
        new = min(new, cur)
    token = _DEADLINE.set(new)
    try:
        yield new
    finally:
        _DEADLINE.reset(token)


@contextlib.contextmanager
def absolute_deadline(deadline: Optional[float]) -> Iterator[None]:
    """Install an ABSOLUTE monotonic deadline (server side: re-arm the
    scope from a decoded wire header). Shrink-only, like deadline_scope."""
    if deadline is None:
        yield
        return
    cur = _DEADLINE.get()
    if cur is not None:
        deadline = min(deadline, cur)
    token = _DEADLINE.set(deadline)
    try:
        yield
    finally:
        _DEADLINE.reset(token)
