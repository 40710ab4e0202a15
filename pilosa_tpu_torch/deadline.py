"""Request deadlines: one budget, propagated end to end.

Every query/import may carry a deadline — derived from a per-request
``timeout=`` HTTP param, an ``X-Pilosa-Deadline`` header from an
upstream node, or the server's configured default.  The deadline lives
in a ``contextvars.ContextVar`` so it follows the request through the
handler thread AND into the distributed executor's fan-out pool
(``dist._submit`` copies the caller's context), and every remote hop
re-derives its per-hop socket timeout from the remaining budget
(``cluster/client.py``).

Wire format: the header carries the REMAINING budget in seconds at send
time (not an absolute timestamp), so clock skew between nodes never
inflates or deflates a deadline; each hop only loses the network
transit time, which is exactly the cost the budget should pay.

An expired deadline raises :class:`DeadlineExceeded`, mapped to HTTP
504 by ``server/http.py`` — a slow fan-out fails fast instead of
stalling the pool (the reference bounds this with contexts threaded
through executor.go; contextvars is this runtime's equivalent).

Counterpart of ``pilosa_tpu/deadline.py``, the same code.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager

# Header carrying the remaining budget (seconds, decimal) across hops.
HEADER = "X-Pilosa-Deadline"


class DeadlineExceeded(Exception):
    """The request's deadline budget is exhausted (served as HTTP 504).

    Deliberately NOT an ExecuteError/ApiError subclass: those map to
    HTTP 400 and a deadline expiry is not a client mistake.
    """


_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "pilosa_deadline", default=None
)


def start(budget_seconds: float) -> contextvars.Token:
    """Install an absolute monotonic deadline ``budget_seconds`` from now."""
    return _deadline.set(time.monotonic() + float(budget_seconds))


def reset(token: contextvars.Token) -> None:
    _deadline.reset(token)


@contextmanager
def scope(budget_seconds: float | None):
    """``with deadline.scope(1.5): ...`` — no-op when budget is None/<=0."""
    if budget_seconds is None or budget_seconds <= 0:
        yield
        return
    token = start(budget_seconds)
    try:
        yield
    finally:
        reset(token)


def remaining() -> float | None:
    """Seconds left in the active budget; None when no deadline is set.
    May be negative once expired."""
    d = _deadline.get()
    if d is None:
        return None
    return d - time.monotonic()


def expired() -> bool:
    r = remaining()
    return r is not None and r <= 0


def at() -> float | None:
    """Absolute monotonic deadline of the active budget (None when no
    deadline is set).  For handing a budget across threads: the serving
    plane's dispatcher (``server/batcher.py``) runs outside the request
    context, so the submitting thread snapshots this value into the
    queue item and the dispatcher compares it against
    ``time.monotonic()`` directly."""
    return _deadline.get()


def would_expire_within(seconds: float) -> bool:
    """Queue-time admission accounting: True when the active budget
    cannot survive ``seconds`` more of waiting.  The batcher uses this
    to classify a request as too close to its deadline to queue — it
    must dispatch immediately (or 504) rather than wait out a batch
    window it cannot afford.  False when no deadline is set."""
    r = remaining()
    return r is not None and r <= seconds


def check(what: str = "") -> None:
    """Raise :class:`DeadlineExceeded` if the active budget is exhausted."""
    r = remaining()
    if r is not None and r <= 0:
        raise DeadlineExceeded(
            f"deadline exceeded{f' ({what})' if what else ''}"
        )


def header_value() -> str | None:
    """Remaining budget formatted for the wire; None when no deadline."""
    r = remaining()
    if r is None:
        return None
    return format(max(r, 0.0), ".4f")


def from_header(value: str | None) -> float | None:
    """Parse an incoming header into a budget (seconds); None when absent
    or malformed (a garbage header must not 500 the request — the
    request simply runs without a deadline)."""
    if not value:
        return None
    try:
        budget = float(value)
    except ValueError:
        return None
    if budget != budget or budget == float("inf"):  # NaN / inf
        return None
    return max(budget, 0.0)
