"""The two pieces of the QoS plane the direct query path and the HTTP
layer read (counterpart of part of ``pilosa_tpu/server/qos.py``).

The JAX package's ``QosGovernor`` (weighted-fair admission debited by
measured device time, with a deprioritize/degrade/shed ladder) rides the
continuous-batching plane, which the port does not have yet: every query
takes the API's direct path. What stays is the contract the HTTP layer
maps: a shed admission is :class:`ShedError` (429 with Retry-After), and
an answer served from the degraded tier is marked in the envelope
(:func:`note_degraded` / :func:`take_degraded`).
"""

from __future__ import annotations

import contextvars


class ShedError(Exception):
    """Admission refused under stage-3 pressure; HTTP maps this to
    429 + Retry-After (server/http.py), never a silent 504."""

    def __init__(self, tenant: str, retry_after: float):
        super().__init__(
            f"tenant {tenant!r} is being shed under device pressure; "
            f"retry after {retry_after:g}s"
        )
        self.tenant = tenant
        self.retry_after = float(retry_after)


# Request-scoped marker: set when a query was served from the degraded
# tier; API.query() takes it and stamps the response envelope (the
# note/take pattern of obs/slo.py note_class).
_degraded: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "pilosa_qos_degraded", default=False
)


def note_degraded() -> None:
    _degraded.set(True)


def take_degraded() -> bool:
    served = _degraded.get()
    if served:
        _degraded.set(False)
    return served
