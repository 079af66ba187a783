"""Structured serving errors — the load-survival layer's reply contract.

The port's copy of ``dpf_tpu/serving/errors.py``: the same nine codes
and statuses, the same classes.

Under overload or device failure the sidecar must answer with a *defined*
shape, not a stack trace: a machine-readable ``{code, detail}`` JSON body,
an HTTP status a load balancer understands (429 shed, 503 open circuit,
504 missed deadline), and a ``Retry-After`` derived from observed
dispatch latency so well-behaved clients back off by the right amount.

Every class here carries a client-safe ``detail`` string composed from
public metadata only (queue depths, watermarks, lane names).  Raw request
bytes and exception reprs never reach these messages — the secret-hygiene
lint pass treats error-reply calls as taint sinks, and the server maps
*unexpected* exceptions to their type name alone.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# The canonical error-code table: every ``code`` string the sidecar can
# put in a ``{code, detail}`` reply body, with its one HTTP status.
# Handlers, wire2, and the readyz surface all derive the status from
# this table (``_reply_error`` looks it up), so a literal cannot drift
# from its class's canonical code; the Go client's documented code set
# (bridge/go/dpftpu/client.go, APIError) is pinned against this table
# by the ``surface-contract`` analysis pass and docs/CONTRACT.json.
# ---------------------------------------------------------------------------
CODES: dict[str, int] = {
    # Class-carried codes (the ServingError hierarchy below).
    "shed": 429,          # admission control refused (ShedError)
    "unavailable": 503,   # circuit open / transient device failure
    "deadline": 504,      # request deadline expired (DeadlineError)
    "internal": 500,      # unexpected failure, type name only
    # Literal-only codes (no exception class: replied in-line).
    "bad_request": 400,   # parameter/shape validation failure
    "cold": 503,          # /readyz before the first POST /v1/warmup
    "breaker_open": 503,  # /readyz while the circuit is not closed
    "profile_forbidden": 403,  # /v1/profile without DPF_CUDA_PROFILE_ALLOW
    "profile_active": 409,     # /v1/profile start while a capture runs
}


class ServingError(RuntimeError):
    """Base for errors with a defined HTTP mapping.

    Subclasses declare only ``code``; ``http_status`` is derived from
    the canonical :data:`CODES` table (one source of truth — a subclass
    cannot carry a status its code does not mean).  ``retry_after_s``
    (when set) becomes the reply's ``Retry-After`` header, rounded up
    to whole seconds.
    """

    code = "internal"
    http_status = CODES["internal"]

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.http_status = CODES[cls.code]

    def __init__(self, detail: str, retry_after_s: float | None = None):
        super().__init__(detail)
        self.detail = detail
        self.retry_after_s = retry_after_s


class ShedError(ServingError):
    """Admission control refused the request: the lane's queue is past a
    depth or age watermark.  Shedding at the door keeps accepted-request
    latency bounded instead of letting p99 collapse into timeouts."""

    code = "shed"


class OverloadedError(ServingError):
    """The device circuit breaker is open (or a dispatch failed with a
    transient device signature after retries): fail fast instead of
    burning a queue slot on work that cannot complete."""

    code = "unavailable"


class DeadlineError(ServingError):
    """The request's deadline expired.  ``where`` distinguishes work that
    was cancelled before burning a device slot ("queue") from work whose
    deadline passed while its dispatch ran ("flight") — counted
    separately in /v1/stats."""

    code = "deadline"

    def __init__(self, detail: str, where: str = "queue"):
        super().__init__(detail)
        self.where = where
