"""Per-request tracing: span recorder + bounded flight recorder.

The port's copy of ``dpf_tpu/obs/trace.py`` (framework-free; the same
spans, outcomes and ring, read through the ``DPF_CUDA_*`` knobs).

Aggregate counters (/v1/stats) answer "how much"; when p99 degrades or
the breaker trips on hardware they cannot answer "which request waited
WHERE".  This module records one span tree per sidecar request —

    ingress -> admission -> queue_wait -> coalesce -> dispatch
            -> plan_lookup -> compute -> d2h -> reply

— and keeps the finished trees in a bounded ring buffer (the "flight
recorder", ``DPF_CUDA_TRACE_RING`` entries) queryable at ``GET
/v1/trace``.  Shed, expired, and breaker-rejected requests are recorded
too, with their outcome, so an overload incident is reconstructable
after the fact from the sidecar alone.

Identity: the trace id arrives in the ``X-DPF-Trace`` request header
(the Go client stamps one per request) or is generated at ingress.  A
coalesced batch's requests each keep their own trace, but the device
dispatch is ONE shared ``Span`` object attached to every batch-mate's
tree — the span_id equality is how a cross-request incident ("these 14
requests all rode the slow dispatch") is established, and the
``coalesce`` span carries the batch-mates' trace ids.

Attribute discipline: span attributes and trace payloads leave the
process via ``/v1/trace``, so they are taint SINKS for the
secret-hygiene lint pass — only public metadata (ids, shapes, buckets,
counts, durations) may flow into ``set_attrs``/``add_span``/
``add_event``/``child_span``.  Key material never.

Overhead: with ``DPF_CUDA_TRACE=off`` the tracer hands out ``None`` and
every instrumentation point is a single ``is None`` check; with tracing
on, a span is one small object append (no locks on the request path —
the only lock is the ring buffer's, taken once per request at finish).
The instrumentation's cost on the card is not measured yet.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import uuid
from collections import deque

from ..core import knobs

# The outcome vocabulary /v1/trace filters on.  "shed" (429 admission),
# "expired" (504 deadline), "breaker_rejected" (503 open circuit),
# "bad_request" (400), "error" (500), "ok".
OUTCOMES = (
    "ok", "shed", "expired", "breaker_rejected", "bad_request", "error",
)

_SPAN_IDS = itertools.count(1)

# Ordered span names of a full fast-path request — tests assert
# completeness against this list, keep it in sync with the docstring.
SPAN_NAMES = (
    "ingress", "admission", "queue_wait", "coalesce", "dispatch",
    "plan_lookup", "compute", "d2h", "reply",
)


class Span:
    """One named, timed tree node.  ``span_id`` is process-unique so a
    span SHARED between traces (the coalesced dispatch) is recognizably
    the same event in every tree it appears in."""

    __slots__ = ("span_id", "name", "t0", "dur_s", "attrs", "children")

    def __init__(self, name: str, t0: float | None = None):
        self.span_id = next(_SPAN_IDS)
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.dur_s = 0.0
        self.attrs: dict = {}
        self.children: list[Span] = []

    def end(self) -> "Span":
        self.dur_s = time.perf_counter() - self.t0
        return self

    def set_attrs(self, **attrs) -> None:
        """Attach public metadata (secret-hygiene sink: attributes are
        exported verbatim by /v1/trace)."""
        self.attrs.update(attrs)

    def child(self, name: str, t0: float | None = None) -> "Span":
        sp = Span(name, t0)
        self.children.append(sp)
        return sp

    def as_dict(self, base_t0: float) -> dict:
        """JSON form, with times relative to the OWNING trace's ingress
        (a shared span renders a different start_ms in each tree)."""
        return {
            "span_id": self.span_id,
            "name": self.name,
            "start_ms": round((self.t0 - base_t0) * 1e3, 3),
            "duration_ms": round(self.dur_s * 1e3, 3),
            "attrs": dict(self.attrs),
            "children": [c.as_dict(base_t0) for c in self.children],
        }


class RequestTrace:
    """One request's span tree, rooted at ``ingress``."""

    __slots__ = ("trace_id", "route", "t0", "t0_unix", "outcome", "root")

    def __init__(self, trace_id: str, route: str):
        self.trace_id = trace_id
        self.route = route
        self.t0 = time.perf_counter()
        self.t0_unix = time.time()
        self.outcome = "ok"
        self.root = Span("ingress", t0=self.t0)

    @contextlib.contextmanager
    def span(self, name: str):
        """Timed child span of the root: ``with trace.span("reply"):``."""
        sp = self.root.child(name)
        try:
            yield sp
        finally:
            sp.end()

    def add_span(self, name: str, t0: float, dur_s: float, **attrs) -> Span:
        """Record a span measured elsewhere (the batcher's queue_wait is
        timed by the lane leader, not this thread)."""
        sp = Span(name, t0=t0)
        sp.dur_s = dur_s
        sp.attrs.update(attrs)
        self.root.children.append(sp)
        return sp

    def attach(self, span: Span) -> None:
        """Adopt an already-built span — THE shared-dispatch mechanism:
        every coalesced batch-mate attaches the same object."""
        self.root.children.append(span)

    def set_attrs(self, **attrs) -> None:
        self.root.attrs.update(attrs)

    def span_names(self) -> set[str]:
        out = set()
        stack = [self.root]
        while stack:
            sp = stack.pop()
            out.add(sp.name)
            stack.extend(sp.children)
        return out

    def duration_ms(self) -> float:
        return self.root.dur_s * 1e3

    def as_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "route": self.route,
            "outcome": self.outcome,
            "start_unix": round(self.t0_unix, 6),
            "duration_ms": round(self.duration_ms(), 3),
            "spans": [self.root.as_dict(self.t0)],
        }


class FlightRecorder:
    """Bounded ring of finished traces (newest last).  Eviction is the
    deque's: the ring NEVER grows past capacity, old incidents age out."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._ring: deque[RequestTrace] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.recorded = 0
        self.evicted = 0

    def record(self, trace: RequestTrace) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.evicted += 1
            self._ring.append(trace)
            self.recorded += 1

    def query(
        self,
        n: int = 32,
        slowest: bool = False,
        trace_id: str | None = None,
        outcome: str | None = None,
    ) -> list[RequestTrace]:
        """Recent-N (default), slowest-N, by trace id, or by outcome —
        newest/slowest first."""
        with self._lock:
            traces = list(self._ring)
        if trace_id is not None:
            traces = [t for t in traces if t.trace_id == trace_id]
        if outcome is not None:
            traces = [t for t in traces if t.outcome == outcome]
        if slowest:
            traces.sort(key=lambda t: t.root.dur_s, reverse=True)
        else:
            traces.reverse()  # newest first
        return traces[: max(int(n), 0)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "size": len(self._ring),
                "recorded": self.recorded,
                "evicted": self.evicted,
            }


def _clean_id(raw: str | None) -> str | None:
    """Sanitize a client-supplied trace id: bounded length, URL/JSON-safe
    charset — anything else is replaced by a generated id (a hostile
    header must not inject junk into /v1/trace payloads)."""
    if not raw:
        return None
    raw = raw.strip()
    if 0 < len(raw) <= 64 and all(
        c.isalnum() or c in "-_.:" for c in raw
    ):
        return raw
    return None


class Tracer:
    """Per-serving-state trace factory + its flight recorder.  When
    disabled (``DPF_CUDA_TRACE=off``), ``begin`` returns None and every
    downstream instrumentation point no-ops on the None check."""

    def __init__(self, enabled: bool | None = None,
                 ring: int | None = None):
        if enabled is None:
            enabled = knobs.get_bool("DPF_CUDA_TRACE")
        if ring is None:
            ring = knobs.get_int("DPF_CUDA_TRACE_RING")
        self.enabled = bool(enabled)
        self.recorder = FlightRecorder(ring)

    def begin(self, header_id: str | None, route: str) -> RequestTrace | None:
        if not self.enabled:
            return None
        tid = _clean_id(header_id) or uuid.uuid4().hex[:16]
        return RequestTrace(tid, route)

    def finish(self, trace: RequestTrace | None, outcome: str = "ok") -> None:
        if trace is None:
            return
        trace.root.end()
        trace.outcome = outcome
        self.recorder.record(trace)

    def stats(self) -> dict:
        out = self.recorder.stats()
        out["enabled"] = self.enabled
        return out


# ---------------------------------------------------------------------------
# Dispatch scope: how layers BELOW the batcher annotate the in-flight
# dispatch span without threading a trace handle through every call.
# The lane leader (or the passthrough path) sets the active span for the
# duration of the device dispatch; core/plans and the breaker then hang
# plan_lookup/compute/d2h/retry children on it.  Thread-local, so
# concurrent lanes never cross-contaminate.
# ---------------------------------------------------------------------------

_TLS = threading.local()


def maybe_span(trace: RequestTrace | None, name: str):
    """``trace.span(name)`` when tracing, a no-op context when the
    request is untraced — the one spelling of the conditional-span
    idiom every instrumentation site uses."""
    if trace is None:
        return contextlib.nullcontext()
    return trace.span(name)


@contextlib.contextmanager
def traced_dispatch(trace: RequestTrace | None):
    """The non-batched dispatch-span idiom: a ``dispatch`` span active
    for the body's duration (plans/breaker children land on it via the
    dispatch scope), ended and attached to ``trace`` even when the
    dispatch raises.  Yields the span (None when untraced) so callers
    can set attrs."""
    if trace is None:
        with dispatch_scope(None):
            yield None
        return
    sp = Span("dispatch")
    try:
        with dispatch_scope(sp):
            yield sp
    finally:
        sp.end()
        trace.attach(sp)


@contextlib.contextmanager
def dispatch_scope(span: Span | None):
    prev = getattr(_TLS, "span", None)
    _TLS.span = span
    try:
        yield span
    finally:
        _TLS.span = prev


def add_event(name: str, **attrs) -> None:
    """Zero-duration child of the active dispatch span (plan-cache
    lookups, breaker retries).  No-op outside a dispatch scope.
    Secret-hygiene sink: attrs are exported by /v1/trace."""
    sp = getattr(_TLS, "span", None)
    if sp is not None:
        ev = sp.child(name)
        if attrs:
            ev.attrs.update(attrs)


@contextlib.contextmanager
def child_span(name: str):
    """Timed child of the active dispatch span; yields None (and times
    nothing) outside a dispatch scope."""
    sp = getattr(_TLS, "span", None)
    if sp is None:
        yield None
        return
    c = sp.child(name)
    try:
        yield c
    finally:
        c.end()
