"""Deterministic fault injection for the serving stack.

The port's copy of ``dpf_tpu/serving/faults.py``: the same sites, kinds
and grammar, read from ``DPF_CUDA_FAULTS`` / ``DPF_CUDA_FAULTS_ALLOW``.

The load-survival machinery (admission control, deadlines, the circuit
breaker, degraded modes) only matters under conditions a healthy CPU test
run never produces: a wedged device, a dispatch that hangs, a client that
stalls mid-stream.  Real devices produce them (a wedged card, a
failing copy) routinely, but not on demand.  This module
makes every such condition a deterministic, named event so the behaviors
above are testable on CPU in milliseconds.

Sites (instrumented with ``faults.fire(site)`` at the named seams; a call
with no active plan is one ``is None`` check):

  dispatch.points    lane dispatcher for pointwise/DCF routes
                     (serving/batcher.dispatch_points), before the plan
                     cache runs
  dispatch.interval  the DCF interval lane dispatcher
  dispatch.evalfull  the blocking /v1/evalfull[_batch] dispatch
  dispatch.hh        the heavy-hitters round lane dispatcher
  dispatch.agg       each streamed /v1/agg/submit fold-chunk dispatch
  dispatch.pir       the PIR query lane dispatcher (serving/batcher.
                     dispatch_pir), before the plan-cached scan
  pir.db_load        once per socket-read chunk of a /v1/pir/db upload,
                     before the chunk lands in the packed host buffer
  stream.chunk       once per chunk of a streamed /v1/evalfull, before
                     the chunk's bytes go onto the socket
  reply.write        the points reply marshalling (slow-client stand-in)

Kinds:

  unavailable   raise an exception whose text carries the transient
                ``UNAVAILABLE`` signature the circuit breaker (and
                classifies as transient (core/transients.py)
  error         raise ``ValueError`` — a non-transient (poisoned-request
                shaped) dispatch failure
  latency       ``time.sleep`` for ``ms`` milliseconds, then proceed
  abort         raise ``ConnectionAbortedError`` — mid-stream/socket
                failure shape

Spec grammar (the ``DPF_CUDA_FAULTS`` knob, or ``install()``/``injected()``
from tests): semicolon-separated clauses

    site:kind[:ms=V][:times=N][:after=N]

``after=N`` skips the first N fires at the site; ``times=N`` fires N
times then goes inert (default: forever).  Example — fail the first
three pointwise dispatches with a transient signature, then slow every
later one by 20 ms::

    dispatch.points:unavailable:times=3;dispatch.points:latency:ms=20:after=3

Safety: activation REFUSES outside a pytest process unless the operator
sets ``DPF_CUDA_FAULTS_ALLOW`` — a fault spec leaking into a production
environment must be a boot-time error, not a mystery outage.  Active
fault state is visible in ``/v1/stats`` so an injected run can never be
mistaken for a healthy one.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass

from ..core import knobs

SITES = (
    "dispatch.points",
    "dispatch.interval",
    "dispatch.evalfull",
    "dispatch.hh",
    "dispatch.hh_extend",
    "dispatch.agg",
    "dispatch.pir",
    "pir.db_load",
    "stream.chunk",
    "reply.write",
)
KINDS = ("unavailable", "error", "latency", "abort")


class InjectedUnavailable(RuntimeError):
    """Injected transient device failure.  The message carries the
    ``UNAVAILABLE`` signature, which the breaker's classifier
    (core/transients.py) treats as transient."""


@dataclass
class FaultClause:
    """One parsed spec clause."""

    site: str
    kind: str
    ms: float = 0.0  # latency kinds: sleep this long
    times: int | None = None  # fire budget (None = forever)
    after: int = 0  # skip the first N fires at this site
    seen: int = 0  # fires observed (incl. skipped)
    fired: int = 0  # faults actually delivered

    def as_dict(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind,
            "ms": self.ms,
            "times": self.times,
            "after": self.after,
            "seen": self.seen,
            "fired": self.fired,
        }


def parse_spec(spec: str) -> list[FaultClause]:
    """Parse the clause grammar; raises ``ValueError`` on unknown sites,
    kinds, or options (a typo'd fault spec must fail loudly at activation,
    like a typo'd knob)."""
    clauses = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"fault clause {part!r}: need site:kind")
        site, kind = fields[0], fields[1]
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (one of {', '.join(SITES)})"
            )
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (one of {', '.join(KINDS)})"
            )
        cl = FaultClause(site, kind)
        for opt in fields[2:]:
            if "=" not in opt:
                raise ValueError(
                    f"fault option {opt!r} in {part!r}: need key=value"
                )
            key, val = opt.split("=", 1)
            if key == "ms":
                cl.ms = float(val)
            elif key == "times":
                cl.times = int(val)
            elif key == "after":
                cl.after = int(val)
            else:
                raise ValueError(
                    f"unknown fault option {key!r} (ms|times|after)"
                )
        clauses.append(cl)
    return clauses


class FaultPlan:
    """Thread-safe active fault set; ``fire(site)`` delivers whatever the
    matching clauses currently owe."""

    def __init__(self, clauses: list[FaultClause]):
        self._clauses = clauses
        self._lock = threading.Lock()

    def fire(self, site: str) -> None:
        sleep_ms = 0.0
        raise_kind = None
        with self._lock:
            for cl in self._clauses:
                if cl.site != site:
                    continue
                cl.seen += 1
                if cl.seen <= cl.after:
                    continue
                if cl.times is not None and cl.fired >= cl.times:
                    continue
                cl.fired += 1
                if cl.kind == "latency":
                    sleep_ms += cl.ms
                elif raise_kind is None:
                    raise_kind = cl.kind
        if sleep_ms > 0:
            time.sleep(sleep_ms / 1e3)
        if raise_kind == "unavailable":
            raise InjectedUnavailable(
                f"UNAVAILABLE: injected fault at {site}"
            )
        if raise_kind == "error":
            raise ValueError(f"injected fault at {site}")
        if raise_kind == "abort":
            raise ConnectionAbortedError(f"injected abort at {site}")

    def stats(self) -> dict:
        with self._lock:
            return {"clauses": [cl.as_dict() for cl in self._clauses]}


_PLAN: FaultPlan | None = None
_PLAN_LOCK = threading.Lock()


def _refusal(modules=None, allow: bool | None = None) -> str | None:
    """Why activation is refused (None = allowed).  Parameterized so the
    guard itself is testable from inside pytest."""
    modules = sys.modules if modules is None else modules
    if allow is None:
        allow = knobs.is_set("DPF_CUDA_FAULTS_ALLOW")
    if "pytest" in modules or allow:
        return None
    return (
        "fault injection refused: not a pytest process and "
        "DPF_CUDA_FAULTS_ALLOW is not set (a fault spec must never "
        "activate silently in production)"
    )


def install(spec: str) -> FaultPlan:
    """Parse + activate ``spec`` process-wide.  Raises ``RuntimeError``
    outside tests (see ``_refusal``), ``ValueError`` on a bad spec."""
    reason = _refusal()
    if reason is not None:
        raise RuntimeError(reason)
    plan = FaultPlan(parse_spec(spec))
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan
    return plan


def install_from_env() -> FaultPlan | None:
    """Activate the ``DPF_CUDA_FAULTS`` knob's spec if non-empty (called
    when the serving state is built); None when no spec is set."""
    spec = knobs.get_str("DPF_CUDA_FAULTS")
    if not spec:
        return None
    return install(spec)


def clear() -> None:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = None


def active() -> FaultPlan | None:
    # install/clear swap the whole plan object under _PLAN_LOCK.
    # lock-free-ok: atomic reference read
    return _PLAN


def fire(site: str) -> None:
    """The instrumented seams call this; a no-op (one attribute read)
    when no plan is installed."""
    # The instrumented seams are hot paths: one atomic reference read,
    # then work against the captured plan object.
    # lock-free-ok: atomic reference read on the request path
    plan = _PLAN
    if plan is not None:
        plan.fire(site)


class injected:
    """Context manager for tests: ``with faults.injected("site:kind"):``
    installs the spec and restores the previous plan on exit."""

    def __init__(self, spec: str):
        self.spec = spec
        self._prev: FaultPlan | None = None
        self.plan: FaultPlan | None = None

    def __enter__(self) -> FaultPlan:
        # lock-free-ok: test-only save/restore; atomic reference read
        self._prev = _PLAN
        self.plan = install(self.spec)
        return self.plan

    def __exit__(self, *exc) -> None:
        global _PLAN
        with _PLAN_LOCK:
            _PLAN = self._prev
