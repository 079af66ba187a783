"""Device-failure circuit breaker for the serving fast path.

The port's counterpart of ``dpf_tpu/serving/breaker.py``: the same state
machine, counters and knobs (``DPF_CUDA_*``).  Two things differ on the
card.  What counts as transient is the port's own list
(``core/transients.py``): a sticky CUDA error (illegal address, launch
failure, device-side assert) is never retried in place, since the context
it leaves cannot run anything again.  And the probe the serving state
wires in is ``core/plans.rewarm_recent``, which re-drives the recently
used plans: on the card, replays of their captured graphs.

A failing device fails every dispatch, and without a breaker every queued
request rides into the same wall one at a time.  The breaker converts it
into bounded, observable behavior:

  closed      healthy.  Dispatch failures with a transient signature are
              retried in place with capped exponential backoff
              (``DPF_CUDA_DISPATCH_RETRIES`` x ``DPF_CUDA_RETRY_BACKOFF_MS``);
              non-transient failures (a poisoned request's ValueError)
              pass through untouched and never count toward tripping.
  open        ``DPF_CUDA_BREAKER_THRESHOLD`` consecutive transient
              failures trip the circuit: requests fail fast with 503 +
              Retry-After (the remaining cooldown) instead of queuing
              behind a dead device.  A background probe thread
              (``DPF_CUDA_BREAKER_PROBE``) re-warms the plan cache each
              cooldown period (``plans.rewarm_recent`` — so recovery
              does not land a capture on the first real request) and
              moves the breaker to half-open when the re-warm succeeds.
  half_open   one real dispatch is the trial: success closes the
              circuit, a transient failure re-opens it.  With the probe
              disabled, cooldown expiry alone moves open -> half_open.

While the breaker is not closed the serving layer also degrades: the
micro-batcher is bypassed (passthrough — a failing dispatch fans to one
request, not a coalesced batch) and streamed EvalFull falls back to
buffered replies (a dispatch error surfaces as a clean status line, not
a truncated body).  Both degraded modes give the same bytes as the fast
path.
"""

from __future__ import annotations

import threading
import time

from ..core import knobs
from ..core.transients import (  # noqa: F401 — re-exported for the handlers
    TRANSIENT_SIGNATURES,
    is_sticky,
    is_transient,
)
from ..obs import trace as obs_trace
from .errors import OverloadedError

_RETRY_BACKOFF_CAP_S = 1.0

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """closed -> open -> half_open -> closed state machine guarding the
    device dispatch path.  Thread-safe; one instance per serving state.

    ``probe`` is a zero-arg callable run by the background probe thread
    while open (the serving state wires it to a plan-cache re-warm); its
    success moves the breaker to half-open, its failure restarts the
    cooldown clock.
    """

    def __init__(
        self,
        threshold: int | None = None,
        cooldown_ms: float | None = None,
        retries: int | None = None,
        backoff_ms: float | None = None,
        probe=None,
        probe_enabled: bool | None = None,
        lock=None,
    ):
        if threshold is None:
            threshold = knobs.get_int("DPF_CUDA_BREAKER_THRESHOLD")
        if cooldown_ms is None:
            cooldown_ms = knobs.get_float("DPF_CUDA_BREAKER_COOLDOWN_MS")
        if retries is None:
            retries = knobs.get_int("DPF_CUDA_DISPATCH_RETRIES")
        if backoff_ms is None:
            backoff_ms = knobs.get_float("DPF_CUDA_RETRY_BACKOFF_MS")
        if probe_enabled is None:
            probe_enabled = knobs.get_bool("DPF_CUDA_BREAKER_PROBE")
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = max(float(cooldown_ms), 1.0) / 1e3
        self.retries = max(int(retries), 0)
        self.backoff_s = max(float(backoff_ms), 0.0) / 1e3
        self._probe = probe
        self._probe_enabled = probe_enabled and probe is not None
        # ``lock`` lets the serving state share its single stats RLock so
        # breaker counters land in the same consistent /v1/stats snapshot
        # as the batcher's; standalone breakers keep their own.
        self._lock = lock if lock is not None else threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._half_open_busy = False  # exactly one trial dispatch at a time
        # Counters (public via stats()).
        self._trips = 0
        self._fast_fails = 0
        self._retries_done = 0
        self._transient_failures = 0
        self._recoveries = 0
        self._probe_runs = 0
        self._probe_thread: threading.Thread | None = None

    # -- state inspection ---------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        """Current state, applying the time-based open -> half_open
        transition (so cooldown expiry needs no probe thread)."""
        if self._state == OPEN and (
            time.perf_counter() - self._opened_at >= self.cooldown_s
        ):
            self._state = HALF_OPEN
        return self._state

    def degraded(self) -> bool:
        """True while not closed — the serving layer's signal to bypass
        the batcher and buffer streamed replies."""
        return self.state != CLOSED

    # -- request path -------------------------------------------------------

    def admit(self) -> None:
        """Fail-fast gate, called at request admission BEFORE any queue
        slot is taken.  Raises ``OverloadedError`` (503) while open."""
        with self._lock:
            if self._state_locked() == OPEN:
                self._fast_fails += 1
                remaining = self.cooldown_s - (
                    time.perf_counter() - self._opened_at
                )
                raise OverloadedError(
                    "circuit open: device dispatch is failing; "
                    "retry after cooldown",
                    retry_after_s=max(remaining, 0.05),
                )

    def call(self, fn):
        """Run ``fn`` under the breaker: transparent capped-backoff
        retries for transient failures, then breaker accounting.  The
        caller may also ``admit()`` earlier, at request admission (the
        batcher admits on the request thread but dispatches on the lane
        leader's); ``call`` re-checks so work already queued when the
        circuit trips fails fast instead of riding into the dead
        device one batch at a time.

        In half-open, exactly ONE dispatch is the trial: concurrent
        callers that lose the claim fail fast (503) instead of
        thundering-herding into a possibly-still-dead device when the
        cooldown expires under load."""
        self.admit()
        with self._lock:
            if self._state_locked() == HALF_OPEN:
                if self._half_open_busy:
                    self._fast_fails += 1
                    raise OverloadedError(
                        "circuit half-open: trial dispatch in flight; "
                        "retry shortly",
                        retry_after_s=max(self.cooldown_s, 0.05),
                    )
                self._half_open_busy = True
        try:
            attempt = 0
            while True:
                try:
                    out = fn()
                except Exception as e:  # noqa: BLE001 — classified below
                    if not is_transient(e):
                        raise
                    with self._lock:
                        self._transient_failures += 1
                        can_retry = (
                            attempt < self.retries
                            and self._state_locked() == CLOSED
                        )
                        if can_retry:
                            self._retries_done += 1
                    if not can_retry:
                        self._record_failure()
                        raise
                    # The retry is visible in the request's span tree
                    # (child of the active dispatch span).
                    obs_trace.add_event(
                        "retry", attempt=attempt + 1,
                        error=type(e).__name__,
                    )
                    time.sleep(
                        min(
                            self.backoff_s * (2 ** attempt),
                            _RETRY_BACKOFF_CAP_S,
                        )
                    )
                    attempt += 1
                    continue
                self._record_success()
                return out
        finally:
            with self._lock:
                self._half_open_busy = False

    # -- accounting ---------------------------------------------------------

    def _record_success(self) -> None:
        with self._lock:
            if self._state_locked() != CLOSED:
                self._recoveries += 1
            self._state = CLOSED
            self._consecutive = 0

    def _record_failure(self) -> None:
        """A transient failure that exhausted its retries."""
        start_probe = False
        with self._lock:
            state = self._state_locked()
            self._consecutive += 1
            if state == HALF_OPEN or self._consecutive >= self.threshold:
                if self._state != OPEN:
                    self._trips += 1
                self._state = OPEN
                self._opened_at = time.perf_counter()
                start_probe = self._probe_enabled and not (
                    self._probe_thread and self._probe_thread.is_alive()
                )
                if start_probe:
                    self._probe_thread = threading.Thread(
                        target=self._probe_loop, daemon=True
                    )
        if start_probe:
            # start_probe is true only on the trip that just assigned
            # _probe_thread under the lock, and the is_alive() guard
            # keeps other trips from replacing it until this one exits.
            # lock-free-ok: only the assigning trip reaches this start()
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        """Background re-warm while open: each cooldown period, run the
        probe (plan-cache re-warm); success -> half_open, failure
        restarts the cooldown clock.  Exits as soon as the breaker
        leaves the open state."""
        while True:
            time.sleep(self.cooldown_s)
            with self._lock:
                if self._state != OPEN:
                    return
                self._probe_runs += 1
            try:
                self._probe()
            except Exception:  # noqa: BLE001 — a failing probe stays open
                with self._lock:
                    if self._state == OPEN:
                        self._opened_at = time.perf_counter()
                continue
            with self._lock:
                if self._state == OPEN:
                    self._state = HALF_OPEN
                return

    def stats(self) -> dict:
        with self._lock:
            state = self._state_locked()
            return {
                "state": state,
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "cooldown_ms": round(self.cooldown_s * 1e3, 3),
                "trips": self._trips,
                "fast_fails": self._fast_fails,
                "retries": self._retries_done,
                "transient_failures": self._transient_failures,
                "recoveries": self._recoveries,
                "probe_runs": self._probe_runs,
            }
