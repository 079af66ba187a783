"""Transport-neutral request handler core of the port's sidecar.

The port's counterpart of ``dpf_tpu/serving/handlers.py``: every route of
the reference's handler core (the 15 routes of ``docs/CONTRACT.json`` and
the HTTP-only GET surface), dispatching through the port's
``core/plans.py`` on the sidecar's device.  With the same request bytes it
gives the same reply bytes, statuses, error codes and headers.

  :class:`Request`   what a front parsed off its wire: route path, params
      (the query-string dict), the body as a buffer, or a
      :class:`BodyReader` for the two streamed-upload routes, plus the raw
      deadline/trace metadata.
  :class:`Reply`     what the front must write: status, gathered body
      chunks (buffer objects), or a progressive ``stream`` generator for
      streamed EvalFull, plus Retry-After, trace handle, and
      framing-poisoned flags.
  :func:`respond`    the whole request pipeline: flight-recorder trace
      begin, route dispatch, and the structured-error mapping (429 shed /
      503 open circuit / 504 deadline / 400 validation / 500 type-name-only).

The serving machinery (:class:`_ServingState`: micro-batcher, key-repack
LRU, breaker, tracer, phase timers, ONE stats lock) lives here too, with
the device it serves on: the card unless built with ``device="cpu"``.

Deliberate differences from the JAX sidecar:

  * **Gen while degraded.**  While the breaker is not closed the reference
    pins Gen to the host tower (``keys_gen.host_only()``).  The port keeps
    Gen on the card: the port's rule is Gen on the card with no fallback,
    and an open breaker already fails fast with 503 before any dispatch.
  * **Mesh and tuned blocks.**  ``/v1/stats`` reports ``mesh`` and
    ``tuned`` as the reference does with the mesh off and no tuned table
    (and so do the ``dpf_mesh_shards``, ``dpf_tuned_configs`` and
    ``dpf_tuned_plans`` gauges), from the port's own constants, until the
    multi-GPU and tuning slices (ROADMAP A.6, A.9).
  * **Plan failures.**  A capture or replay that fails on the card
    (``plans.PlanError``) answers 500 ``internal`` with the plan key in
    ``detail``; the reference has no such failure.
  * **The device gate.**  Eager device work of a route outside the plans
    (the streamed EvalFull's blocks, a PIR database's placement, the
    single point of ``/v1/eval``) holds ``plans.device_work``, so a
    capture never shares the card with it.
  * **/v1/eval on the card.**  The reference answers the one-point route
    with the host spec; the port runs the point through the pointwise
    walk kernel on the server's device, after the spec's own checks of
    the key and the point (so an error reply keeps the reference's
    bytes).  No route runs a plain version while a card is in use.
  * **A wedged card.**  A sticky CUDA error (``core/transients.py``)
    leaves the process's CUDA context unusable.  The first one marks the
    serving state wedged: ``/readyz`` and ``/healthz`` then answer 503
    ``unavailable``, so an orchestrator restarts the process.  The
    reference has no such failure.

The HTTP/1.1 front (``server.py``) is the only front for now; the wire2
front comes with a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from urllib.parse import parse_qs

import numpy as np

from ..core import bitpack, knobs, plans
from ..core import chacha_np as cc
from ..core import spec as compat_spec
from ..core.device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..obs import trace as obs_trace
from ..utils.profiling import PhaseTimer
from . import faults
from .batcher import (
    Batcher,
    GenWork,
    HHExtendWork,
    HHWork,
    IntervalWork,
    PirWork,
    PointsWork,
    dispatch_gen,
    dispatch_hh,
    dispatch_hh_extend,
    dispatch_interval,
    dispatch_pir,
    dispatch_points,
)
from .breaker import CircuitBreaker, is_sticky, is_transient
from .errors import CODES, DeadlineError, ServingError
from .headers import (  # noqa: F401 — re-exported (server.py, tests)
    DEADLINE_HEADER,
    TRACE_HEADER,
)
from .keycache import KeyCache

# ServingError.code -> flight-recorder outcome (obs/trace.OUTCOMES).
_ERROR_OUTCOMES = {
    "shed": "shed",
    "deadline": "expired",
    "unavailable": "breaker_rejected",
}

# ---------------------------------------------------------------------------
# Route table: u16 route id <-> the canonical route path (docs/CONTRACT.json;
# the wire2 front and the Go client use the ids).  Observability GETs
# (/v1/stats, /v1/metrics, /v1/trace, healthz/readyz) stay HTTP-only.
# ---------------------------------------------------------------------------
ROUTE_IDS: dict[int, str] = {
    1: "/v1/gen",
    2: "/v1/eval",
    3: "/v1/evalfull",
    4: "/v1/evalfull_batch",
    5: "/v1/eval_points_batch",
    6: "/v1/dcf_gen",
    7: "/v1/dcf_eval_points",
    8: "/v1/dcf_interval_gen",
    9: "/v1/dcf_interval_eval",
    10: "/v1/hh/gen",
    11: "/v1/hh/eval",
    12: "/v1/agg/submit",
    13: "/v1/pir/db",
    14: "/v1/pir/query",
    15: "/v1/warmup",
}
ROUTE_PATHS: dict[str, int] = {v: k for k, v in ROUTE_IDS.items()}

# Routes whose body is CONSUMED INCREMENTALLY through a BodyReader (the
# streamed uploads) — every other route gets its body as one buffer.
SINK_ROUTES = frozenset({"/v1/agg/submit", "/v1/pir/db"})

# The GET surface (respond_get) plus the profiler control route.
HTTP_ONLY_ROUTES = frozenset({
    "/healthz", "/readyz", "/v1/stats", "/v1/metrics", "/v1/trace", "/v1/profile",
})

# What /v1/stats reports in its ``mesh`` and ``tuned`` blocks: the
# reference's values with the mesh off and no tuned table.
MESH_STATS = {"shards": 0, "mode": "off", "device_budget": 0}
TUNED_STATS = {"mode": "off", "path": "", "loaded": False, "entries": 0,
               "backend": "", "error": ""}


def parse_params(query: str) -> dict[str, str]:
    """Query-string -> first-value dict (the fronts' param decoding).

    The common case — short ascii params, no percent-escapes — takes a
    split fast path instead of ``parse_qs``'s per-request CPU.  Escaped
    queries fall back to ``parse_qs``; both paths agree on the contract
    (first value wins, blank values dropped), as in the reference."""
    if not query:
        return {}
    if "%" in query or "+" in query or ";" in query:
        return {k: v[0] for k, v in parse_qs(query).items()}
    out: dict[str, str] = {}
    for part in query.split("&"):
        k, _, v = part.partition("=")
        if k and v and k not in out:
            out[k] = v
    return out


def read_exact_into(
    rfile, mv: memoryview,
    eof_exc: type[Exception] = ValueError,
    eof_msg: str = "upload truncated mid-chunk",
) -> None:
    """Fill ``mv`` completely from ``rfile`` (an object with
    ``readinto``), looping over short reads.  A slow client that
    delivers a chunk in many TCP segments must never be mistaken for
    EOF — ``rfile.read(n)`` returning short IS how a loaded socket
    behaves, and treating it as end-of-upload silently truncates a
    fold.  Raises ``eof_exc`` on true EOF mid-body (ValueError -> a
    clean 400 on the upload routes)."""
    got = 0
    n = mv.nbytes
    while got < n:
        r = rfile.readinto(mv[got:] if got else mv)
        if not r:
            raise eof_exc(eof_msg)
        got += r


class BodyReader:
    """Incremental request-body source for the streamed-upload routes.

    ``next_chunk(n)`` returns a zero-copy ``memoryview`` of the next
    ``n`` body bytes in the transport's own receive buffer (valid until
    the next call); ``readinto(mv)`` fills a caller-owned buffer (used
    when the destination is persistent, e.g. the PIR database rows).
    ``consumed``/``total`` let the error path detect a half-read body
    whose remainder would misframe the connection.
    """

    consumed: int = 0
    total: int = 0

    @property
    def drained(self) -> bool:
        return self.consumed >= self.total

    def next_chunk(self, n: int) -> memoryview:  # pragma: no cover
        raise NotImplementedError

    def readinto(self, mv: memoryview) -> None:  # pragma: no cover
        raise NotImplementedError


class FileBodyReader(BodyReader):
    """BodyReader over a file-like socket stream (the HTTP/1.1 front).

    ``next_chunk`` reads into ONE reusable scratch buffer (grown to the
    largest chunk seen, reused across chunks of the request) — the
    short-read-robust replacement for the old ``rfile.read(n)`` loops.
    """

    def __init__(self, rfile, total: int):
        self._rfile = rfile
        self.total = int(total)
        self.consumed = 0
        self._scratch = memoryview(b"")

    def next_chunk(self, n: int) -> memoryview:
        if self._scratch.nbytes < n:
            self._scratch = memoryview(bytearray(n))
        view = self._scratch[:n]
        read_exact_into(self._rfile, view)
        self.consumed += n
        return view

    def readinto(self, mv: memoryview) -> None:
        read_exact_into(self._rfile, mv)
        self.consumed += mv.nbytes


@dataclasses.dataclass
class Request:
    """One parsed request, transport-independent.  ``body`` is any
    buffer object (the HTTP front passes the read bytes; a binary front
    may pass a ``memoryview`` into its receive buffer) for buffered
    routes; the SINK_ROUTES get ``body_reader`` instead."""

    route: str
    params: dict[str, str]
    body: object = b""
    body_reader: BodyReader | None = None
    content_length: int = 0
    # Raw deadline milliseconds (the header / pseudo-param value), None
    # when the client sent none (the knob default applies).
    deadline_ms: str | None = None
    trace_id: str | None = None
    front: str = "http"

    def deadline(self) -> float | None:
        """The request's absolute deadline (perf_counter seconds) or
        None: the client value wins, DPF_CUDA_DEADLINE_MS is the server
        default, 0/absent means unbounded."""
        if self.deadline_ms is None:
            ms = knobs.get_float("DPF_CUDA_DEADLINE_MS")
            if ms <= 0:
                return None
        else:
            ms = float(self.deadline_ms)
            if ms <= 0:
                raise ValueError(
                    f"{DEADLINE_HEADER} must be a positive ms count"
                )
        return time.perf_counter() + ms / 1e3


@dataclasses.dataclass
class Reply:
    """One reply for the front to write.  ``chunks`` are buffer objects
    written one after another (no join, no re-serialization);
    ``stream``/``stream_len`` replace them for the
    progressive EvalFull body.  ``timed`` marks serving replies whose
    write belongs to the "reply" phase (+ reply span + the
    ``reply.write`` fault site); ``close_connection`` marks a poisoned
    framing (unread body bytes) the front must not reuse."""

    status: int
    chunks: list = dataclasses.field(default_factory=list)
    ctype: str = "application/octet-stream"
    retry_after_s: float | None = None
    stream: object = None  # generator of buffer chunks, or None
    stream_len: int = 0  # declared body length of a streamed reply
    timed: bool = False
    close_connection: bool = False
    outcome: str = "ok"
    trace: object = None

    @property
    def body_len(self) -> int:
        if self.stream is not None:
            return self.stream_len
        return sum(_blen(c) for c in self.chunks)


def _blen(chunk) -> int:
    return chunk.nbytes if isinstance(chunk, memoryview) else len(chunk)


def _wire_chunk(arr: np.ndarray) -> memoryview:
    """A device-returned array as a writable-free reply chunk: one
    contiguous buffer view, no ``tobytes`` re-serialization."""
    return memoryview(np.ascontiguousarray(arr)).cast("B")


def _wire_format(q: dict) -> bool:
    """Resolve the response format for a points endpoint -> packed? bool.
    Per-request ``format`` param wins; ``DPF_CUDA_WIRE_FORMAT`` sets the
    server default; unknown values are a 400 (ValueError)."""
    fmt = q.get("format", knobs.get_str("DPF_CUDA_WIRE_FORMAT"))
    if fmt not in ("bits", "packed"):
        raise ValueError(f"unknown format {fmt!r} (use bits|packed)")
    return fmt == "packed"


def _run_evalfull(profile: str, kb, device):
    faults.fire("dispatch.evalfull")
    return plans.run_evalfull(profile, kb, device=device)


def _run_gen(st, kind, alphas, log_n, deadline, trace):
    """Gen routes through the micro-batcher gen lane -> (batch_a,
    batch_b), on the sidecar's device.  Unlike the reference, a degraded
    breaker does not move Gen to the host tower (module docstring)."""
    work = GenWork(kind, alphas, log_n, deadline=deadline, trace=trace)
    return st.run(work, dispatch_gen)


def _profile_api(profile: str):
    if profile == "fast":
        from .. import fast
        from ..core.chacha_np import key_len
        from ..core.keys_chacha import KeyBatchFast

        return fast, key_len, KeyBatchFast
    import dpf_tpu_torch

    from ..core.keys import KeyBatch
    from ..core.spec import key_len

    return dpf_tpu_torch, key_len, KeyBatch


class _ServingState:
    """Per-process serving machinery: micro-batcher, host-repack LRU and
    the thread-merged phase timers, and the device every dispatch runs on
    (``device``: None is the card, raising without CUDA unless the caller
    passes ``"cpu"``).  Built lazily on first request so env knobs set by
    tests/deployments before traffic take effect."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # A DPF_CUDA_FAULTS spec activates (or refuses loudly) before any
        # traffic; programmatic test installs are left untouched when the
        # knob is empty.
        faults.install_from_env()
        # ONE stats lock (re-entrant) shared by every counter surface —
        # batcher stats, breaker counters, key-cache LRU, phase timers,
        # metrics histograms — so ``stats_snapshot`` (and /v1/metrics,
        # rendered from the same snapshot) is a single consistent cut
        # across all of them, never a torn read of one component mid-
        # update.  Queue/state structure sharing the same lock is fine:
        # no component holds it across a dispatch, sleep, or socket op.
        self.stats_lock = threading.RLock()
        self.metrics = obs_metrics.MetricsHub(lock=self.stats_lock)
        self.batcher = Batcher(lock=self.stats_lock, metrics=self.metrics)
        self.keys = KeyCache(lock=self.stats_lock)
        self.phases = PhaseTimer()
        self.batch_enabled = knobs.get_bool("DPF_CUDA_BATCH")
        # The breaker's background probe re-warms what was being served
        # (most recently used plans: on the card, graph replays) so
        # recovery never lands a capture on the half-open trial request.
        self.breaker = CircuitBreaker(
            probe=lambda: plans.rewarm_recent(device=self.device),
            lock=self.stats_lock,
        )
        # Incremental heavy-hitters descent sessions (apps/hh_state.py):
        # session id -> device-resident frontier.  Shares the stats lock
        # so eviction sweeps and /v1/stats snapshots never tear.
        from ..apps import hh_state as _hh_state

        self.hh_sessions = _hh_state.SessionCache(lock=self.stats_lock)
        self.tracer = obs_trace.Tracer()
        # Readiness (GET /readyz): flipped by the first successful
        # POST /v1/warmup — a sidecar that never warmed serves traffic
        # but advertises not-ready so load generators hold fire.
        self.warmed = False
        # The type name of the first sticky CUDA error a request hit
        # (None while the card is sound): the context cannot run anything
        # again, so readiness and liveness both drop until a restart.
        self.wedged: str | None = None
        # Per-front marshalling ledger (the allocation probe's committed
        # surface): request bodies received and how many of their bytes
        # were COPIED between socket buffer and dispatch operand.  The
        # HTTP/1.1 front copies every buffered body once (rfile.read).
        self.wire: dict[str, dict[str, int]] = {}

    def note_body(self, front: str, nbytes: int, copied: int) -> None:
        """One request body into the marshalling ledger."""
        with self.stats_lock:
            w = self.wire.setdefault(
                front, {"requests": 0, "body_bytes": 0, "body_bytes_copied": 0}
            )
            w["requests"] += 1
            w["body_bytes"] += int(nbytes)
            w["body_bytes_copied"] += int(copied)

    def note_wedged(self, e: BaseException) -> None:
        """Mark the process wedged by ``e``, a sticky CUDA error."""
        with self.stats_lock:
            if self.wedged is None:
                self.wedged = type(e).__name__

    def degraded(self) -> bool:
        """True while the breaker is not closed: the batcher is bypassed
        (a failing dispatch fans to ONE request, not a coalesced batch)
        and streamed EvalFull falls back to buffered replies (failures
        surface as a clean status line, never a truncated body).  All
        degraded paths give the same bytes as the fast path."""
        return self.breaker.degraded()

    def _note_phase(self, name: str, dt: float, n: int = 1) -> None:
        """One phase observation into BOTH surfaces — the /v1/stats sum
        counters and the /v1/metrics latency histogram — under the single
        stats lock."""
        with self.stats_lock:
            self.phases.add(name, dt, n)
            self.metrics.observe_phase(name, dt)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._note_phase(name, time.perf_counter() - t0)

    def merge_timer(self, tm: PhaseTimer) -> None:
        # A streamed run's timer arrives pre-accumulated; each merged
        # phase is one histogram observation of its total.
        with self.stats_lock:
            for name, dt in tm.phases.items():
                self._note_phase(name, dt, tm.counts[name])

    def run(self, work, dispatch):
        """One request through the fast path: breaker admission ->
        micro-batcher (when enabled and healthy) -> plan cache ->
        per-request result rows.  Dispatches run under the breaker
        (transient retries + trip accounting); deadline checkpoints
        bracket the passthrough path the same way the batcher brackets
        its queue."""
        tr = getattr(work, "trace", None)
        with obs_trace.maybe_span(tr, "admission"):
            self.breaker.admit()

        def guarded(items):
            return self.breaker.call(lambda: dispatch(items, device=self.device))

        if self.batch_enabled and not self.breaker.degraded():
            res = self.batcher.submit(work, guarded)
        else:
            # Passthrough: batching disabled, or degraded while the
            # breaker recovers.
            if work.deadline is not None and (
                time.perf_counter() >= work.deadline
            ):
                self.batcher.note_expired("queue")
                raise DeadlineError(
                    "deadline expired before dispatch", where="queue"
                )
            t0 = time.perf_counter()
            with obs_trace.traced_dispatch(tr) as dspan:
                res = guarded([work])[0]
                if dspan is not None:
                    dspan.set_attrs(coalesced=work.n_keys)
            work.dispatch_s = time.perf_counter() - t0
            work.coalesced = work.n_keys
            if work.deadline is not None and (
                time.perf_counter() >= work.deadline
            ):
                self.batcher.note_expired("flight")
                raise DeadlineError(
                    "deadline expired in flight", where="flight"
                )
        self._note_phase("queue_wait", work.queue_wait)
        # A coalesced dispatch is shared: attribute each request its
        # key-row share so phases.compute sums to real device time
        # (the batcher's dispatch_seconds holds the per-dispatch
        # truth).
        self._note_phase(
            "compute",
            work.dispatch_s * work.n_keys / max(work.coalesced, 1),
        )
        return res

    def direct(self, fn, deadline: float | None = None, trace=None):
        """Breaker-guarded non-batched dispatch (the evalfull routes)
        with the same deadline checkpoints as the batcher path; expiry
        shares the batcher's /v1/stats counters."""
        with obs_trace.maybe_span(trace, "admission"):
            self.breaker.admit()
        if deadline is not None and time.perf_counter() >= deadline:
            self.batcher.note_expired("queue")
            raise DeadlineError(
                "deadline expired before dispatch", where="queue"
            )
        with obs_trace.traced_dispatch(trace):
            out = self.breaker.call(fn)
        if deadline is not None and time.perf_counter() >= deadline:
            self.batcher.note_expired("flight")
            raise DeadlineError("deadline expired in flight", where="flight")
        return out

    def stats_snapshot(self) -> dict:
        """Consistent /v1/stats payload, taken as ONE critical section
        under the single stats lock (the component stats() calls
        re-acquire the same RLock): batcher, breaker, and key-cache
        counters can never be torn against each other mid-update.
        /v1/metrics renders from this same snapshot, so the two surfaces
        cannot drift."""
        from ..apps import pir_store

        with self.stats_lock:
            out = {
                "plans": plans.cache().stats(),
                "batcher": self.batcher.stats_dict(),
                "key_cache": self.keys.stats(),
                "phases": self.phases.as_dict(),
                "batch_enabled": self.batch_enabled,
                "breaker": self.breaker.stats(),
                "degraded": self.degraded(),
                "trace": self.tracer.stats(),
                "mesh": dict(MESH_STATS),
                "pir": pir_store.registry().stats(),
                "hh_state": self.hh_sessions.stats(),
                "tuned": dict(TUNED_STATS),
                "wire": {k: dict(v) for k, v in self.wire.items()},
            }
        plan = faults.active()
        if plan is not None:
            # An injected run must never be mistakable for a healthy one.
            out["faults"] = plan.stats()
        return out

    def metrics_text(self) -> str:
        """The /v1/metrics body: stats + histogram state captured in one
        critical section, rendered outside it.  The card's memory gauges
        are read under the device gate (never during a capture)."""
        with self.stats_lock:
            snap = self.stats_snapshot()
            hists = self.metrics.snapshot()
        with plans.device_work():
            mem = obs_metrics.device_memory_gauges(self.device)
        return obs_metrics.render(snap, hists, device_mem=mem)


_STATE: _ServingState | None = None
_STATE_LOCK = threading.Lock()


def serving_state(device=None) -> _ServingState:
    """The process's serving state, built at the first call on ``device``
    (None: the card); later calls return it as built."""
    global _STATE
    with _STATE_LOCK:
        if _STATE is None:
            _STATE = _ServingState(device)
        return _STATE


def reset_serving_state() -> None:
    """Drop the lazy serving singleton (the next request re-reads the
    batching and cache env knobs, and the server's device)."""
    global _STATE
    with _STATE_LOCK:
        _STATE = None


def _evalfull_out_bytes(profile: str, log_n: int) -> int:
    """The models' output-row contract, in one place: 2^(log_n-3) bytes
    with the profile's leaf-width floor (compat 16, fast 64)."""
    return max((1 << log_n) >> 3, 64 if profile == "fast" else 16)


def _stream_mode(q: dict, out_bytes: int) -> bool:
    """Resolve streaming for /v1/evalfull: per-request ``stream`` param
    wins; DPF_CUDA_STREAM=off|auto|on sets the default (auto streams
    responses >= DPF_CUDA_STREAM_MIN_BYTES, default 1 MiB)."""
    v = q.get("stream")
    if v is not None:
        if v not in ("0", "1"):
            raise ValueError(f"unknown stream {v!r} (use 0|1)")
        return v == "1"
    raw = knobs.get_raw("DPF_CUDA_STREAM")
    env = knobs.knob("DPF_CUDA_STREAM").default if raw is None else raw.lower()
    if env in ("on", "1", "true"):
        return True
    if env in ("off", "0", "false", ""):
        return False
    if env != "auto":
        raise ValueError(f"DPF_CUDA_STREAM={env!r} unknown (off|auto|on)")
    return out_bytes >= knobs.get_int("DPF_CUDA_STREAM_MIN_BYTES")


def _reply_error(
    code: str, detail: str,
    retry_after_s: float | None = None,
) -> Reply:
    """Structured error reply: ``{code, detail}`` JSON plus a
    Retry-After hint (whole seconds, rounded up by the front) when the
    error carries a backoff.  The HTTP status is DERIVED from the
    canonical ``errors.CODES`` table — call sites name the failure
    class once and cannot drift from its status.  ``detail`` must be
    client-safe — the secret-hygiene lint treats this call as a taint
    sink."""
    body = json.dumps({"code": code, "detail": detail}).encode()
    return Reply(
        CODES[code], [body], "application/json", retry_after_s=retry_after_s
    )


def _json_reply(payload: dict, timed: bool = False) -> Reply:
    return Reply(
        200, [json.dumps(payload).encode()], "application/json", timed=timed
    )


def map_error(e: Exception, st: _ServingState) -> Reply:
    """Exception -> structured error Reply (outcome pre-set): 429 shed /
    503 open circuit / 504 missed deadline (``ServingError`` carries its
    own mapping plus a Retry-After derived from observed dispatch
    latency), 400 for our own validation messages, and 500/503 with the
    exception TYPE only for everything else — deep library reprs can
    embed operand values (key material), and transient device
    signatures (core/transients.py) map to 503 so clients back off
    instead of hammering a failing device.  A failed capture or replay
    (``plans.PlanError``, not transient) is 500 with its plan key, which
    is public shape metadata.  A sticky CUDA error also marks the
    process wedged (``_ServingState.note_wedged``).  Shared by ``respond``
    and the front's write path."""
    if is_sticky(e):
        st.note_wedged(e)
    if isinstance(e, ServingError):
        reply = _reply_error(e.code, e.detail, e.retry_after_s)
        reply.outcome = _ERROR_OUTCOMES.get(e.code, "error")
    elif isinstance(e, (ValueError, KeyError)):
        # Validation failures: our own parameter/shape messages (the
        # secret-hygiene pass keeps raises in this tree free of key
        # bytes, so str(e) is client-safe here).
        detail = (
            f"missing parameter {e}" if isinstance(e, KeyError) else str(e)
        )
        reply = _reply_error("bad_request", detail)
        reply.outcome = "bad_request"
    elif is_transient(e):
        reply = _reply_error(
            "unavailable", type(e).__name__,
            retry_after_s=st.breaker.cooldown_s,
        )
        reply.outcome = "error"
    elif isinstance(e, plans.PlanError):
        reply = _reply_error("internal", f"{type(e).__name__}: plan {e.plan_key}")
        reply.outcome = "error"
    else:
        reply = _reply_error("internal", type(e).__name__)
        reply.outcome = "error"
    return reply


def respond(req: Request, st: _ServingState) -> Reply:
    """One request end-to-end, minus the byte I/O: flight-recorder
    begin, route dispatch, error mapping.  Never raises — every failure
    becomes a structured error Reply (clean error propagation across
    the bridge, SURVEY §5.3 — never a crashed server).  The front
    writes the Reply and then calls
    ``st.tracer.finish(reply.trace, reply.outcome)``."""
    trace = None
    try:
        if req.route not in ("/v1/warmup", "/v1/profile"):
            # Flight-recorder trace for the serving routes (None when
            # DPF_CUDA_TRACE=off): id from the client's X-DPF-Trace
            # header, or generated here at ingress.
            trace = st.tracer.begin(req.trace_id, req.route)
        reply = _handle(req, st, trace)
    except Exception as e:  # noqa: BLE001 — bridge must not crash
        reply = map_error(e, st)
    reply.trace = trace
    if req.body_reader is not None and not req.body_reader.drained:
        # The transport still holds unread upload bytes: replying over
        # them would leave the next request misframed.  The front must
        # close the connection.
        reply.close_connection = True
    return reply


def _handle(req: Request, st: _ServingState, trace) -> Reply:
    q = req.params
    route = req.route

    if route == "/v1/agg/submit":
        # The aggregation upload is the one body that must NOT be read
        # whole: it streams off the transport in aggregation.AGG_CHUNK_BYTES
        # chunks, one fold dispatch per chunk (apps/aggregation.py).
        return _agg_submit(req, st, trace)
    if route == "/v1/pir/db":
        # The other streamed upload: database rows read in
        # DPF_CUDA_PIR_DB_CHUNK_BYTES chunks into the packed host buffer
        # (apps/pir_store.py).
        return _pir_db_load(req, st, trace)

    body = memoryview(req.body).cast("B") if req.body else memoryview(b"")

    if route == "/v1/warmup":
        # wire-copy-ok: warmup is a JSON control body, not the hot path.
        spec = json.loads(bytes(body) or b"[]")
        shapes = spec.get("shapes", []) if isinstance(spec, dict) else spec
        warmed = plans.warmup(shapes, device=st.device)
        if warmed:
            # /readyz flips to 200 — but only when this warmup actually
            # built something: an empty spec must not advertise
            # readiness over a cold plan cache.
            st.warmed = True
        return _json_reply(
            {"warmed": warmed, "trace_cache_entries": plans.capture_count()}
        )
    if route == "/v1/profile":
        return _profile_request(body)
    if route == "/v1/pir/query":
        # Profile and domain come from the registered database, not the
        # query string — handled before the generic profile/log_n
        # parsing below.
        return _pir_query(req, body, st, trace)

    profile = q.get("profile", "compat")
    api, key_len, batch_cls = _profile_api(profile)
    # The reference serves any profile but "fast" as compat on the
    # evalfull and pointwise routes; ``kind`` is what their plans run.
    kind = "fast" if profile == "fast" else "compat"
    if route in ("/v1/gen", "/v1/eval"):
        log_n = int(q["log_n"])
        deadline = req.deadline()
        if route == "/v1/gen":
            # Single-point gen rides the coalescing gen lane: concurrent
            # requests of one key family tower as ONE device dispatch
            # (the dealer on the card, models/keys_gen.py).
            alpha = int(q.get("alpha", 0))
            ka, kb = _run_gen(
                st, kind, np.array([alpha], np.uint64), log_n, deadline,
                trace,
            )
            return Reply(200, [ka.to_bytes()[0] + kb.to_bytes()[0]])
        # wire-copy-ok: one-key single-point debug route, not hot path
        key, x = body.tobytes(), int(q["x"])
        # The spec's checks first, so a bad key or point fails with the
        # reference's message; then the walk on the server's device.
        (cc if kind == "fast" else compat_spec).check_point(key, x, log_n)
        with plans.device_work():
            bit = api.Eval(key, x, log_n, backend="walk", device=st.device)
        return Reply(200, [bytes([bit])])

    log_n = int(q["log_n"])
    deadline = req.deadline()
    if trace is not None:
        trace.set_attrs(profile=profile, log_n=log_n)

    def cached_keys(kind, blob, k, kl, cls=None):
        """Parse ``k`` concatenated keys through the repack LRU.  The
        blob is a buffer view — the LRU digests it without copying
        (serving/keycache.py) and the parse slices stay views."""
        cls = cls or batch_cls
        with st.phase("pack"):
            return st.keys.get(
                kind, log_n, blob,
                lambda: cls.from_bytes(
                    [blob[i * kl : (i + 1) * kl] for i in range(k)],
                    log_n,
                ),
            )

    if route == "/v1/evalfull":
        kl = key_len(log_n)
        if len(body) != kl:
            raise ValueError(f"body must be one {kl}-byte key")
        kb = cached_keys(profile, body, 1, kl)
        if _stream_mode(
            q, _evalfull_out_bytes(profile, log_n)
        ) and not st.degraded():
            # (Degraded mode buffers: a dispatch error surfaces as a
            # clean status line, never a truncated stream.)
            with obs_trace.maybe_span(trace, "admission"):
                st.breaker.admit()
            return _evalfull_stream_reply(profile, kb, log_n, st, deadline)
        with st.phase("dispatch"):
            out = st.direct(
                lambda: _run_evalfull(kind, kb, st.device), deadline,
                trace=trace,
            )
        return Reply(200, [_wire_chunk(out[0])], timed=True)
    if route == "/v1/evalfull_batch":
        k = int(q["k"])
        kl = key_len(log_n)
        if len(body) != k * kl:
            raise ValueError(f"body must be {k}*{kl} bytes")
        kb = cached_keys(profile, body, k, kl)
        with st.phase("dispatch"):
            out = st.direct(
                lambda: _run_evalfull(kind, kb, st.device), deadline,
                trace=trace,
            )
        return Reply(200, [_wire_chunk(out)], timed=True)
    if route == "/v1/eval_points_batch":
        k, nq = int(q["k"]), int(q["q"])
        kl = key_len(log_n)
        if len(body) != k * kl + k * nq * 8:
            raise ValueError(
                f"body must be {k}*{kl} key bytes + {k}*{nq}*8 index bytes"
            )
        packed = _wire_format(q)
        kb = cached_keys(profile, body[: k * kl], k, kl)
        xs = np.frombuffer(body[k * kl :], dtype="<u8").reshape(k, nq)
        words = st.run(
            PointsWork(
                "points", kind, kb, xs, deadline=deadline, trace=trace
            ),
            dispatch_points,
        )
        return _points_reply(words, nq, packed)
    if route == "/v1/dcf_gen":
        from ..models import dcf

        k = int(q["k"])
        if len(body) != k * 8:
            raise ValueError(f"body must be {k}*8 alpha bytes")
        alphas = np.frombuffer(body, dtype="<u8")
        da, db = _run_gen(st, "dcf", alphas, log_n, deadline, trace)
        return Reply(
            200, [b"".join(da.to_bytes()), b"".join(db.to_bytes())]
        )
    if route == "/v1/dcf_eval_points":
        from ..models import dcf

        k, nq = int(q["k"]), int(q["q"])
        kl = dcf.key_len(log_n)
        if len(body) != k * kl + k * nq * 8:
            raise ValueError(
                f"body must be {k}*{kl} key bytes + {k}*{nq}*8 index bytes"
            )
        packed = _wire_format(q)
        kb = cached_keys("dcf", body[: k * kl], k, kl, cls=dcf.DcfKeyBatch)
        xs = np.frombuffer(body[k * kl :], dtype="<u8").reshape(k, nq)
        words = st.run(
            PointsWork(
                "dcf_points", "fast", kb, xs, deadline=deadline, trace=trace
            ),
            dispatch_points,
        )
        return _points_reply(words, nq, packed)
    if route == "/v1/dcf_interval_gen":
        from ..models import dcf

        k = int(q["k"])
        if len(body) != k * 16:
            raise ValueError(f"body must be {k}*8 lo + {k}*8 hi bytes")
        bounds = np.frombuffer(body, dtype="<u8")
        ia, ib = dcf.gen_interval_batch(
            bounds[:k], bounds[k:], log_n, device=st.device
        )

        def blob(ik):
            u, lo_, c = ik
            return (
                b"".join(u.to_bytes()) + b"".join(lo_.to_bytes())
                + c.astype("<u1").tobytes()
            )

        return Reply(200, [blob(ia), blob(ib)])
    if route == "/v1/dcf_interval_eval":
        from ..models import dcf

        k, nq = int(q["k"]), int(q["q"])
        kl = dcf.key_len(log_n)
        blob_len = 2 * k * kl + k
        if len(body) != blob_len + k * nq * 8:
            raise ValueError(
                f"body must be {blob_len} interval-share bytes "
                f"(2*{k}*{kl} keys + {k} consts) + {k}*{nq}*8 "
                "index bytes"
            )
        packed = _wire_format(q)

        def build_triple(blob=body[:blob_len]):
            def keys_at(off):
                return dcf.DcfKeyBatch.from_bytes(
                    [
                        blob[off + i * kl : off + (i + 1) * kl]
                        for i in range(k)
                    ],
                    log_n,
                )

            # The consts array is CACHED past this request: .copy() so
            # the LRU entry never aliases the transport's reused buffer.
            return (
                keys_at(0),
                keys_at(k * kl),
                np.frombuffer(blob[2 * k * kl :], dtype="<u1").copy(),
            )

        with st.phase("pack"):
            triple = st.keys.get(
                "dcf_interval", log_n, body[:blob_len], build_triple
            )
        xs = np.frombuffer(body[blob_len:], dtype="<u8").reshape(k, nq)
        words = st.run(
            IntervalWork(triple, xs, deadline=deadline, trace=trace),
            dispatch_interval,
        )
        return _points_reply(words, nq, packed)
    if route == "/v1/hh/gen":
        from ..apps import heavy_hitters as hh_app

        k = int(q["k"])
        if len(body) != k * 8:
            raise ValueError(f"body must be {k}*8 value bytes")
        values = np.frombuffer(body, dtype="<u8")
        sa, sb = hh_app.gen_shares(
            values, log_n, profile=profile,
            # The level-point gen rides the same coalescing gen lane as
            # /v1/gen (rng is the lane's own OS entropy).
            gen=lambda pts, n, rng=None: _run_gen(
                st, kind, pts, n, deadline, trace
            ),
        )
        return Reply(
            200, [hh_app.share_to_blob(sa), hh_app.share_to_blob(sb)]
        )
    if route == "/v1/hh/eval":
        k, nq = int(q["k"]), int(q["q"])
        level = int(q["level"])
        if not 0 <= level < log_n:
            raise ValueError(f"level must be in [0, {log_n}), got {level}")
        kl = key_len(log_n)
        if len(body) != k * kl + nq * 8:
            raise ValueError(
                f"body must be {k}*{kl} level-key bytes + "
                f"{nq}*8 candidate bytes"
            )
        packed = _wire_format(q)
        kb = cached_keys(profile, body[: k * kl], k, kl)
        cands = np.frombuffer(body[k * kl :], dtype="<u8")
        sid = q.get("session")
        if sid and knobs.get_enum("DPF_CUDA_HH_STATE") != "off":
            # Incremental descent: the body's keys are the LEVEL-(n-1)
            # keys (the session contract — same k, same key length) and
            # the session's cached frontier advances to depth level+1.
            # The reply is the same pure function of (keys, candidates,
            # level) whether the cache served, rebuilt, or just formed.
            import hashlib

            digest = hashlib.sha256(body[: k * kl]).hexdigest()
            words = st.run(
                HHExtendWork(
                    profile, kb, digest, sid, cands, level,
                    st.hh_sessions, deadline=deadline, trace=trace,
                ),
                dispatch_hh_extend,
            )
            return _points_reply(words, nq, packed)
        words = st.run(
            HHWork(
                profile, kb,
                np.broadcast_to(cands[None, :], (k, nq)), level,
                deadline=deadline, trace=trace,
            ),
            dispatch_hh,
        )
        return _points_reply(words, nq, packed)
    # A misrouted client is a client error, not a healthy request — its
    # trace must not pollute ?outcome=ok.
    return Reply(
        404, [b"not found"], "text/plain", outcome="bad_request"
    )


def _points_reply(words: np.ndarray, nq: int, packed: bool) -> Reply:
    """Reply chunks for the pointwise routes, straight from the
    device-returned packed words: the packed format is
    ``bitpack.words_to_wire_rows`` (the one definition of the row
    layout), the bits format the host-side unpack — both as buffer
    views, no ``tobytes`` re-serialization."""
    if packed:
        return Reply(
            200, [_wire_chunk(bitpack.words_to_wire_rows(words, nq))],
            timed=True,
        )
    return Reply(
        200, [_wire_chunk(bitpack.unpack_bits(words, nq))], timed=True
    )


def _evalfull_stream_reply(
    profile: str, kb, log_n: int, st: _ServingState,
    deadline: float | None = None,
) -> Reply:
    """One key's expansion as a progressive Reply: the generator yields
    each subtree chunk's bytes while the next chunk computes.  The
    first chunk is pulled BEFORE returning so evaluation errors still
    surface as a clean 400; deadline checkpoints mirror the buffered
    path — expiry before the Reply is a clean 504, expiry mid-stream
    raises OUT OF the generator (the front aborts the connection: the
    body can no longer be completed honestly) and counts as
    expired-in-flight."""
    if deadline is not None and time.perf_counter() >= deadline:
        st.batcher.note_expired("queue")
        raise DeadlineError("deadline expired before dispatch", where="queue")
    tm = PhaseTimer()
    if profile == "fast":
        from ..models.dpf_chacha import eval_full_stream
    else:
        from ..models.dpf import eval_full_stream
    gen = _gated(eval_full_stream(kb, timer=tm, device=st.device))
    first = next(gen)
    declared = _evalfull_out_bytes(profile, log_n)

    def chunks():
        # Only the transport's writes belong to the "reply" phase (the
        # front times them) — the generator's resumption does device
        # dispatch + D2H, which the stream's own timer already records
        # as dispatch/d2h.
        try:
            chunk = first
            while chunk is not None:
                if deadline is not None and (
                    time.perf_counter() >= deadline
                ):
                    st.batcher.note_expired("flight")
                    raise DeadlineError(
                        "deadline expired mid-stream", where="flight"
                    )
                faults.fire("stream.chunk")
                yield _wire_chunk(chunk[0])
                chunk = next(gen, None)
        finally:
            st.merge_timer(tm)

    return Reply(200, stream=chunks(), stream_len=declared, timed=True)


def _gated(gen):
    """Pull each block of a streamed expansion under the device gate
    (``plans.device_work``): a capture never runs while the stream
    enqueues work, and the socket write of a block happens outside it.
    Each block owns its own pinned buffer (core/stream.py), so writing one
    while the next computes is safe."""
    while True:
        with plans.device_work():
            chunk = next(gen, None)
        if chunk is None:
            return
        yield chunk


def _agg_submit(req: Request, st: _ServingState, trace) -> Reply:
    """POST /v1/agg/submit?op=xor|add&k=K&words=W — streamed secure
    aggregation.  Body: K client share rows of W uint32 words each
    (little-endian), consumed through the BodyReader in
    aggregation.AGG_CHUNK_BYTES (4 MiB) chunks so the [K, W] upload never
    materializes on host; reply: the W folded words.  Rides admission
    (breaker), deadlines (the checkpoint runs between chunks — a doomed
    upload stops burning device slots mid-body), and per-chunk
    transient retries like every other dispatch seam.  Any failure
    before the body is fully consumed poisons the connection framing
    (``respond`` flags it; the front closes or discards)."""
    from ..apps import aggregation as agg_app

    q = req.params
    reader = req.body_reader
    op = q.get("op", "xor")
    if op not in agg_app.OPS:
        raise ValueError(f"unknown op {op!r} (use xor|add)")
    k, words = int(q["k"]), int(q["words"])
    if k <= 0 or words <= 0:
        raise ValueError("k and words must be positive")
    row_bytes = words * 4
    if req.content_length != k * row_bytes:
        raise ValueError(f"body must be {k}*{row_bytes} bytes of uint32 rows")
    deadline = req.deadline()
    if trace is not None:
        trace.set_attrs(op=op, words=words, rows=k)
    with obs_trace.maybe_span(trace, "admission"):
        st.breaker.admit()
    step = agg_app.chunk_rows(words)
    carry = np.zeros(words, np.uint32)
    remaining = k
    with obs_trace.traced_dispatch(trace) as dspan:
        while remaining > 0:
            if deadline is not None and time.perf_counter() >= deadline:
                where = "queue" if reader.consumed == 0 else "flight"
                st.batcher.note_expired(where)
                raise DeadlineError("deadline expired mid-upload", where=where)
            take = min(step, remaining)
            # The body pull accounts to "pack" (host-side marshalling),
            # NOT "dispatch": a slow uploader must never spike the
            # device-health phase histogram.  ``next_chunk`` is a view
            # of the transport's receive buffer — zero copies between
            # socket and the fold operand.
            with st.phase("pack"):
                view = reader.next_chunk(take * row_bytes)
                rows = np.frombuffer(view, dtype="<u4").reshape(take, words)

            # The fault seam fires INSIDE the breaker call, like every
            # other dispatch.* site, so injected transients get the
            # breaker's retry/classification treatment.
            def fold_chunk(r=rows, c=carry):
                faults.fire("dispatch.agg")
                return plans.run_agg_fold(op, c, r, device=st.device)

            with st.phase("dispatch"):
                carry = st.breaker.call(fold_chunk)
            remaining -= take
        if dspan is not None:
            dspan.set_attrs(coalesced=k, chunks=-(-k // step))
    return Reply(
        200, [_wire_chunk(np.ascontiguousarray(carry, dtype="<u4"))],
        timed=True,
    )


def _pir_db_load(req: Request, st: _ServingState, trace) -> Reply:
    """POST /v1/pir/db?name=X&rows=N&row_bytes=B[&profile=] — register a
    named device-resident PIR database (apps/pir_store.py).  The body
    is read off the transport in DPF_CUDA_PIR_DB_CHUNK_BYTES chunks
    STRAIGHT into the packed host buffer (``BodyReader.readinto`` the
    database array — no intermediate chunk object at all on the HTTP
    front), with deadline checkpoints between chunks.  On success the
    database is placed resident for the CURRENT mesh regime, so query
    traffic never pays the device transfer."""
    from ..apps import pir_store

    q = req.params
    reader = req.body_reader
    name = q.get("name", "")
    pir_store.validate_name(name)  # BEFORE reading a byte
    profile = q.get("profile", "compat")
    if profile not in ("compat", "fast"):
        raise ValueError(f"unknown profile {profile!r}")
    rows, row_bytes = int(q["rows"]), int(q["row_bytes"])
    if rows <= 0 or row_bytes <= 0:
        raise ValueError("rows and row_bytes must be positive")
    if row_bytes % 4:
        raise ValueError("row_bytes must be a multiple of 4")
    if req.content_length != rows * row_bytes:
        raise ValueError(f"body must be {rows}*{row_bytes} bytes of row data")
    deadline = req.deadline()
    if trace is not None:
        trace.set_attrs(db=name, rows=rows, row_bytes=row_bytes)
    # Breaker admission before the buffer and the read loop: a wedged/
    # recovering device must shed a multi-GB upload (and its residency
    # placement) exactly like any other dispatch.
    with obs_trace.maybe_span(trace, "admission"):
        st.breaker.admit()
    db = np.empty((rows, row_bytes), np.uint8)
    dbv = memoryview(db).cast("B")
    step = pir_store.upload_chunk_rows(row_bytes)
    done = 0
    while done < rows:
        if deadline is not None and time.perf_counter() >= deadline:
            where = "queue" if reader.consumed == 0 else "flight"
            st.batcher.note_expired(where)
            raise DeadlineError("deadline expired mid-upload", where=where)
        take = min(step, rows - done)
        # The body pull accounts to "pack" (host marshalling), like the
        # agg upload — a slow uploader must never spike the
        # device-health phases.
        with st.phase("pack"):
            faults.fire("pir.db_load")
            reader.readinto(
                dbv[done * row_bytes : (done + take) * row_bytes]
            )
        done += take
    entry = pir_store.registry().load(name, db, profile=profile)
    # Place residency NOW, so the first query pays neither transfer nor
    # layout.  The placement copies the database to the card outside the
    # plans: it holds the device gate.
    shards = entry.dispatch_shards()
    with plans.device_work():
        srv = entry.server(shards, device=st.device)
    info = {
        "name": entry.name,
        "rows": entry.n_rows,
        "row_bytes": entry.row_bytes,
        "log_n": entry.log_n,
        "profile": entry.profile,
        "db_bytes": entry.db_bytes,
        "shards": shards,
        "stream_chunks": srv.stream_chunks,
    }
    return _json_reply(info, timed=True)


def _pir_query(req: Request, body: memoryview, st: _ServingState, trace) -> Reply:
    """POST /v1/pir/query?db=X&k=K — answer K PIR queries against a
    registered database through the batcher lane (concurrent queries
    coalesce into one selection-matrix matmul over the resident
    rows)."""
    from ..apps import pir_store

    q = req.params
    name = q["db"]  # KeyError -> 400 missing parameter
    try:
        db = pir_store.registry().get(name)
    except KeyError as e:
        raise ValueError(str(e.args[0])) from None
    k = int(q["k"])
    _, key_len, batch_cls = _profile_api(db.profile)
    kl = key_len(db.log_n)
    if len(body) != k * kl:
        raise ValueError(f"body must be {k}*{kl} key bytes")
    deadline = req.deadline()
    if trace is not None:
        trace.set_attrs(profile=db.profile, log_n=db.log_n, db=db.name)
    with st.phase("pack"):
        kb = st.keys.get(
            db.profile, db.log_n, body,
            lambda: batch_cls.from_bytes(
                [body[i * kl : (i + 1) * kl] for i in range(k)],
                db.log_n,
            ),
        )
    rows = st.run(
        PirWork(db, kb, deadline=deadline, trace=trace), dispatch_pir
    )
    return Reply(200, [_wire_chunk(rows)], timed=True)


def _profile_request(body: memoryview) -> Reply:
    """POST /v1/profile: knob-gated, duration-bounded profiler capture
    (obs/profile.py, ``torch.profiler``).  Body: ``{"action": "start"|"stop"|"status"
    [, "seconds": S][, "dir": path]}``."""
    # wire-copy-ok: a tiny JSON control body, not the hot path.
    spec = json.loads(bytes(body) or b"{}")
    action = spec.get("action", "start")
    try:
        if action == "start":
            out = obs_profile.start(spec.get("dir"), spec.get("seconds"))
        elif action == "stop":
            out = obs_profile.stop()
        elif action == "status":
            out = obs_profile.status()
        else:
            raise ValueError(f"unknown action {action!r} (start|stop|status)")
    except obs_profile.ProfileForbidden as e:
        return _reply_error("profile_forbidden", str(e))
    except obs_profile.ProfileBusy as e:
        return _reply_error("profile_active", str(e))
    except obs_profile.ProfileError as e:
        return _reply_error("bad_request", str(e))
    return _json_reply(out)


def _wedged_detail(st: _ServingState) -> str:
    return (f"the CUDA context is wedged by a sticky error ({st.wedged}); "
            f"restart the process")


def respond_get(path: str, params: dict, st: _ServingState) -> Reply:
    """The GET surface (health, readiness, observability) — HTTP-only
    by design (scrape traffic stays off the hot wire), but transport-
    neutral all the same."""
    if path == "/healthz":
        # Liveness ONLY: "ok" while the process serves requests,
        # regardless of breaker state or warmup.  Readiness is /readyz —
        # a restart-the-pod signal must never be conflated with a
        # hold-the-traffic signal.  A wedged card is the restart signal:
        # its context cannot serve again.
        if st.wedged is not None:
            return _reply_error("unavailable", _wedged_detail(st))
        return Reply(200, [b"ok"], "text/plain")
    if path == "/readyz":
        if st.wedged is not None:
            return _reply_error("unavailable", _wedged_detail(st))
        if st.breaker.degraded():
            return _reply_error(
                "breaker_open",
                f"circuit breaker is {st.breaker.state}",
                retry_after_s=st.breaker.cooldown_s,
            )
        if not st.warmed:
            return _reply_error(
                "cold", "warmup has not run (POST /v1/warmup first)"
            )
        return Reply(200, [b"ready"], "text/plain")
    if path == "/v1/stats":
        return _json_reply(st.stats_snapshot())
    if path == "/v1/metrics":
        return Reply(
            200, [st.metrics_text().encode()],
            "text/plain; version=0.0.4",
        )
    if path == "/v1/trace":
        # Only the QUERY-PARAM parsing maps to 400 — a rendering failure
        # must stay a 500, not masquerade as a scraper misconfiguration.
        try:
            outcome = params.get("outcome")
            if outcome is not None and outcome not in obs_trace.OUTCOMES:
                raise ValueError(
                    f"unknown outcome {outcome!r} "
                    f"(one of {', '.join(obs_trace.OUTCOMES)})"
                )
            n = int(params.get("n", 32))
        except ValueError as e:
            return _reply_error("bad_request", str(e))
        traces = st.tracer.recorder.query(
            n=n,
            slowest=params.get("slowest") == "1",
            trace_id=params.get("id"),
            outcome=outcome,
        )
        return _json_reply(
            {
                "enabled": st.tracer.enabled,
                "ring": st.tracer.recorder.stats(),
                "traces": [t.as_dict() for t in traces],
            }
        )
    return Reply(404, [b"not found"], "text/plain")
