"""Dynamic micro-batching: concurrent sidecar requests -> one dispatch.

The port's counterpart of ``dpf_tpu/serving/batcher.py``: the same lanes,
scheduling, shedding and deadlines, dispatching through the port's
``core/plans.py`` on the sidecar's device.  A single-key pointwise request
pays the same host->card->host round trip as a 256-key batch, so requests
whose **lane** (route, profile, log_n — everything that must agree for
their tensors to concatenate) matches coalesce into ONE plan call (on the
card, one graph replay), and each requester slices its rows back out of
the packed output words.  Every dispatcher takes the device as a keyword
(None: the card).

Scheduling semantics (the contract tests pin):

  * zero-delay passthrough — a request that finds its lane idle and
    empty dispatches immediately; an unloaded sidecar adds no latency.
  * while a dispatch is in flight, arrivals queue on the lane; the next
    leader drains them as one batch (coalescing-by-backpressure — load
    creates batching, not a fixed delay).
  * when a leader finds >1 request already queued (a concurrent burst),
    it waits ``DPF_CUDA_BATCH_WINDOW_US`` (default 200) for the rest of
    the burst before collecting, up to ``DPF_CUDA_BATCH_MAX_KEYS``
    (default 1024) key-rows per dispatch.

The leader is one of the request threads itself (the sidecar is a
``ThreadingHTTPServer``; no extra dispatcher thread to configure or
leak).  A dispatch failure fans the exception back to every coalesced
request — each HTTP thread reports its own 400.

Load survival (the bounded-queue contract tests/test_load_survival.py
pins):

  * admission control — each lane's queue is bounded by a depth
    watermark (``DPF_CUDA_QUEUE_MAX_DEPTH``) and an age watermark
    (``DPF_CUDA_QUEUE_MAX_AGE_MS``, measured on the OLDEST queued
    request).  Arrivals past either watermark are shed with
    ``ShedError`` (HTTP 429) whose Retry-After derives from the lane's
    observed dispatch latency (EWMA), instead of queuing unboundedly
    into a timeout pileup.
  * deadlines — a request carrying ``work.deadline`` (absolute
    ``time.perf_counter`` seconds) is checked at queue admission and
    again when the leader collects its batch: doomed work is cancelled
    BEFORE it burns a device slot (``DeadlineError``, counted as
    ``expired_queue``).  Work whose deadline passes while its dispatch
    runs is counted separately (``expired_flight``) and its result
    discarded.
  * the per-request wait timeout is the ``DPF_CUDA_BATCH_TIMEOUT_S``
    knob — the last-resort backstop behind the deadline machinery, not
    a tuning surface.

Merged dispatches run through the plan cache (core/plans.py), always on
the PACKED route — the packed words are the kernels' native output, XOR
and slicing commute with the packing, and byte-per-bit responses are a
thin host-side unpack — so mixed-format requests share one plan.  A plan
copies its rows out under its own lock (``plans.run_points``) before a
coalesced batch's rows are sliced here.

The reference's mesh-native lanes (a coalesced batch sharded over the
chips) come with the port's multi-GPU slice (ROADMAP A.6): here a lane
dispatches on one device and ``mesh_shards`` in the stats is 0.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core import bitpack, knobs, plans
from ..obs import trace as obs_trace
from . import faults
from .errors import DeadlineError, ShedError


@dataclass
class PointsWork:
    """One pointwise request: K keys x Q queries (route "points" with a
    profile, or "dcf_points")."""

    route: str
    profile: str
    kb: object
    xs: np.ndarray  # uint64 [K, Q]
    # Absolute deadline (time.perf_counter seconds), None = unbounded.
    deadline: float | None = None
    # The request's RequestTrace (obs/trace.py), None when tracing is off.
    trace: object = None
    # Filled by the batcher:
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.xs.shape[0])

    @property
    def lane(self) -> tuple:
        return (self.route, self.profile, self.kb.log_n)


@dataclass
class IntervalWork:
    """One DCF interval request: K gates x Q queries; ``ik`` is the
    party's (upper, lower, const) triple."""

    ik: tuple
    xs: np.ndarray
    deadline: float | None = None
    trace: object = None
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.xs.shape[0])

    @property
    def lane(self) -> tuple:
        return ("dcf_interval", "fast", self.ik[0].log_n)


@dataclass
class HHWork:
    """One heavy-hitters round-evaluation request: K client level-keys x
    Q candidate prefixes (the /v1/hh/eval body).  The lane includes the
    LEVEL: concurrent rounds at the same level coalesce into one grouped
    dispatch (the level steers host-side query masking inside
    ``plans.run_hh_level``, so same-level batches share a plan)."""

    profile: str
    kb: object
    xs: np.ndarray  # uint64 [K, Q] — the candidate set tiled per key row
    level: int
    deadline: float | None = None
    trace: object = None
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.xs.shape[0])

    @property
    def lane(self) -> tuple:
        return ("hh_level", self.profile, self.kb.log_n, self.level)


@dataclass
class HHExtendWork:
    """One incremental descent round (/v1/hh/eval?session=...): advance
    the session's device-resident frontier (apps/hh_state.py) to the
    requested depth.  The lane keys on the SESSION ID: successive rounds
    of one descent are sequentially dependent (each consumes the device
    state — possibly donated — that its predecessor produced), so they
    serialize in arrival order within the lane; independent sessions
    ride separate lanes and never mix.  ``kb`` is the G-key
    LEVEL-(log_n - 1) batch (the session contract: the cached walk needs
    the full-value key; ``level`` still selects the depth)."""

    profile: str
    kb: object
    digest: str  # key-blob digest — session identity check
    sid: str
    values: np.ndarray  # uint64 [Q] raw shifted candidate values
    level: int
    cache: object  # hh_state.SessionCache (the serving registry)
    deadline: float | None = None
    trace: object = None
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.kb.k)

    @property
    def lane(self) -> tuple:
        return ("hh_extend", self.profile, self.kb.log_n, self.sid)


@dataclass
class GenWork:
    """One key-generation request: K alpha points -> K serialized key
    pairs (the /v1/gen, /v1/dcf_gen, and /v1/hh/gen bodies).  The lane
    is (route, key family, log_n): concurrent gen requests of one
    family coalesce into ONE device tower dispatch over the
    concatenated alpha batch — root seeds draw fresh OS entropy per
    dispatch, so coalescing never correlates two requests' keys beyond
    what one request's own batch already shares (nothing)."""

    kind: str  # compat | fast | dcf — the plan key's profile slot
    alphas: np.ndarray  # uint64 [K]
    log_n: int
    deadline: float | None = None
    trace: object = None
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.alphas.shape[0])

    @property
    def lane(self) -> tuple:
        return ("gen", self.kind, self.log_n)


@dataclass
class PirWork:
    """One PIR query request: K query keys against one registered
    database (the /v1/pir/query body).  The lane keys on the DB OBJECT
    (``id``), not just its name: concurrent queries against the same
    database generation coalesce into ONE selection-matrix scan — the
    whole-database scan is the dispatch cost, so coalesced queries ride
    it as extra rows of the parity products — while a re-registered
    database (same name, new rows) never coalesces with queries still holding the old
    generation (``dispatch_pir`` answers a batch from one entry; mixing
    generations would answer some queries from the wrong rows)."""

    db: object  # apps.pir_store.PirDB
    kb: object
    deadline: float | None = None
    trace: object = None
    queue_wait: float = 0.0
    dispatch_s: float = 0.0
    coalesced: int = 0

    @property
    def n_keys(self) -> int:
        return int(self.kb.k)

    @property
    def lane(self) -> tuple:
        # id() is safe as the generation token: every queued work holds
        # a reference to ITS entry, so two live generations can never
        # share an address.
        return ("pir", self.db.name, id(self.db), self.db.profile,
                self.db.log_n)


def _concat_key_batches(batches: list):
    """Concatenate same-class struct-of-arrays key batches on the key
    axis (field order: log_n, then the arrays — true of KeyBatch,
    KeyBatchFast, and DcfKeyBatch)."""
    import dataclasses

    first = batches[0]
    names = [
        f.name
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), np.ndarray)
    ]
    return type(first)(
        first.log_n,
        *(
            np.concatenate([getattr(b, n) for b in batches])
            for n in names
        ),
    )


def _merged_queries(items: list) -> np.ndarray:
    """Stack the items' query tensors into one zero-padded uint64
    [sum K, max Q] block (padded queries evaluate index 0 and are
    re-masked off by ``_slice_rows``) — the shared merge step of every
    lane dispatcher."""
    qm = max(int(it.xs.shape[1]) for it in items)
    xs = np.zeros((sum(it.n_keys for it in items), qm), np.uint64)
    off = 0
    for it in items:
        k, q = it.xs.shape
        xs[off : off + k, :q] = it.xs
        off += k
    return xs


def _slice_rows(words: np.ndarray, items: list) -> list[np.ndarray]:
    """Split a merged dispatch's packed words back into per-request rows,
    re-cut to each request's own Q (tail bits re-masked)."""
    out, off = [], 0
    for it in items:
        k, q = it.xs.shape
        rows = np.ascontiguousarray(
            words[off : off + k, : bitpack.packed_words(q)]
        )
        out.append(bitpack.mask_tail(rows, q))
        off += k
    return out


def dispatch_points(items: list[PointsWork], *, device=None) -> list[np.ndarray]:
    """Lane dispatcher for pointwise routes -> per-item packed words.
    A solo item keeps its own (possibly key-cached) batch so its
    device-resident operand caches survive across repeated requests."""
    faults.fire("dispatch.points")
    if len(items) == 1:
        it = items[0]
        return [plans.run_points(it.route, it.profile, it.kb, it.xs, device=device)]
    merged_kb = _concat_key_batches([it.kb for it in items])
    words = plans.run_points(
        items[0].route, items[0].profile, merged_kb, _merged_queries(items),
        device=device,
    )
    return _slice_rows(words, items)


def dispatch_hh(items: list[HHWork], *, device=None) -> list[np.ndarray]:
    """Lane dispatcher for the heavy-hitters round route -> per-item
    packed share words (one plan-cached grouped dispatch per coalesced
    batch; same level by lane construction)."""
    faults.fire("dispatch.hh")
    if len(items) == 1:
        it = items[0]
        return [plans.run_hh_level(it.profile, it.kb, it.xs, it.level, device=device)]
    merged_kb = _concat_key_batches([it.kb for it in items])
    words = plans.run_hh_level(
        items[0].profile, merged_kb, _merged_queries(items), items[0].level,
        device=device,
    )
    return _slice_rows(words, items)


def dispatch_hh_extend(items: list[HHExtendWork], *, device=None) -> list[np.ndarray]:
    """Lane dispatcher for incremental descent rounds -> per-item packed
    share rows.  No cross-item merging: the lane holds successive rounds
    of ONE session, each consuming the frontier its predecessor left on
    device — they run strictly in arrival order."""
    faults.fire("dispatch.hh_extend")
    from ..apps import hh_state

    return [
        hh_state.serve_extend(
            it.cache, it.sid, it.profile, it.kb, it.digest, it.values,
            it.level, device=device,
        )
        for it in items
    ]


def _gen_call(kind: str, alphas: np.ndarray, log_n: int, device=None):
    """One gen dispatch for a key family -> (batch_a, batch_b); root
    seeds draw OS entropy (``rng=None``), the tower runs on ``device``
    through core/plans.run_gen (the card's dealer; ``"cpu"``: the host
    tower)."""
    if kind == "dcf":
        from ..models import dcf

        return dcf.gen_lt_batch(alphas, log_n, device=device)
    if kind == "fast":
        from ..core.keys_chacha import gen_batch
    else:
        from ..core.keys import gen_batch
    return gen_batch(alphas, log_n, device=device)


def _slice_key_batch(b, off: int, k: int):
    """Row-slice a struct-of-arrays key batch (inverse of
    ``_concat_key_batches``; views are fine — serialization copies)."""
    import dataclasses

    return type(b)(
        b.log_n,
        *(
            getattr(b, f.name)[off : off + k]
            for f in dataclasses.fields(b)
            if isinstance(getattr(b, f.name), np.ndarray)
        ),
    )


def dispatch_gen(items: list[GenWork], *, device=None) -> list[tuple]:
    """Lane dispatcher for the gen routes -> per-item (batch_a, batch_b)
    key-pair batches.  A coalesced batch towers ONCE over the
    concatenated alphas and each request slices its key rows back."""
    faults.fire("dispatch.gen")
    if len(items) == 1:
        it = items[0]
        return [_gen_call(it.kind, it.alphas, it.log_n, device)]
    alphas = np.concatenate([it.alphas for it in items])
    ka, kb = _gen_call(items[0].kind, alphas, items[0].log_n, device)
    out, off = [], 0
    for it in items:
        out.append(
            (
                _slice_key_batch(ka, off, it.n_keys),
                _slice_key_batch(kb, off, it.n_keys),
            )
        )
        off += it.n_keys
    return out


def dispatch_pir(items: list[PirWork], *, device=None) -> list[np.ndarray]:
    """Lane dispatcher for the PIR query route -> per-item answer rows
    uint8[K_i, row_bytes].  One coalesced batch is ONE plan-cached scan
    of the resident database (same DB by lane construction)."""
    faults.fire("dispatch.pir")
    if len(items) == 1:
        it = items[0]
        return [plans.run_pir(it.db, it.kb, device=device)]
    merged_kb = _concat_key_batches([it.kb for it in items])
    rows = plans.run_pir(items[0].db, merged_kb, device=device)
    out, off = [], 0
    for it in items:
        out.append(np.ascontiguousarray(rows[off : off + it.n_keys]))
        off += it.n_keys
    return out


def dispatch_interval(items: list[IntervalWork], *, device=None) -> list[np.ndarray]:
    """Lane dispatcher for the DCF interval route."""
    faults.fire("dispatch.interval")
    if len(items) == 1:
        it = items[0]
        return [plans.run_interval(it.ik, it.xs, device=device)]
    upper = _concat_key_batches([it.ik[0] for it in items])
    lower = _concat_key_batches([it.ik[1] for it in items])
    const = np.concatenate(
        [np.asarray(it.ik[2], np.uint8) for it in items]
    )
    words = plans.run_interval((upper, lower, const), _merged_queries(items),
                               device=device)
    return _slice_rows(words, items)


class _Req:
    __slots__ = ("work", "t0", "done", "result", "error", "lead")

    def __init__(self, work):
        self.work = work
        self.t0 = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.error = None
        # Leadership hand-off flag: a retiring leader wakes this request
        # (done.set with no result) to make its thread the next leader.
        self.lead = False


@dataclass
class BatcherStats:
    requests: int = 0
    dispatches: int = 0
    keys_dispatched: int = 0
    coalesced_max: int = 0
    dispatch_seconds: float = 0.0
    queue_wait_seconds: float = 0.0
    # Load survival: shed / expired accounting (requests counts ADMITTED
    # work only — shed and admission-expired arrivals never queue).
    shed_depth: int = 0  # refused: lane queue past the depth watermark
    shed_age: int = 0  # refused: oldest queued request past the age mark
    expired_queue: int = 0  # deadline passed before the dispatch started
    expired_flight: int = 0  # deadline passed while the dispatch ran
    dispatch_ewma_s: float = 0.0  # smoothed dispatch latency (Retry-After)
    queue_wait_max_s: float = 0.0  # worst admitted in-queue wait observed
    recent: deque = field(default_factory=lambda: deque(maxlen=512))

    def as_dict(self) -> dict:
        d = self.dispatches or 1
        return {
            "requests": self.requests,
            "dispatches": self.dispatches,
            "keys_dispatched": self.keys_dispatched,
            # keys per dispatch actually achieved.
            "batch_coalesced_mean": round(self.keys_dispatched / d, 3),
            "batch_coalesced_max": self.coalesced_max,
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "queue_wait_seconds": round(self.queue_wait_seconds, 6),
            "shed_depth": self.shed_depth,
            "shed_age": self.shed_age,
            "expired_queue": self.expired_queue,
            "expired_flight": self.expired_flight,
            "dispatch_ewma_ms": round(self.dispatch_ewma_s * 1e3, 3),
            "queue_wait_max_ms": round(self.queue_wait_max_s * 1e3, 3),
        }


class Batcher:
    """Per-lane request coalescer (see module docstring for semantics)."""

    def __init__(
        self, window_us: float | None = None, max_keys: int | None = None,
        timeout_s: float | None = None, max_depth: int | None = None,
        max_age_ms: float | None = None, lock=None, metrics=None,
    ):
        if window_us is None:
            window_us = knobs.get_float("DPF_CUDA_BATCH_WINDOW_US")
        if max_keys is None:
            max_keys = knobs.get_int("DPF_CUDA_BATCH_MAX_KEYS")
        if timeout_s is None:
            timeout_s = knobs.get_float("DPF_CUDA_BATCH_TIMEOUT_S")
        if max_depth is None:
            max_depth = knobs.get_int("DPF_CUDA_QUEUE_MAX_DEPTH")
        if max_age_ms is None:
            max_age_ms = knobs.get_float("DPF_CUDA_QUEUE_MAX_AGE_MS")
        self.window_s = max(window_us, 0.0) / 1e6
        self.max_keys = max(max_keys, 1)
        self.timeout_s = timeout_s
        self.max_depth = max(int(max_depth), 1)
        self.max_age_s = max(float(max_age_ms), 0.0) / 1e3
        # ``lock`` lets the serving state share ONE stats lock across the
        # batcher, breaker, key cache, phase timers, and metrics hub so
        # /v1/stats + /v1/metrics snapshots are consistent across all of
        # them (must then be an RLock); standalone batchers get their own.
        self._lock = lock if lock is not None else threading.Lock()
        # Metrics hub (obs/metrics.py) for the coalesce-size histogram.
        self._metrics = metrics
        self._pending: dict[tuple, deque] = {}
        self._busy: set = set()
        self.stats = BatcherStats()

    def stats_dict(self) -> dict:
        """Consistent stats snapshot (taken under the batcher lock —
        leaders mutate the counters concurrently).  Includes the live
        ``queue_depth`` gauge across lanes and the serving-mesh shard count
        (0: one device, until the port's multi-GPU slice)."""
        with self._lock:
            out = self.stats.as_dict()
            out["queue_depth"] = sum(
                len(q) for q in self._pending.values()
            )
        out["mesh_shards"] = 0
        return out

    def _retry_after_locked(self, depth: int) -> float:
        """Retry-After for a shed reply, derived from the observed
        dispatch latency: roughly how long until the lane has drained
        what is queued ahead (EWMA dispatch seconds x queued depth,
        clamped to a sane wire range)."""
        ewma = self.stats.dispatch_ewma_s or 0.05
        return min(max(ewma * max(depth, 1), 0.05), 10.0)

    def reset_peak(self) -> None:
        """Zero the peak queue-wait watermark (``queue_wait_max_ms``) so
        a measurement section can attribute the peak to ITS load run —
        the bench overload section resets between the 1x/4x/16x rows
        (counters and EWMA deliberately persist; only the peak is
        per-window)."""
        with self._lock:
            self.stats.queue_wait_max_s = 0.0

    def note_expired(self, where: str) -> None:
        """Deadline-expiry accounting for work that never entered a lane
        queue (the server's passthrough/evalfull paths share the
        batcher's /v1/stats counters)."""
        with self._lock:
            if where == "flight":
                self.stats.expired_flight += 1
            else:
                self.stats.expired_queue += 1

    def submit(self, work, dispatch):
        """Enqueue ``work`` on its lane and return its result (blocking).
        ``dispatch`` is the lane's batch function: list[work] -> list of
        per-work results, index-aligned.  Raises ``ShedError`` when the
        lane is past a watermark and ``DeadlineError`` when the work's
        deadline expires before (or during) its dispatch."""
        now = time.perf_counter()
        deadline = getattr(work, "deadline", None)
        if deadline is not None and now >= deadline:
            self.note_expired("queue")
            raise DeadlineError(
                "deadline expired before admission", where="queue"
            )
        req = _Req(work)
        with self._lock:
            q = self._pending.setdefault(work.lane, deque())
            depth = len(q)
            if depth >= self.max_depth:
                self.stats.shed_depth += 1
                raise ShedError(
                    f"lane queue full (depth {depth} >= watermark "
                    f"{self.max_depth})",
                    retry_after_s=self._retry_after_locked(depth),
                )
            if q and self.max_age_s and (
                now - q[0].t0 > self.max_age_s
            ):
                self.stats.shed_age += 1
                raise ShedError(
                    "lane backed up (oldest queued request past the "
                    f"{self.max_age_s * 1e3:.0f} ms age watermark)",
                    retry_after_s=self._retry_after_locked(depth),
                )
            self.stats.requests += 1
            q.append(req)
            leader = work.lane not in self._busy
            if leader:
                self._busy.add(work.lane)
        if leader:
            self._drain(work.lane, dispatch, req)
        while True:
            if not req.done.wait(self.timeout_s):
                with self._lock:
                    if not req.done.is_set():
                        # Still genuinely pending (under the lock, so a
                        # retiring leader cannot be handing us the lane
                        # concurrently): dequeue so no leader can pick an
                        # abandoned request, then fail.
                        try:
                            self._pending[work.lane].remove(req)
                        except ValueError:
                            pass
                        raise RuntimeError("batcher: dispatch timed out")
                # done was set in the race window (a result arrived or
                # leadership was handed over): fall through and let the
                # next loop iteration classify it.
                continue
            with self._lock:
                if not (req.lead and req.result is None
                        and req.error is None):
                    break
                # A retiring leader woke us to take over the lane.
                req.lead = False
                req.done.clear()
            self._drain(work.lane, dispatch, req)
        if req.error is not None:
            raise req.error
        return req.result

    def _drain(self, lane, dispatch, my_req=None) -> None:
        try:
            while True:
                with self._lock:
                    q = self._pending[lane]
                    if not q:
                        # Atomic empty-check + release: a submit racing in
                        # after this sees the lane idle and leads itself.
                        self._busy.discard(lane)
                        return
                    if my_req is not None and my_req.done.is_set():
                        # The leader's own answer is ready but sustained
                        # traffic keeps the lane non-empty: hand the lane
                        # to a queued request's thread (it wakes, sees
                        # lead set, and drains) so the leader can return
                        # its OWN response instead of being captured
                        # indefinitely.  _busy stays set across the
                        # hand-off — no third thread self-elects.
                        nxt = q[0]
                        nxt.lead = True
                        nxt.done.set()
                        return
                    depth = len(q)
                if depth > 1 and self.window_s > 0:
                    # A concurrent burst is mid-arrival: give the rest of
                    # it the window.  depth == 1 passes through with zero
                    # added latency.
                    time.sleep(self.window_s)
                with self._lock:
                    take, nk = [], 0
                    while q and (
                        not take or nk + q[0].work.n_keys <= self.max_keys
                    ):
                        r = q.popleft()
                        take.append(r)
                        nk += r.work.n_keys
                t0 = time.perf_counter()
                # Post-coalesce / pre-dispatch deadline check: work that
                # expired while queued is cancelled HERE, before it burns
                # a device slot, and fails alone — the rest of the batch
                # dispatches without it.
                live = []
                expired = []
                for r in take:
                    d = getattr(r.work, "deadline", None)
                    if d is not None and t0 >= d:
                        r.error = DeadlineError(
                            "deadline expired in queue", where="queue"
                        )
                        expired.append(r)
                    else:
                        live.append(r)
                        r.work.queue_wait = t0 - r.t0
                if expired:
                    with self._lock:
                        self.stats.expired_queue += len(expired)
                    for r in expired:
                        r.done.set()
                if not live:
                    continue
                nk = sum(r.work.n_keys for r in live)
                # Tracing: each batch-mate's tree gets its own queue_wait
                # + coalesce spans (with the OTHER mates' trace ids), and
                # every tree adopts the SAME dispatch span object below —
                # the shared span_id is how /v1/trace shows one slow
                # device dispatch across all the requests that rode it.
                traced = [
                    r for r in live
                    if getattr(r.work, "trace", None) is not None
                ]
                dspan = None
                if traced:
                    mates = [r.work.trace.trace_id for r in traced]
                    for r in traced:
                        tr = r.work.trace
                        tr.add_span(
                            "queue_wait", t0=r.t0, dur_s=r.work.queue_wait
                        )
                        tr.add_span(
                            "coalesce", t0=t0, dur_s=0.0, coalesced=nk,
                            batch_mates=[
                                m for m in mates if m != tr.trace_id
                            ],
                        )
                    dspan = obs_trace.Span("dispatch")
                try:
                    with obs_trace.dispatch_scope(dspan):
                        results = dispatch([r.work for r in live])
                    for r, res in zip(live, results):
                        r.result = res
                except Exception as e:  # noqa: BLE001 — fan out per request
                    for r in live:
                        r.error = e
                    if dspan is not None:
                        dspan.set_attrs(error=type(e).__name__)
                dt = time.perf_counter() - t0
                if dspan is not None:
                    dspan.end()
                    dspan.set_attrs(coalesced=nk)
                    for r in traced:
                        r.work.trace.attach(dspan)
                t1 = time.perf_counter()
                # Expired-in-flight: the dispatch outlived the deadline —
                # the work already burned its device slot, so it is
                # counted separately and its result discarded.
                n_flight = 0
                for r in live:
                    d = getattr(r.work, "deadline", None)
                    if r.error is None and d is not None and t1 >= d:
                        r.result = None
                        r.error = DeadlineError(
                            "deadline expired in flight", where="flight"
                        )
                        n_flight += 1
                with self._lock:
                    self.stats.dispatches += 1
                    self.stats.keys_dispatched += nk
                    self.stats.coalesced_max = max(
                        self.stats.coalesced_max, nk
                    )
                    self.stats.dispatch_seconds += dt
                    self.stats.dispatch_ewma_s = (
                        dt if not self.stats.dispatch_ewma_s
                        else 0.2 * dt + 0.8 * self.stats.dispatch_ewma_s
                    )
                    self.stats.expired_flight += n_flight
                    self.stats.queue_wait_seconds += sum(
                        r.work.queue_wait for r in live
                    )
                    self.stats.queue_wait_max_s = max(
                        self.stats.queue_wait_max_s,
                        max(r.work.queue_wait for r in live),
                    )
                    self.stats.recent.append(nk)
                    if self._metrics is not None:
                        self._metrics.observe_coalesce(nk)
                for r in live:
                    r.work.dispatch_s = dt
                    r.work.coalesced = nk
                    r.done.set()
        except BaseException:
            # Machinery failure (not a dispatch error — those are caught
            # above): fail everything queued rather than hang it.
            with self._lock:
                q = self._pending.get(lane)
                while q:
                    r = q.popleft()
                    r.error = RuntimeError("batcher: leader failed")
                    r.done.set()
                self._busy.discard(lane)
            raise
