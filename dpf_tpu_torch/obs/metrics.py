"""Prometheus text-format exposition for the sidecar (``GET /v1/metrics``).

The port's counterpart of ``dpf_tpu/obs/metrics.py``: the same families,
names, labels and rendering.  Only the device memory gauges differ: they
come from ``torch.cuda.memory_stats`` / ``torch.cuda.mem_get_info`` of the
card the sidecar serves on (``cuda:0``), and, as in the JAX package, there
are none on the CPU.

Design rule: every counter and gauge here is rendered FROM the single
consistent ``/v1/stats`` snapshot (one stats lock, server.py) — the two
surfaces read the same dict, so they cannot drift; the test suite pins
exact equality.  The only state this module owns is what Prometheus
needs and a JSON blob cannot carry: fixed-bucket histograms for
per-phase latency and coalesce size (``MetricsHub``), observed at the
same instrumentation points that feed the phase timers.

Exposition follows the Prometheus text format v0.0.4: ``# HELP`` /
``# TYPE`` per family, counters suffixed ``_total``, histograms with
cumulative ``_bucket{le=...}`` series, an ``le="+Inf"`` bucket equal to
``_count``, and a terminating newline.  ``obs/promtext.py`` is the
strict parser the tests and ``chip_smoke.py`` hold this output against.

Metric labels are exported verbatim, so — like span attributes — label
values are secret-hygiene taint sinks: public metadata only.
"""

from __future__ import annotations

import bisect
import threading

from ..core import knobs

_NAMESPACE = "dpf"

# Coalesce-size buckets: key-rows per dispatch, powers of two up to the
# batcher's DPF_CUDA_BATCH_MAX_KEYS default.
_COALESCE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


def latency_bounds_s() -> tuple[float, ...]:
    """Histogram bucket bounds for per-phase latency, in seconds, parsed
    from the DPF_CUDA_METRICS_BUCKETS_MS knob (comma-separated ms)."""
    raw = knobs.get_str("DPF_CUDA_METRICS_BUCKETS_MS")
    # Deduplicated: a repeated bound would render two bucket samples
    # with the same le label, which every strict consumer rejects.
    bounds = sorted(
        {float(tok) / 1e3 for tok in raw.split(",") if tok.strip()}
    )
    if not bounds:
        raise ValueError("DPF_CUDA_METRICS_BUCKETS_MS must name >= 1 bucket")
    return tuple(bounds)


class Histogram:
    """Fixed-bucket histogram; ``counts[i]`` is the NON-cumulative count
    of observations v with bounds[i-1] < v <= bounds[i] (counts[-1] is
    the overflow / +Inf bucket).  Rendering cumulates."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def as_dict(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


class MetricsHub:
    """The histogram state behind /v1/metrics.  ``lock`` is the serving
    state's single stats lock (an RLock) so histogram snapshots are
    taken in the same critical section as the counter snapshot."""

    def __init__(self, lock=None, bounds_s: tuple[float, ...] | None = None):
        self._lock = lock if lock is not None else threading.RLock()
        self._bounds = bounds_s if bounds_s is not None else latency_bounds_s()
        self._phase: dict[str, Histogram] = {}
        self._coalesce = Histogram(_COALESCE_BOUNDS)

    def observe_phase(self, name: str, dt_s: float) -> None:
        with self._lock:
            h = self._phase.get(name)
            if h is None:
                h = self._phase[name] = Histogram(self._bounds)
            h.observe(dt_s)

    def observe_coalesce(self, n_keys: int) -> None:
        with self._lock:
            self._coalesce.observe(n_keys)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "phase_latency": {
                    name: h.as_dict() for name, h in self._phase.items()
                },
                "coalesce_size": self._coalesce.as_dict(),
            }


def device_memory_gauges(device=None) -> list[tuple[str, str, str, float]]:
    """(device, stat, mesh_coord, value) tuples of the card's memory:
    ``bytes_in_use`` and ``peak_bytes_in_use`` from the caching allocator
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
    ``.peak``) and ``bytes_limit`` (the card's total memory,
    ``torch.cuda.mem_get_info``).  ``device`` is the sidecar's device
    (None: ``cuda:0`` when CUDA is up); a CPU device has none (an empty
    list, as the JAX package has on the CPU).  ``mesh_coord`` is "off":
    the port has no serving mesh yet.  Never raises: metrics exposition
    must not depend on device health."""
    out: list[tuple[str, str, str, float]] = []
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return out
            device = "cuda:0"
        dev = torch.device(device)
        if dev.type != "cuda":
            return out
        idx = 0 if dev.index is None else dev.index
        ms = torch.cuda.memory_stats(idx)
        _, total = torch.cuda.mem_get_info(idx)
        label = f"gpu:{idx}"
        out.append((label, "bytes_in_use", "off",
                    float(ms.get("allocated_bytes.all.current", 0))))
        out.append((label, "peak_bytes_in_use", "off",
                    float(ms.get("allocated_bytes.all.peak", 0))))
        out.append((label, "bytes_limit", "off", float(total)))
    except Exception:  # noqa: BLE001 — observability must not take traffic down
        return []
    return out


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Writer:
    def __init__(self):
        self.lines: list[str] = []

    def family(self, name: str, kind: str, help_text: str) -> None:
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, labels: dict | None, value) -> None:
        if labels:
            body = ",".join(
                f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
            )
            self.lines.append(f"{name}{{{body}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def histogram(self, name: str, labels: dict | None, h: dict) -> None:
        cum = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            lb = dict(labels or {})
            lb["le"] = _fmt(bound)
            self.sample(f"{name}_bucket", lb, cum)
        lb = dict(labels or {})
        lb["le"] = "+Inf"
        self.sample(f"{name}_bucket", lb, h["count"])
        self.sample(f"{name}_sum", labels, h["sum"])
        self.sample(f"{name}_count", labels, h["count"])

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def render(stats: dict, hists: dict,
           device_mem: list[tuple[str, str, str, float]] | None = None,
           ) -> str:
    """The /v1/metrics body: ``stats`` is the /v1/stats snapshot (the
    SAME dict — counter equality between the two surfaces is structural,
    not coincidental), ``hists`` is ``MetricsHub.snapshot()``;
    ``device_mem`` the card's memory gauges (None: read ``cuda:0``'s)."""
    w = _Writer()
    ns = _NAMESPACE
    b = stats["batcher"]
    br = stats["breaker"]
    pl = stats["plans"]
    kc = stats["key_cache"]
    tr = stats.get("trace", {})

    # -- counters ----------------------------------------------------------
    w.family(f"{ns}_requests_total", "counter",
             "Requests admitted to the serving fast path.")
    w.sample(f"{ns}_requests_total", None, b["requests"])
    w.family(f"{ns}_dispatches_total", "counter",
             "Device dispatches issued (coalesced batches count once).")
    w.sample(f"{ns}_dispatches_total", None, b["dispatches"])
    w.family(f"{ns}_keys_dispatched_total", "counter",
             "Key-rows dispatched across all batches.")
    w.sample(f"{ns}_keys_dispatched_total", None, b["keys_dispatched"])
    w.family(f"{ns}_shed_total", "counter",
             "Requests shed by admission control, by watermark kind.")
    w.sample(f"{ns}_shed_total", {"kind": "depth"}, b["shed_depth"])
    w.sample(f"{ns}_shed_total", {"kind": "age"}, b["shed_age"])
    w.family(f"{ns}_expired_total", "counter",
             "Deadline expirations, by where the deadline passed.")
    w.sample(f"{ns}_expired_total", {"where": "queue"}, b["expired_queue"])
    w.sample(f"{ns}_expired_total", {"where": "flight"}, b["expired_flight"])
    w.family(f"{ns}_queue_wait_seconds_total", "counter",
             "Cumulative in-queue wait across admitted requests.")
    w.sample(f"{ns}_queue_wait_seconds_total", None,
             b["queue_wait_seconds"])
    w.family(f"{ns}_dispatch_seconds_total", "counter",
             "Cumulative wall seconds inside device dispatches.")
    w.sample(f"{ns}_dispatch_seconds_total", None, b["dispatch_seconds"])

    w.family(f"{ns}_breaker_transitions_total", "counter",
             "Circuit-breaker transitions, by kind (trip = -> open, "
             "recovery = -> closed).")
    w.sample(f"{ns}_breaker_transitions_total", {"kind": "trip"},
             br["trips"])
    w.sample(f"{ns}_breaker_transitions_total", {"kind": "recovery"},
             br["recoveries"])
    w.family(f"{ns}_breaker_fast_fails_total", "counter",
             "Requests failed fast while the circuit was open/half-open.")
    w.sample(f"{ns}_breaker_fast_fails_total", None, br["fast_fails"])
    w.family(f"{ns}_breaker_retries_total", "counter",
             "Transparent transient-dispatch retries.")
    w.sample(f"{ns}_breaker_retries_total", None, br["retries"])
    w.family(f"{ns}_breaker_transient_failures_total", "counter",
             "Dispatch failures classified transient (pre-retry).")
    w.sample(f"{ns}_breaker_transient_failures_total", None,
             br["transient_failures"])
    w.family(f"{ns}_breaker_probe_runs_total", "counter",
             "Background re-warm probe executions while open.")
    w.sample(f"{ns}_breaker_probe_runs_total", None, br["probe_runs"])

    w.family(f"{ns}_plan_hits_total", "counter",
             "Dispatch-plan cache hits.")
    w.sample(f"{ns}_plan_hits_total", None, pl["hits"])
    w.family(f"{ns}_plan_compiles_total", "counter",
             "Dispatch-plan compiles (cache misses).")
    w.sample(f"{ns}_plan_compiles_total", None, pl["misses"])

    w.family(f"{ns}_keycache_hits_total", "counter",
             "Host-repack LRU hits.")
    w.sample(f"{ns}_keycache_hits_total", None, kc["hits"])
    w.family(f"{ns}_keycache_misses_total", "counter",
             "Host-repack LRU misses.")
    w.sample(f"{ns}_keycache_misses_total", None, kc["misses"])

    pir = stats.get("pir")
    if pir is not None:
        w.family(f"{ns}_pir_queries_total", "counter",
                 "PIR queries answered across registered databases.")
        w.sample(f"{ns}_pir_queries_total", None, pir["queries"])
        w.family(f"{ns}_pir_scans_total", "counter",
                 "Full-database PIR scan dispatches (coalesced query "
                 "batches count once).")
        w.sample(f"{ns}_pir_scans_total", None, pir["scans"])
        w.family(f"{ns}_pir_bytes_scanned_total", "counter",
                 "Database bytes read by PIR scans (padded resident "
                 "bytes per scan).")
        w.sample(f"{ns}_pir_bytes_scanned_total", None,
                 pir["bytes_scanned"])

    hhs = stats.get("hh_state")
    if hhs is not None:
        w.family(f"{ns}_hh_session_hits_total", "counter",
                 "Incremental heavy-hitters rounds served from a cached "
                 "device frontier.")
        w.sample(f"{ns}_hh_session_hits_total", None, hhs["hits"])
        w.family(f"{ns}_hh_session_misses_total", "counter",
                 "Descent rounds that found no (or a mismatched) cached "
                 "session and built a fresh frontier.")
        w.sample(f"{ns}_hh_session_misses_total", None, hhs["misses"])
        w.family(f"{ns}_hh_session_rebuilds_total", "counter",
                 "Stale cached frontiers replanted at the root and "
                 "replayed (byte-identical from-root recompute).")
        w.sample(f"{ns}_hh_session_rebuilds_total", None, hhs["rebuilds"])
        w.family(f"{ns}_hh_session_evictions_total", "counter",
                 "Descent sessions evicted (TTL, LRU budget, digest "
                 "mismatch, or poisoned state).")
        w.sample(f"{ns}_hh_session_evictions_total", None, hhs["evicted"])

    phases = stats.get("phases", {})
    w.family(f"{ns}_phase_seconds_total", "counter",
             "Cumulative wall seconds per request phase.")
    for name in sorted(phases):
        w.sample(f"{ns}_phase_seconds_total", {"phase": name},
                 phases[name]["seconds"])
    w.family(f"{ns}_phase_events_total", "counter",
             "Events recorded per request phase.")
    for name in sorted(phases):
        w.sample(f"{ns}_phase_events_total", {"phase": name},
                 phases[name]["count"])

    if tr:
        w.family(f"{ns}_traces_recorded_total", "counter",
                 "Traces recorded into the flight-recorder ring.")
        w.sample(f"{ns}_traces_recorded_total", None, tr["recorded"])
        w.family(f"{ns}_traces_evicted_total", "counter",
                 "Traces aged out of the flight-recorder ring.")
        w.sample(f"{ns}_traces_evicted_total", None, tr["evicted"])

    # -- gauges ------------------------------------------------------------
    w.family(f"{ns}_queue_depth", "gauge",
             "Requests currently queued across batcher lanes.")
    w.sample(f"{ns}_queue_depth", None, b.get("queue_depth", 0))
    w.family(f"{ns}_queue_wait_max_seconds", "gauge",
             "Worst admitted in-queue wait since the last reset_peak.")
    w.sample(f"{ns}_queue_wait_max_seconds", None,
             b["queue_wait_max_ms"] / 1e3)
    w.family(f"{ns}_breaker_state", "gauge",
             "Circuit-breaker state: 0 closed, 1 half_open, 2 open.")
    w.sample(f"{ns}_breaker_state", None,
             _BREAKER_STATE_CODE.get(br["state"], -1))
    w.family(f"{ns}_plan_cache_plans", "gauge",
             "Distinct dispatch plans in the cache.")
    w.sample(f"{ns}_plan_cache_plans", None, len(pl["plans"]))
    w.family(f"{ns}_keycache_entries", "gauge",
             "Key batches resident in the host-repack LRU.")
    w.sample(f"{ns}_keycache_entries", None, kc["entries"])
    if hhs is not None:
        w.family(f"{ns}_hh_sessions", "gauge",
                 "Descent sessions with a device-resident frontier.")
        w.sample(f"{ns}_hh_sessions", None, hhs["sessions"])
        w.family(f"{ns}_hh_session_bytes", "gauge",
                 "Device bytes held by cached descent frontiers.")
        w.sample(f"{ns}_hh_session_bytes", None, hhs["bytes"])
    if tr:
        w.family(f"{ns}_trace_ring_size", "gauge",
                 "Traces currently held by the flight recorder.")
        w.sample(f"{ns}_trace_ring_size", None, tr["size"])

    w.family(f"{ns}_mesh_shards", "gauge",
             "Serving-mesh shard count (0 = single-device serving): how "
             "many chips a coalesced dispatch partitions over.")
    w.sample(f"{ns}_mesh_shards", None,
             stats.get("mesh", {}).get("shards", 0))

    if pir is not None:
        w.family(f"{ns}_pir_dbs_resident", "gauge",
                 "PIR databases resident in device HBM.")
        w.sample(f"{ns}_pir_dbs_resident", None, pir["dbs_resident"])
        w.family(f"{ns}_pir_db_bytes_resident", "gauge",
                 "Padded database bytes resident across PIR databases.")
        w.sample(f"{ns}_pir_db_bytes_resident", None,
                 pir["db_bytes_resident"])

    tuned = stats.get("tuned")
    if tuned is not None:
        w.family(f"{ns}_tuned_configs", "gauge",
                 "Tuned per-plan configs loaded (0: the port has no tuned "
                 "table yet).")
        w.sample(f"{ns}_tuned_configs", None, tuned["entries"])
        w.family(f"{ns}_tuned_plans", "gauge",
                 "Dispatch plans in the cache compiled under a tuned "
                 "config — which plans actually run tuned right now.")
        w.sample(f"{ns}_tuned_plans", None, pl.get("tuned_plans", 0))

    mem = device_memory_gauges() if device_mem is None else device_mem
    if mem:
        w.family(f"{ns}_device_memory_bytes", "gauge",
                 "Per-device memory from torch.cuda.memory_stats and "
                 "mem_get_info, labeled by serving-mesh coordinate "
                 "(mesh=off: the port serves one card).")
        for device, stat, coord, value in mem:
            w.sample(f"{ns}_device_memory_bytes",
                     {"device": device, "stat": stat, "mesh": coord},
                     value)

    # -- histograms --------------------------------------------------------
    phase_hists = hists.get("phase_latency", {})
    if phase_hists:
        w.family(f"{ns}_phase_latency_seconds", "histogram",
                 "Per-event phase latency (fixed buckets, "
                 "DPF_CUDA_METRICS_BUCKETS_MS).")
        for name in sorted(phase_hists):
            w.histogram(f"{ns}_phase_latency_seconds", {"phase": name},
                        phase_hists[name])
    w.family(f"{ns}_coalesce_size", "histogram",
             "Key-rows coalesced per device dispatch.")
    w.histogram(f"{ns}_coalesce_size", None, hists["coalesce_size"])
    if pir is not None:
        w.family(f"{ns}_pir_scan_chunks", "histogram",
                 "Streamed chunk dispatches per PIR scan (1 = one-shot "
                 "scan; more = database past DPF_CUDA_PIR_DB_CHUNK_BYTES).")
        w.histogram(f"{ns}_pir_scan_chunks", None, pir["scan_chunks"])

    return w.text()
