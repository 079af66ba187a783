"""The port's observability and contract surface against the JAX package's:
the copies of ``promtext``, ``trace``, ``errors``, ``headers`` and
``faults`` give the originals' outputs on the same inputs, the metrics
renderer the same text from the same snapshot, ``/v1/metrics`` parses
strictly and equals ``/v1/stats``, and the route table, error codes,
headers, HTTP-only routes and metric names equal ``docs/CONTRACT.json``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.core import knobs as ref_knobs  # noqa: E402
from dpf_tpu.obs import metrics as ref_metrics  # noqa: E402
from dpf_tpu.obs import promtext as ref_promtext  # noqa: E402
from dpf_tpu.obs import trace as ref_trace  # noqa: E402
from dpf_tpu.serving import errors as ref_errors  # noqa: E402
from dpf_tpu.serving import faults as ref_faults  # noqa: E402
from dpf_tpu.serving import headers as ref_headers  # noqa: E402

from dpf_tpu_torch.core import chacha_np as cc  # noqa: E402
from dpf_tpu_torch.core import knobs  # noqa: E402
from dpf_tpu_torch.obs import metrics, promtext, trace  # noqa: E402
from dpf_tpu_torch.serving import errors, faults, handlers, headers  # noqa: E402

CONTRACT = json.loads((Path(__file__).resolve().parents[2] / "docs" / "CONTRACT.json")
                      .read_text())

# The sidecar's knobs: the port's DPF_CUDA_<name> keeps DPF_TPU_<name>'s default.
SERVING_KNOBS = (
    "BATCH", "BATCH_MAX_KEYS", "BATCH_TIMEOUT_S", "BATCH_WINDOW_US",
    "BREAKER_COOLDOWN_MS", "BREAKER_PROBE", "BREAKER_THRESHOLD",
    "DEADLINE_MS", "DISPATCH_RETRIES", "RETRY_BACKOFF_MS", "FAULTS", "FAULTS_ALLOW",
    "HH_STATE", "HH_STATE_MAX_SESSIONS", "HH_STATE_MAX_BYTES", "HH_STATE_TTL_S",
    "KEY_CACHE_ENTRIES", "METRICS_BUCKETS_MS", "PROFILE_ALLOW", "PROFILE_MAX_S",
    "QUEUE_MAX_AGE_MS", "QUEUE_MAX_DEPTH", "STREAM", "STREAM_MIN_BYTES",
    "TRACE", "TRACE_RING", "WIRE_FORMAT",
)


@pytest.mark.parametrize("name", SERVING_KNOBS)
def test_serving_knobs_keep_the_jax_defaults(name):
    ours, theirs = knobs.knob(f"DPF_CUDA_{name}"), ref_knobs.knob(f"DPF_TPU_{name}")
    assert (ours.default, ours.choices) == (theirs.default, theirs.choices)


# ---------------------------------------------------------------------------
# The copies against the originals
# ---------------------------------------------------------------------------


def test_errors_and_headers_copies():
    assert errors.CODES == ref_errors.CODES
    for name in ("ServingError", "ShedError", "OverloadedError", "DeadlineError"):
        ours, theirs = getattr(errors, name), getattr(ref_errors, name)
        assert (ours.code, ours.http_status) == (theirs.code, theirs.http_status)
    e = errors.DeadlineError("late", where="flight")
    assert (e.detail, e.where, e.retry_after_s) == ("late", "flight", None)
    for name in ("DEADLINE_HEADER", "TRACE_HEADER", "RETRY_AFTER_HEADER", "DEADLINE_PARAM",
                 "TRACE_PARAM"):
        assert getattr(headers, name) == getattr(ref_headers, name)


EXPOSITION = """# HELP a_total A.
# TYPE a_total counter
a_total{kind="x"} 3
a_total{kind="y\\"q"} 4.5
# HELP h A histogram.
# TYPE h histogram
h_bucket{le="1"} 1
h_bucket{le="+Inf"} 2
h_sum 3.5
h_count 2
# TYPE g gauge
g -1
"""
BAD_EXPOSITIONS = (
    "a_total 1\n",  # no TYPE
    "# TYPE a counter\na 1\n",  # a counter without _total
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 3\n",
    "# TYPE g gauge\ng 1",  # no final newline
    "# TYPE g gauge\ng 1\ng 2\n",  # duplicate sample
)


def _scrape(mod, text):
    s = mod.parse(text, strict=True)
    return s.types, s.help, s.samples


def test_promtext_copy_parses_as_the_original():
    assert _scrape(promtext, EXPOSITION) == _scrape(ref_promtext, EXPOSITION)
    for bad in BAD_EXPOSITIONS:
        with pytest.raises(ValueError) as ours:
            promtext.parse(bad, strict=True)
        with pytest.raises(ValueError) as theirs:
            ref_promtext.parse(bad, strict=True)
        assert str(ours.value) == str(theirs.value)


def _trace_shape(mod):
    tr = mod.Tracer(enabled=True, ring=2)
    out = []
    for tid, outcome in (("a-1", "ok"), (None, "shed"), ("bad id!", "ok"), ("c", "expired")):
        t = tr.begin(tid, "/v1/eval_points_batch")
        with mod.traced_dispatch(t) as sp:
            mod.add_event("plan_lookup", hit=True)
            with mod.child_span("compute"):
                pass
            sp.set_attrs(coalesced=3)
        t.add_span("queue_wait", t0=t.t0, dur_s=0.0)
        with mod.maybe_span(t, "reply"):
            pass
        tr.finish(t, outcome)
        out.append((sorted(t.span_names()), t.outcome, tid == t.trace_id))

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()
                    if k not in ("start_unix", "duration_ms", "start_ms", "dur_ms", "span_id",
                                 "trace_id")}
        if isinstance(d, list):
            return [strip(x) for x in d]
        return d

    q = [strip(t.as_dict()) for t in tr.recorder.query(n=8)]
    return out, q, tr.recorder.stats(), mod.OUTCOMES, mod.SPAN_NAMES


def test_trace_copy_records_as_the_original():
    assert _trace_shape(trace) == _trace_shape(ref_trace)


SPECS = (
    "dispatch.points:unavailable:times=3;dispatch.points:latency:ms=1:after=3",
    "reply.write:abort:after=1",
    "stream.chunk:error",
)
BAD_SPECS = ("nope:error", "dispatch.points:explode", "dispatch.points", "reply.write:error:x",
             "reply.write:error:every=2")


def _fire_all(mod, spec):
    plan = mod.FaultPlan(mod.parse_spec(spec))
    seen = []
    for site in ("dispatch.points", "reply.write", "stream.chunk") * 3:
        try:
            plan.fire(site)
            seen.append(None)
        except Exception as e:  # noqa: BLE001 — compared below
            seen.append((type(e).__name__, str(e)))
    return seen, plan.stats()


@pytest.mark.parametrize("spec", SPECS)
def test_faults_copy_fires_as_the_original(spec):
    assert faults.SITES == ref_faults.SITES and faults.KINDS == ref_faults.KINDS
    assert _fire_all(faults, spec) == _fire_all(ref_faults, spec)


def test_faults_copy_refuses_as_the_original():
    for bad in BAD_SPECS:
        with pytest.raises(ValueError) as ours:
            faults.parse_spec(bad)
        with pytest.raises(ValueError) as theirs:
            ref_faults.parse_spec(bad)
        assert str(ours.value) == str(theirs.value)
    ours, theirs = faults._refusal({}, False), ref_faults._refusal({}, False)
    assert ours == theirs.replace("DPF_TPU_", "DPF_CUDA_")
    assert faults._refusal({"pytest": 1}, False) is None


# ---------------------------------------------------------------------------
# /v1/metrics and /v1/stats of the port's sidecar
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """A port serving state on the CPU after a little traffic."""
    st = handlers._ServingState("cpu")
    rng = np.random.default_rng(9)
    ka, kb = cc.gen(5, 10, rng)
    xs = rng.integers(0, 1 << 10, size=(2, 8), dtype=np.uint64).astype("<u8").tobytes()
    params = {"log_n": "10", "k": "2", "q": "8", "profile": "fast"}
    for trace_id in ("m-1", "m-2"):
        req = handlers.Request("/v1/eval_points_batch", dict(params), body=ka + kb + xs,
                               trace_id=trace_id)
        rep = handlers.respond(req, st)
        assert rep.status == 200
        st.tracer.finish(rep.trace, rep.outcome)
    bad = handlers.respond(handlers.Request("/v1/evalfull", {"log_n": "10"}, body=b"x"), st)
    assert bad.status == 400
    rows = rng.integers(0, 1 << 32, size=(4, 3), dtype=np.uint64).astype("<u4").tobytes()
    import io

    req = handlers.Request("/v1/agg/submit", {"op": "xor", "k": "4", "words": "3"},
                           content_length=len(rows))
    req.body_reader = handlers.FileBodyReader(io.BytesIO(rows), len(rows))
    assert handlers.respond(req, st).status == 200
    return st


def test_metrics_parse_strictly_and_equal_stats(served):
    text = handlers.respond_get("/v1/metrics", {}, served).chunks[0].decode()
    stats = json.loads(handlers.respond_get("/v1/stats", {}, served).chunks[0])
    s = promtext.parse(text, strict=True)
    b = stats["batcher"]
    assert s.value("dpf_requests_total") == b["requests"] == 2
    assert s.value("dpf_dispatches_total") == b["dispatches"]
    assert s.value("dpf_keys_dispatched_total") == b["keys_dispatched"]
    assert s.value("dpf_plan_hits_total") == stats["plans"]["hits"]
    assert s.value("dpf_plan_compiles_total") == stats["plans"]["misses"]
    assert s.value("dpf_keycache_hits_total") == stats["key_cache"]["hits"] == 1
    assert s.value("dpf_breaker_state") == 0 and stats["breaker"]["state"] == "closed"
    assert s.value("dpf_mesh_shards") == stats["mesh"]["shards"] == 0
    assert s.value("dpf_tuned_configs") == stats["tuned"]["entries"] == 0
    assert s.value("dpf_traces_recorded_total") == stats["trace"]["recorded"]
    for phase, v in stats["phases"].items():
        assert s.value("dpf_phase_events_total", {"phase": phase}) == v["count"]
    assert stats["wire"] == {}  # the handler core alone: no front noted a body
    tr = json.loads(handlers.respond_get("/v1/trace", {"id": "m-2"}, served).chunks[0])
    names = set()
    stack = list(tr["traces"][0]["spans"])
    while stack:
        sp = stack.pop()
        names.add(sp["name"])
        stack.extend(sp.get("children", []))
    assert set(trace.SPAN_NAMES) - {"reply"} <= names


def test_metrics_render_as_the_original_from_one_snapshot(served):
    with served.stats_lock:
        snap = served.stats_snapshot()
        hists = served.metrics.snapshot()
    mem = [("gpu:0", "bytes_in_use", "off", 1.0)]

    def lines(text):
        # Four HELP lines name the port's own sources or knobs (DPF_CUDA_*);
        # every other line, in order, is the original's.
        return [ln for ln in text.splitlines() if not ln.startswith("# HELP")]

    ours = metrics.render(snap, hists, device_mem=mem)
    theirs = ref_metrics.render(snap, hists, device_mem=mem)
    assert lines(ours) == lines(theirs)
    differ = {a.split()[2] for a, b in zip(ours.splitlines(), theirs.splitlines()) if a != b}
    assert differ == {"dpf_tuned_configs", "dpf_device_memory_bytes",
                      "dpf_phase_latency_seconds", "dpf_pir_scan_chunks"}


# ---------------------------------------------------------------------------
# docs/CONTRACT.json
# ---------------------------------------------------------------------------


def test_route_table_equals_the_contract():
    routes = CONTRACT["routes"]
    assert handlers.ROUTE_IDS == {v["id"]: k for k, v in routes.items()}
    assert handlers.ROUTE_PATHS == {k: v["id"] for k, v in routes.items()}
    assert handlers.SINK_ROUTES == {k for k, v in routes.items() if v["sink"]}
    assert handlers.HTTP_ONLY_ROUTES == set(CONTRACT["http_only_routes"])


def test_errors_and_headers_equal_the_contract():
    assert errors.CODES == CONTRACT["error_codes"]
    assert {name: getattr(errors, name).code
            for name in CONTRACT["error_classes"]} == CONTRACT["error_classes"]
    assert {"deadline": headers.DEADLINE_HEADER, "trace": headers.TRACE_HEADER,
            "retry_after": headers.RETRY_AFTER_HEADER} == CONTRACT["headers"]


def test_metric_names_equal_the_contract(served):
    with served.stats_lock:
        snap = served.stats_snapshot()
        hists = served.metrics.snapshot()
    # The card's memory gauge appears only on the card: give the renderer one.
    text = metrics.render(snap, hists, device_mem=[("gpu:0", "bytes_limit", "off", 8e10)])
    types = promtext.parse(text, strict=True).types
    assert types == CONTRACT["metrics"]
    assert len(types) == 44


def test_device_memory_gauges_are_empty_on_the_cpu():
    assert metrics.device_memory_gauges("cpu") == []
