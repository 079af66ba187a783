"""The port's serving machinery (``dpf_tpu_torch/serving/``): the batcher's
coalescing, shedding and deadlines, the key cache, the circuit breaker next
to the JAX breaker on the same fault script, the port's transient
classifier, and the device gate of ``core/plans.py``.  All on the CPU
(``device="cpu"``); replies are held to the direct plan calls byte for byte.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.serving import faults as ref_faults  # noqa: E402
from dpf_tpu.serving import handlers as RH  # noqa: E402

from dpf_tpu_torch.core import bitpack, plans, transients  # noqa: E402
from dpf_tpu_torch.core import chacha_np as cc  # noqa: E402
from dpf_tpu_torch.core.keys_chacha import KeyBatchFast  # noqa: E402
from dpf_tpu_torch.serving import faults, handlers  # noqa: E402
from dpf_tpu_torch.serving.batcher import Batcher, PointsWork, dispatch_points  # noqa: E402
from dpf_tpu_torch.serving.errors import DeadlineError, ShedError  # noqa: E402

N, Q = 10, 40


def _request(rng, k):
    """A fast-profile points request: (body, params, expected packed reply)."""
    pairs = [cc.gen(int(a), N, rng) for a in rng.integers(0, 1 << N, size=k)]
    keys = [a for a, _ in pairs]
    xs = rng.integers(0, 1 << N, size=(k, Q), dtype=np.uint64)
    kb = KeyBatchFast.from_bytes(keys, N)
    words = plans.run_points("points", "fast", kb, xs, device="cpu")
    want = bitpack.words_to_wire_rows(words, Q).tobytes()
    params = {"log_n": str(N), "k": str(k), "q": str(Q), "profile": "fast",
              "format": "packed"}
    return b"".join(keys) + xs.astype("<u8").tobytes(), params, want


def _respond(st, body, params, deadline_ms=None):
    rep = handlers.respond(handlers.Request("/v1/eval_points_batch", dict(params), body=body,
                                            deadline_ms=deadline_ms), st)
    return rep.status, b"".join(bytes(c) for c in rep.chunks), rep.retry_after_s


@pytest.fixture
def state(monkeypatch):
    """A fresh port serving state on the CPU, faults cleared after."""
    yield lambda **env: _state(monkeypatch, env)
    faults.clear()


def _state(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return handlers._ServingState("cpu")


def _concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
        time.sleep(0.02)  # arrive in order, behind the first dispatch
    for t in threads:
        t.join()
    return out


def test_batcher_coalesces_concurrent_requests(state):
    st = state()
    rng = np.random.default_rng(1)
    reqs = [_request(rng, 2) for _ in range(6)]
    with faults.injected("dispatch.points:latency:ms=300:times=1"):
        got = _concurrently([lambda r=r: _respond(st, r[0], r[1]) for r in reqs])
    for (status, body, _), r in zip(got, reqs):
        assert status == 200 and body == r[2]
    stats = st.batcher.stats_dict()
    assert stats["requests"] == 6 and stats["dispatches"] < 6
    assert stats["batch_coalesced_max"] > 2


def test_shedding_is_429_with_retry_after(state):
    st = state(DPF_CUDA_QUEUE_MAX_DEPTH="1")
    rng = np.random.default_rng(2)
    reqs = [_request(rng, 1) for _ in range(3)]
    with faults.injected("dispatch.points:latency:ms=300:times=1"):
        got = _concurrently([lambda r=r: _respond(st, r[0], r[1]) for r in reqs])
    assert sorted(g[0] for g in got) == [200, 200, 429]
    shed = next(g for g in got if g[0] == 429)
    assert json.loads(shed[1])["code"] == "shed" and shed[2] > 0
    assert st.batcher.stats_dict()["shed_depth"] == 1


def test_deadlines_expire_in_queue_and_in_flight(state):
    st = state()
    rng = np.random.default_rng(3)
    lead, queued = _request(rng, 1), _request(rng, 1)
    with faults.injected("dispatch.points:latency:ms=300:times=1"):
        got = _concurrently([lambda: _respond(st, lead[0], lead[1]),
                             lambda: _respond(st, queued[0], queued[1], deadline_ms="60")])
    assert got[0][0] == 200 and got[1][0] == 504
    assert json.loads(got[1][1])["code"] == "deadline"
    with faults.injected("dispatch.points:latency:ms=300:times=1"):
        status, body, _ = _respond(st, lead[0], lead[1], deadline_ms="100")
    assert status == 504
    stats = st.batcher.stats_dict()
    assert (stats["expired_queue"], stats["expired_flight"]) == (1, 1)


def test_key_cache_hits_on_repeated_keys(state):
    st = state()
    body, params, want = _request(np.random.default_rng(4), 3)
    assert _respond(st, body, params)[:2] == (200, want)
    assert _respond(st, body, params)[:2] == (200, want)
    kc = st.keys.stats()
    assert (kc["hits"], kc["misses"]) == (1, 1)


def test_standalone_batcher_shed_and_deadline():
    b = Batcher(max_depth=1, window_us=0)
    with pytest.raises(DeadlineError):
        b.submit(PointsWork("points", "fast", None, np.zeros((1, 1), np.uint64),
                            deadline=time.perf_counter() - 1), dispatch_points)
    assert b.stats_dict()["expired_queue"] == 1
    b._pending[("points", "fast", 3)] = [object()]
    kb = KeyBatchFast.from_bytes([cc.gen(1, 3, np.random.default_rng(0))[0]], 3)
    with pytest.raises(ShedError):
        b.submit(PointsWork("points", "fast", kb, np.zeros((1, 1), np.uint64)), dispatch_points)


def _breaker_script(H, fmod, st, req):
    """The same fault script on a serving state -> the observed transitions."""
    body, params = req
    seen = []

    def note(tag, status=None, body=None):
        b = st.breaker.stats()
        seen.append((tag, status, json.loads(body)["code"] if status and status != 200 else None,
                     b["state"], b["trips"], b["retries"], b["transient_failures"],
                     b["fast_fails"], b["recoveries"]))

    with fmod.injected("dispatch.points:unavailable:times=9"):
        for i in range(4):
            rep = H.respond(H.Request("/v1/eval_points_batch", dict(params), body=body), st)
            note(f"req{i}", rep.status, b"".join(bytes(c) for c in rep.chunks))
        r = H.respond_get("/readyz", {}, st)
        note("readyz", r.status, b"".join(r.chunks))
        time.sleep(st.breaker.cooldown_s + 0.05)
        note("cooldown")
        for i in range(2):
            rep = H.respond(H.Request("/v1/eval_points_batch", dict(params), body=body), st)
            note(f"after{i}", rep.status, b"".join(bytes(c) for c in rep.chunks))
    return seen


def test_breaker_matches_the_jax_breaker_on_one_fault_script(monkeypatch):
    for pre in ("DPF_TPU_", "DPF_CUDA_"):
        monkeypatch.setenv(pre + "BREAKER_PROBE", "off")
        monkeypatch.setenv(pre + "RETRY_BACKOFF_MS", "1")
        monkeypatch.setenv(pre + "BREAKER_COOLDOWN_MS", "150")
    body, params, _ = _request(np.random.default_rng(5), 2)
    try:
        ref = _breaker_script(RH, ref_faults, RH._ServingState(), (body, params))
        port = _breaker_script(handlers, faults, handlers._ServingState("cpu"), (body, params))
    finally:
        faults.clear()
        ref_faults.clear()
    assert port == ref
    states = [s[3] for s in port]
    assert "open" in states and states[-1] == "closed" and port[-1][-1] == 1


STICKY = (
    "RuntimeError: CUDA error: an illegal memory access was encountered",
    "RuntimeError: CUDA error: unspecified launch failure",
    "RuntimeError: CUDA error: device-side assert triggered",
    "RuntimeError: CUDA error: misaligned address",
    "RuntimeError: CUDA error: an illegal instruction was encountered",
    "RuntimeError: CUDA error: uncorrectable ECC error encountered",
    "RuntimeError: CUDA error: the launch timed out and was terminated",
    # A sticky error never turns transient, whatever else the text says.
    "PlanError: plans: replaying points/... failed: CUDA error: an illegal memory access "
    "was encountered (UNAVAILABLE)",
)
TRANSIENT = (
    "InjectedUnavailable: UNAVAILABLE: injected fault at dispatch.points",
    "OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
    "RuntimeError: CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "ConnectionRefusedError: [Errno 111] Connection refused",
)


@pytest.mark.parametrize("text", STICKY)
def test_sticky_cuda_errors_are_never_transient(text):
    assert transients.is_sticky_text(text)
    assert not transients.is_transient_text(text)


@pytest.mark.parametrize("text", TRANSIENT)
def test_transient_signatures(text):
    assert transients.is_transient_text(text)


def test_plan_error_maps_to_internal_with_the_plan_key():
    st = handlers._ServingState("cpu")
    rep = handlers.map_error(plans.PlanError("plans: capturing x failed: boom",
                                             "points/fast/30/256"), st)
    assert rep.status == 500
    assert json.loads(rep.chunks[0]) == {"code": "internal",
                                         "detail": "PlanError: plan points/fast/30/256"}


@pytest.mark.parametrize("text", STICKY[:3])
def test_sticky_error_wedges_readiness_and_liveness(text):
    """A sticky CUDA error leaves the context unusable: after one reaches
    a reply, /readyz and /healthz answer 503 so the process is restarted.
    A transient or a validation failure leaves both as they were."""
    st = handlers._ServingState("cpu")
    st.warmed = True
    for e in (ValueError("bad x"), RuntimeError(TRANSIENT[1])):
        handlers.map_error(e, st)
    assert [handlers.respond_get(p, {}, st).status for p in ("/readyz", "/healthz")] == [200, 200]
    kind, _, msg = text.partition(": ")
    try:  # a failed replay arrives as a PlanError raised from the CUDA error
        try:
            raise RuntimeError(msg)
        except RuntimeError as cuda:
            raise plans.PlanError("plans: replaying points/fast/30/256 failed",
                                  "points/fast/30/256") from cuda
    except plans.PlanError as e:
        rep = handlers.map_error(e, st)
    assert rep.status == 500 and json.loads(rep.chunks[0])["code"] == "internal"
    assert st.wedged == "PlanError"
    for p in ("/readyz", "/healthz"):
        r = handlers.respond_get(p, {}, st)
        assert r.status == 503
        assert json.loads(r.chunks[0])["code"] == "unavailable"
        assert "restart" in json.loads(r.chunks[0])["detail"]


def test_device_gate_excludes_and_nests():
    gate = plans.DeviceGate()
    events = []
    inside = threading.Event()

    def reader():
        with gate.shared():
            with gate.shared():  # nests on one thread
                inside.set()
                time.sleep(0.15)
                events.append("reader done")

    t = threading.Thread(target=reader)
    t.start()
    inside.wait()
    with gate.exclusive():  # waits for the reader
        events.append("capture")
    t.join()
    assert events == ["reader done", "capture"]
    # A thread holding the gate shared that must capture sets its hold aside.
    with gate.shared():
        with gate.exclusive():
            with gate.shared():  # nests inside the exclusive hold
                pass
        events.append("upgraded")
    assert events[-1] == "upgraded"
    # A waiting exclusive hold goes before a new shared one.
    order = []
    hold = threading.Event()

    def first():
        with gate.shared():
            hold.wait()

    def capture():
        with gate.exclusive():
            order.append("capture")

    def late_reader():
        with gate.shared():
            order.append("reader")

    threads = [threading.Thread(target=first), threading.Thread(target=capture)]
    for x in threads:
        x.start()
    time.sleep(0.05)
    late = threading.Thread(target=late_reader)
    late.start()
    time.sleep(0.05)
    hold.set()
    for x in threads + [late]:
        x.join()
    assert order == ["capture", "reader"]


def test_degraded_stream_falls_back_to_a_buffered_reply(state):
    st = state(DPF_CUDA_BREAKER_PROBE="off")
    ka, kb = cc.gen(300, N, np.random.default_rng(6))
    req = handlers.Request("/v1/evalfull", {"log_n": str(N), "profile": "fast", "stream": "1"},
                           body=ka)
    streamed = handlers.respond(req, st)
    assert streamed.stream is not None
    data = b"".join(bytes(c) for c in streamed.stream)
    st.breaker._state = "half_open"  # recovering: replies buffer
    buffered = handlers.respond(req, st)
    assert buffered.stream is None and b"".join(bytes(c) for c in buffered.chunks) == data
    assert data == cc.eval_full(ka, N)
