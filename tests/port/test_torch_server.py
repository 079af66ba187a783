"""The port's sidecar (``dpf_tpu_torch/server.py``, ``serving/handlers.py``)
against the JAX sidecar (``dpf_tpu/server.py``, ``dpf_tpu/serving/handlers.py``).

The same request bytes go to both handler cores (``respond``): status,
``{code}`` and reply bytes must be equal, for every deterministic route of
``docs/CONTRACT.json`` in both profiles where a route has two, error cases
included.  Each group of routes runs once a module (a module-scoped fixture:
the JAX references compile once), and one test a case compares.  The gen
routes draw from a CSPRNG, so their keys are evaluated by the JAX package and
the numpy spec instead, and must reconstruct.  A few checks go over HTTP
(the malformed ``Content-Length``, a round trip), with 120 s timeouts.
The port's sidecar runs on ``device="cpu"`` here; without CUDA and without
that, ``serve()`` raises.  Tolerance: exact bytes.
"""

import io
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu import server as ref_server  # noqa: E402
from dpf_tpu.serving import handlers as RH  # noqa: E402

import chip_smoke  # noqa: E402
from dpf_tpu_torch import server as port_server  # noqa: E402
from dpf_tpu_torch.apps import heavy_hitters as hh  # noqa: E402
from dpf_tpu_torch.core import chacha_np as cc  # noqa: E402
from dpf_tpu_torch.core import plans, spec  # noqa: E402
from dpf_tpu_torch.models import dcf  # noqa: E402
from dpf_tpu_torch.serving import handlers as PH  # noqa: E402

N_C, N_F, N_DCF = 7, 10, 12  # compat, fast and DCF domains (small compiles)
HTTP_TIMEOUT = 120


@pytest.fixture(scope="module")
def states():
    """One JAX serving state and one port serving state on the CPU."""
    return RH._ServingState(), PH._ServingState("cpu")


def _reply(H, st, route, params, body=b"", sink=False, deadline_ms=None):
    req = H.Request(route=route, params=dict(params), content_length=len(body),
                    deadline_ms=deadline_ms)
    if sink:
        req.body_reader = H.FileBodyReader(io.BytesIO(body), len(body))
    else:
        req.body = body
    rep = H.respond(req, st)
    chunks = rep.stream if rep.stream is not None else rep.chunks
    return rep.status, b"".join(bytes(c) for c in chunks), rep.retry_after_s


def _run(states, cases):
    """name -> (JAX reply, port reply), each case sent to both cores in order."""
    ref_st, port_st = states
    out = {}
    for name, route, params, body, sink, deadline in cases:
        out[name] = (_reply(RH, ref_st, route, params, body, sink, deadline),
                     _reply(PH, port_st, route, params, body, sink, deadline))
    return out


def _u8(x) -> bytes:
    return np.ascontiguousarray(x).astype("<u8").tobytes()


def _keys(profile, alphas, log_n, rng):
    gen = spec.gen if profile == "compat" else cc.gen
    pairs = [gen(int(a), log_n, rng) for a in alphas]
    return [a for a, _ in pairs], [b for _, b in pairs]


# ---------------------------------------------------------------------------
# Full-domain and pointwise routes, both profiles
# ---------------------------------------------------------------------------

EVAL_CASES = (
    "evalfull/compat", "evalfull/compat/stream", "evalfull/fast", "evalfull/fast/stream",
    "evalfull/bogus-profile", "evalfull/wrong-length", "evalfull/deadline-0",
    "evalfull/deadline-abc", "evalfull/missing-log_n", "evalfull/bad-log_n",
    "evalfull_batch/compat", "evalfull_batch/fast", "evalfull_batch/compat/k0",
    "evalfull_batch/fast/k0", "evalfull_batch/wrong-length",
    "points/compat/bits", "points/compat/packed", "points/fast/bits", "points/fast/packed",
    "points/bogus-profile", "points/compat/out-of-domain", "points/fast/out-of-domain",
    "points/wrong-length", "points/unknown-format", "eval/compat", "eval/fast",
    "eval/compat/out-of-domain", "eval/fast/out-of-domain", "eval/compat/wrong-length",
    "eval/fast/wrong-length", "unknown-route",
)


@pytest.fixture(scope="module")
def eval_pairs(states):
    rng = np.random.default_rng(160)
    ca, cb = _keys("compat", [5, 100, 127], N_C, rng)
    fa, fb = _keys("fast", [5, 700, 1023], N_F, rng)
    xc = rng.integers(0, 1 << N_C, size=(3, 40), dtype=np.uint64)
    xf = rng.integers(0, 1 << N_F, size=(3, 40), dtype=np.uint64)
    bad_c, bad_f = xc.copy(), xf.copy()
    bad_c[1, 7], bad_f[2, 0] = 1 << N_C, 1 << N_F
    pc = {"log_n": str(N_C)}
    pf = {"log_n": str(N_F), "profile": "fast"}
    pts_c = {**pc, "k": "3", "q": "40"}
    pts_f = {**pf, "k": "3", "q": "40"}
    body_c, body_f = b"".join(ca) + _u8(xc), b"".join(fa) + _u8(xf)
    cases = [
        ("evalfull/compat", "/v1/evalfull", pc, ca[0], False, None),
        ("evalfull/compat/stream", "/v1/evalfull", {**pc, "stream": "1"}, cb[1], False, None),
        ("evalfull/fast", "/v1/evalfull", pf, fa[0], False, None),
        ("evalfull/fast/stream", "/v1/evalfull", {**pf, "stream": "1"}, fb[1], False, None),
        ("evalfull/bogus-profile", "/v1/evalfull", {**pc, "profile": "bogus"}, ca[1], False,
         None),
        ("evalfull/wrong-length", "/v1/evalfull", pc, ca[0][:-1], False, None),
        ("evalfull/deadline-0", "/v1/evalfull", pc, ca[0], False, "0"),
        ("evalfull/deadline-abc", "/v1/evalfull", pc, ca[0], False, "abc"),
        ("evalfull/missing-log_n", "/v1/evalfull", {}, ca[0], False, None),
        ("evalfull/bad-log_n", "/v1/evalfull", {"log_n": "x"}, ca[0], False, None),
        ("evalfull_batch/compat", "/v1/evalfull_batch", {**pc, "k": "3"}, b"".join(ca), False,
         None),
        ("evalfull_batch/fast", "/v1/evalfull_batch", {**pf, "k": "3"}, b"".join(fb), False,
         None),
        ("evalfull_batch/compat/k0", "/v1/evalfull_batch", {**pc, "k": "0"}, b"", False, None),
        ("evalfull_batch/fast/k0", "/v1/evalfull_batch", {**pf, "k": "0"}, b"", False, None),
        ("evalfull_batch/wrong-length", "/v1/evalfull_batch", {**pc, "k": "2"}, ca[0], False,
         None),
        ("points/compat/bits", "/v1/eval_points_batch", {**pts_c, "format": "bits"}, body_c,
         False, None),
        ("points/compat/packed", "/v1/eval_points_batch", {**pts_c, "format": "packed"},
         b"".join(cb) + _u8(xc), False, None),
        ("points/fast/bits", "/v1/eval_points_batch", {**pts_f, "format": "bits"}, body_f,
         False, None),
        ("points/fast/packed", "/v1/eval_points_batch", {**pts_f, "format": "packed"},
         b"".join(fb) + _u8(xf), False, None),
        ("points/bogus-profile", "/v1/eval_points_batch", {**pts_c, "profile": "bogus"}, body_c,
         False, None),
        ("points/compat/out-of-domain", "/v1/eval_points_batch", pts_c,
         b"".join(ca) + _u8(bad_c), False, None),
        ("points/fast/out-of-domain", "/v1/eval_points_batch", pts_f,
         b"".join(fa) + _u8(bad_f), False, None),
        ("points/wrong-length", "/v1/eval_points_batch", pts_c, body_c[:-8], False, None),
        ("points/unknown-format", "/v1/eval_points_batch", {**pts_c, "format": "hex"}, body_c,
         False, None),
        ("eval/compat", "/v1/eval", {**pc, "x": "100"}, ca[1], False, None),
        ("eval/fast", "/v1/eval", {**pf, "x": "700"}, fa[1], False, None),
        ("eval/compat/out-of-domain", "/v1/eval", {**pc, "x": str(1 << N_C)}, ca[1], False,
         None),
        ("eval/fast/out-of-domain", "/v1/eval", {**pf, "x": "-1"}, fa[1], False, None),
        ("eval/compat/wrong-length", "/v1/eval", {**pc, "x": "5"}, ca[0][:-1], False, None),
        ("eval/fast/wrong-length", "/v1/eval", {**pf, "x": "5"}, fa[0] + b"x", False, None),
        ("unknown-route", "/v1/nope", pc, ca[0], False, None),
    ]
    assert tuple(c[0] for c in cases) == EVAL_CASES
    return _run(states, cases)


def _assert_same(pair):
    (rs, rb, rra), (ps, pb, pra) = pair
    assert (ps, pb) == (rs, rb)
    assert (pra is None) == (rra is None)


# The JAX sidecar answers a fast /v1/eval through its native library when
# that is built, whose failures read "native eval failed (rc=...)"; the
# port has no native library and answers with the spec's message (the JAX
# package's own, without the library).  Status and code still agree.
NATIVE_DETAIL = ("eval/fast/out-of-domain", "eval/fast/wrong-length")


@pytest.mark.parametrize("name", EVAL_CASES)
def test_eval_routes_match_the_jax_sidecar(eval_pairs, name):
    if name in NATIVE_DETAIL:
        (rs, rb, _), (ps, pb, _) = eval_pairs[name]
        assert ps == rs == 400
        assert json.loads(pb)["code"] == json.loads(rb)["code"] == "bad_request"
        return
    _assert_same(eval_pairs[name])


def test_eval_routes_answer_and_fail_as_expected(eval_pairs):
    """The comparisons above are not vacuous: the served cases answer 200,
    the error cases carry their codes, and evalfull_batch at k=0 (ROADMAP
    C.7's route) answers as the JAX sidecar does."""
    status = {n: p[1][0] for n, p in eval_pairs.items()}
    for n in ("evalfull/compat", "evalfull/fast/stream", "points/fast/packed", "eval/compat",
              "evalfull/bogus-profile"):
        assert status[n] == 200, n
    for n in ("evalfull/wrong-length", "evalfull/deadline-0", "points/compat/out-of-domain",
              "points/unknown-format", "eval/compat/out-of-domain", "eval/fast/out-of-domain",
              "eval/compat/wrong-length", "eval/fast/wrong-length"):
        assert status[n] == 400 and json.loads(eval_pairs[n][1][1])["code"] == "bad_request"
    assert status["evalfull_batch/compat/k0"] == eval_pairs["evalfull_batch/compat/k0"][0][0]
    assert status["unknown-route"] == 404


# ---------------------------------------------------------------------------
# DCF, heavy hitters, aggregation, PIR
# ---------------------------------------------------------------------------

APP_CASES = (
    "dcf_points/bits", "dcf_points/packed", "dcf_points/out-of-domain",
    "dcf_interval/bits", "dcf_interval/packed", "dcf_interval/wrong-length",
    "hh/compat/level0", "hh/compat/level4", "hh/fast/level2", "hh/fast/level9",
    "hh/compat/session-d2", "hh/compat/session-d5", "hh/compat/session-d7",
    "hh/fast/session-d3", "hh/fast/session-d6", "hh/fast/session-d10", "hh/bad-level",
    "agg/xor", "agg/add", "agg/bad-op", "agg/short-body",
    "pir_db/compat", "pir_db/fast", "pir_query/compat", "pir_query/compat/b",
    "pir_query/fast", "pir_query/fast/b", "pir_db/bad-name", "pir_query/unknown-db",
    "pir_query/wrong-length",
)

HH_VALUES = {"compat": (3, 3, 5, 100, 101, 127, 3), "fast": (3, 3, 900, 901, 1000, 3, 17)}
HH_N = {"compat": N_C, "fast": N_F}


def _hh_cases(profile, rng):
    """Stateless rounds on level keys, then an incremental session descent
    over the level-(n-1) keys (the session contract) -> (cases, level keys)."""
    n = HH_N[profile]
    vals = np.array(HH_VALUES[profile], np.uint64)
    sa, _ = hh.gen_shares(vals, n, profile, np.random.default_rng(rng.integers(1 << 30)),
                          device="cpu")
    g = len(vals)
    cases = []
    levels = (0, 4) if profile == "compat" else (2, 9)
    for lv in levels:
        cands = (np.arange(min(1 << (lv + 1), 40), dtype=np.uint64) << np.uint64(n - lv - 1))
        body = b"".join(sa.level_keys(lv).to_bytes()) + _u8(cands)
        cases.append((f"hh/{profile}/level{lv}", "/v1/hh/eval",
                      {"log_n": str(n), "k": str(g), "q": str(cands.size), "level": str(lv),
                       "profile": profile, "format": "packed"}, body, False, None))
    last = b"".join(sa.level_keys(n - 1).to_bytes())
    depths = (2, 5, 7) if profile == "compat" else (3, 6, 10)
    for d in depths:
        cands = np.unique(vals >> np.uint64(n - d))
        cands = np.concatenate([cands, (cands + np.uint64(1)) % np.uint64(1 << d)])
        raw = cands << np.uint64(n - d)
        cases.append((f"hh/{profile}/session-d{d}", "/v1/hh/eval",
                      {"log_n": str(n), "k": str(g), "q": str(raw.size), "level": str(d - 1),
                       "profile": profile, "session": f"sess-{profile}"},
                      last + _u8(raw), False, None))
    return cases


@pytest.fixture(scope="module")
def app_pairs(states):
    rng = np.random.default_rng(161)
    al = np.array([1, 2000, 4095], np.uint64)
    da, _ = dcf.gen_lt_batch(al, N_DCF, rng=rng, device="cpu")
    xs = rng.integers(0, 1 << N_DCF, size=(3, 33), dtype=np.uint64)
    xs[:, 0] = al
    bad = xs.copy()
    bad[0, 5] = 1 << N_DCF
    pd = {"log_n": str(N_DCF), "k": "3", "q": "33"}
    ia, _ = dcf.gen_interval_batch(np.array([0, 10, 4000], np.uint64),
                                   np.array([5, 3000, 4095], np.uint64), N_DCF, rng=rng,
                                   device="cpu")
    iblob = (b"".join(ia[0].to_bytes()) + b"".join(ia[1].to_bytes())
             + np.asarray(ia[2], np.uint8).tobytes())
    hc, hf = _hh_cases("compat", rng), _hh_cases("fast", rng)
    rows = rng.integers(0, 1 << 32, size=(9, 5), dtype=np.uint64).astype("<u4").tobytes()
    db_rows = rng.integers(0, 256, size=(100, 8), dtype=np.uint8).tobytes()
    pir_keys = {}
    for prof in ("compat", "fast"):
        # 100 rows: a domain of 2^7 (compat) or 2^9 (fast) rows.
        qa, qb = _keys(prof, [17, 99], 7 if prof == "compat" else 9, rng)
        pir_keys[prof] = (b"".join(qa), b"".join(qb))
    cases = [
        ("dcf_points/bits", "/v1/dcf_eval_points", {**pd, "format": "bits"},
         b"".join(da.to_bytes()) + _u8(xs), False, None),
        ("dcf_points/packed", "/v1/dcf_eval_points", {**pd, "format": "packed"},
         b"".join(da.to_bytes()) + _u8(xs), False, None),
        ("dcf_points/out-of-domain", "/v1/dcf_eval_points", pd,
         b"".join(da.to_bytes()) + _u8(bad), False, None),
        ("dcf_interval/bits", "/v1/dcf_interval_eval", {**pd, "format": "bits"},
         iblob + _u8(xs), False, None),
        ("dcf_interval/packed", "/v1/dcf_interval_eval", {**pd, "format": "packed"},
         iblob + _u8(xs), False, None),
        ("dcf_interval/wrong-length", "/v1/dcf_interval_eval", pd, iblob, False, None),
        # The stateless rounds, then each profile's session descent in order.
        *hc[:2], *hf[:2], *hc[2:], *hf[2:],
    ]
    cases += [
        ("hh/bad-level", "/v1/hh/eval", {"log_n": str(N_C), "k": "1", "q": "1", "level": "9"},
         b"", False, None),
        ("agg/xor", "/v1/agg/submit", {"op": "xor", "k": "9", "words": "5"}, rows, True, None),
        ("agg/add", "/v1/agg/submit", {"op": "add", "k": "9", "words": "5"}, rows, True, None),
        ("agg/bad-op", "/v1/agg/submit", {"op": "mul", "k": "9", "words": "5"}, rows, True,
         None),
        ("agg/short-body", "/v1/agg/submit", {"op": "xor", "k": "9", "words": "5"}, rows[:-4],
         True, None),
        ("pir_db/compat", "/v1/pir/db", {"name": "db-c", "rows": "100", "row_bytes": "8"},
         db_rows, True, None),
        ("pir_db/fast", "/v1/pir/db",
         {"name": "db-f", "rows": "100", "row_bytes": "8", "profile": "fast"}, db_rows, True,
         None),
        ("pir_query/compat", "/v1/pir/query", {"db": "db-c", "k": "2"}, pir_keys["compat"][0],
         False, None),
        ("pir_query/compat/b", "/v1/pir/query", {"db": "db-c", "k": "2"},
         pir_keys["compat"][1], False, None),
        ("pir_query/fast", "/v1/pir/query", {"db": "db-f", "k": "2"}, pir_keys["fast"][0],
         False, None),
        ("pir_query/fast/b", "/v1/pir/query", {"db": "db-f", "k": "2"}, pir_keys["fast"][1],
         False, None),
        ("pir_db/bad-name", "/v1/pir/db", {"name": "no such!", "rows": "1", "row_bytes": "8"},
         b"\0" * 8, True, None),
        ("pir_query/unknown-db", "/v1/pir/query", {"db": "nope", "k": "1"}, b"", False, None),
        ("pir_query/wrong-length", "/v1/pir/query", {"db": "db-c", "k": "2"},
         pir_keys["compat"][0][:-1], False, None),
    ]
    assert tuple(c[0] for c in cases) == APP_CASES
    out = _run(states, cases)
    out["_db_rows"] = db_rows
    return out


@pytest.mark.parametrize("name", APP_CASES)
def test_app_routes_match_the_jax_sidecar(app_pairs, name):
    _assert_same(app_pairs[name])


def test_app_routes_answer(app_pairs):
    """The served app cases answer 200 and reconstruct: the PIR answers XOR
    to the queried rows, the heavy-hitter rounds are not all zero."""
    for n in APP_CASES:
        if "/" in n and not any(t in n for t in ("bad", "wrong", "unknown", "short",
                                                  "out-of-domain")):
            assert app_pairs[n][1][0] == 200, n
    rows = np.frombuffer(app_pairs["_db_rows"], np.uint8).reshape(100, 8)
    for prof in ("compat", "fast"):
        a = np.frombuffer(app_pairs[f"pir_query/{prof}"][1][1], np.uint8)
        b = np.frombuffer(app_pairs[f"pir_query/{prof}/b"][1][1], np.uint8)
        assert np.array_equal((a ^ b).reshape(2, 8), rows[[17, 99]])


# ---------------------------------------------------------------------------
# The gen routes: CSPRNG keys, evaluated by the JAX package and the spec
# ---------------------------------------------------------------------------


def test_gen_routes_reconstruct_under_the_jax_package_and_the_spec(states, eval_pairs,
                                                                    app_pairs):
    ref_st, port_st = states
    for profile, n, alpha in (("compat", N_C, 77), ("fast", N_F, 600)):
        st, body, _ = _reply(PH, port_st, "/v1/gen",
                             {"log_n": str(n), "alpha": str(alpha), "profile": profile})
        assert st == 200
        kl = len(body) // 2
        ka, kb = body[:kl], body[kl:]
        ev = spec.eval_full if profile == "compat" else cc.eval_full
        rec = np.frombuffer(ev(ka, n), np.uint8) ^ np.frombuffer(ev(kb, n), np.uint8)
        assert np.flatnonzero(np.unpackbits(rec, bitorder="little")).tolist() == [alpha]
        outs = [_reply(RH, ref_st, "/v1/evalfull", {"log_n": str(n), "profile": profile}, k)
                for k in (ka, kb)]
        assert outs[0][0] == 200
        rec = np.frombuffer(outs[0][1], np.uint8) ^ np.frombuffer(outs[1][1], np.uint8)
        assert np.flatnonzero(np.unpackbits(rec, bitorder="little")).tolist() == [alpha]
    # DCF comparison gates.
    al = np.array([3, 2048, 4000], np.uint64)
    st, body, _ = _reply(PH, port_st, "/v1/dcf_gen", {"log_n": str(N_DCF), "k": "3"}, _u8(al))
    assert st == 200
    xs = np.tile(np.array([0, 2, 3, 4, 2047, 2048, 3999, 4000, 4095], np.uint64), (3, 1))
    half = len(body) // 2
    shares = [np.frombuffer(_reply(RH, ref_st, "/v1/dcf_eval_points",
                                   {"log_n": str(N_DCF), "k": "3", "q": "9"},
                                   blob + _u8(xs))[1], np.uint8)
              for blob in (body[:half], body[half:])]
    assert np.array_equal((shares[0] ^ shares[1]).reshape(3, 9),
                          (xs < al[:, None]).astype(np.uint8))
    # DCF interval gates.
    lo, hi = np.array([0, 100, 4000], np.uint64), np.array([3, 2000, 4095], np.uint64)
    st, body, _ = _reply(PH, port_st, "/v1/dcf_interval_gen", {"log_n": str(N_DCF), "k": "3"},
                         _u8(lo) + _u8(hi))
    assert st == 200
    half = len(body) // 2
    shares = [np.frombuffer(_reply(RH, ref_st, "/v1/dcf_interval_eval",
                                   {"log_n": str(N_DCF), "k": "3", "q": "9"},
                                   blob + _u8(xs))[1], np.uint8)
              for blob in (body[:half], body[half:])]
    assert np.array_equal((shares[0] ^ shares[1]).reshape(3, 9),
                          ((xs >= lo[:, None]) & (xs <= hi[:, None])).astype(np.uint8))


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_hh_gen_reconstructs_under_the_jax_sidecar(states, app_pairs, profile):
    """/v1/hh/gen of the port: the JAX sidecar's /v1/hh/eval over both blobs'
    level keys counts every client's prefix exactly."""
    ref_st, port_st = states
    n = HH_N[profile]
    vals = np.array(HH_VALUES[profile], np.uint64)
    g = len(vals)
    st, body, _ = _reply(PH, port_st, "/v1/hh/gen",
                         {"log_n": str(n), "k": str(g), "profile": profile}, _u8(vals))
    assert st == 200
    kl = (spec.key_len if profile == "compat" else cc.key_len)(n)
    lv = 2
    cands = np.arange(1 << (lv + 1), dtype=np.uint64) << np.uint64(n - lv - 1)
    rows = []
    for blob in (body[: len(body) // 2], body[len(body) // 2:]):
        lk = np.ascontiguousarray(np.frombuffer(blob, np.uint8).reshape(g, n, kl)[:, lv])
        st, r, _ = _reply(RH, ref_st, "/v1/hh/eval",
                          {"log_n": str(n), "k": str(g), "q": str(cands.size),
                           "level": str(lv), "profile": profile}, lk.tobytes() + _u8(cands))
        assert st == 200
        rows.append(np.frombuffer(r, np.uint8).reshape(g, cands.size))
    counts = (rows[0] ^ rows[1]).sum(axis=0)
    want = np.bincount((vals >> np.uint64(n - lv - 1)).astype(np.int64), minlength=cands.size)
    assert counts.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# Control routes, the GET surface, HTTP, the device rule
# ---------------------------------------------------------------------------


def test_warmup_and_readiness_match(states):
    ref_st, port_st = states
    for path in ("/healthz", "/readyz", "/v1/nope"):
        r, p = RH.respond_get(path, {}, ref_st), PH.respond_get(path, {}, port_st)
        assert (p.status, b"".join(p.chunks)) == (r.status, b"".join(r.chunks))
    r = _reply(RH, ref_st, "/v1/warmup", {}, b"[]")
    p = _reply(PH, port_st, "/v1/warmup", {}, b"[]")
    assert p[0] == r[0] == 200
    assert json.loads(p[1])["warmed"] == json.loads(r[1])["warmed"] == []
    # The port's trace_cache_entries is capture_count(): no graph on the CPU.
    assert json.loads(p[1])["trace_cache_entries"] == plans.capture_count() == 0
    r = _reply(RH, ref_st, "/v1/profile", {}, b'{"action": "start"}')
    p = _reply(PH, port_st, "/v1/profile", {}, b'{"action": "start"}')
    assert p[0] == r[0] == 403
    assert json.loads(p[1])["code"] == json.loads(r[1])["code"] == "profile_forbidden"


@pytest.fixture(scope="module")
def http_pair():
    """The JAX and the port sidecars over HTTP on ephemeral ports."""
    ref = ref_server.serve(port=0)
    port = port_server.serve(port=0, device="cpu")
    yield (f"http://127.0.0.1:{ref.server_address[1]}",
           f"http://127.0.0.1:{port.server_address[1]}")
    for s in (ref, port):
        s.shutdown()
        s.server_close()


def test_malformed_content_length_over_http(http_pair):
    import http.client

    replies = []
    for url in http_pair:
        host, p = url.replace("http://", "").split(":")
        conn = http.client.HTTPConnection(host, int(p), timeout=HTTP_TIMEOUT)
        try:
            conn.putrequest("POST", f"/v1/gen?log_n={N_C}")
            conn.putheader("Content-Length", "abc")
            conn.endheaders()
            resp = conn.getresponse()
            replies.append((resp.status, resp.read()))
        finally:
            conn.close()
    assert replies[1] == replies[0]
    assert replies[0][0] == 400 and json.loads(replies[0][1])["code"] == "bad_request"


def test_http_round_trip_and_headers(http_pair):
    ka, _ = spec.gen(9, N_C, np.random.default_rng(3))
    got = []
    for url in http_pair:
        req = urllib.request.Request(f"{url}/v1/evalfull?log_n={N_C}", data=ka, method="POST",
                                     headers={"X-DPF-Trace": "t-http"})
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            got.append((r.status, r.read(), r.headers["Content-Type"]))
        # The server records the trace after it has written the reply: poll.
        deadline = time.monotonic() + HTTP_TIMEOUT
        while True:
            with urllib.request.urlopen(f"{url}/v1/trace?id=t-http",
                                        timeout=HTTP_TIMEOUT) as r:
                tr = json.loads(r.read())
            if tr["traces"] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert tr["traces"] and tr["traces"][0]["trace_id"] == "t-http"
    assert got[1] == got[0]


def test_serve_without_cuda_raises_naming_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_server.serve(port=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PH._ServingState()


def test_chip_smoke_sidecar_phase_dry_run_on_cpu():
    """chip_smoke.py's phase 41 at its tiny ``dry`` shapes on the CPU: the
    same requests, checks and parsing as on the card."""
    chip_smoke.sidecar_phase(torch.device("cpu"), "cpu", 4, size="dry")
