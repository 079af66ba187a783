"""The port's dispatch plans (``dpf_tpu_torch/core/plans.py``), its knobs
(``core/knobs.py``) and its PIR store (``apps/pir_store.py``) against the JAX
package's, on the CPU.

The buckets, the plan keys and the route set equal the reference's over a
sweep (``dpf_tpu.core.plans``, nothing compiled).  Every ``run_*`` runs on
``device="cpu"`` at off-bucket K and Q (K 3 and 5, Q 17 and 33, log_n 9-12)
and is byte-identical to the port's direct model call and, where it is
cheap, to the numpy spec; ``run_points`` compat is held once to
``dpf_tpu.core.plans.run_points`` at log_n 9 (its one compile, about 5 s).
The plan bookkeeping mirrors ``tests/test_serving.py``: warmup makes misses
then hits, ``recent_shapes`` leaves out ``pir`` and ``hh_extend``, and the
padding memo keeps one padded batch.  The apps and the dealer go through the
plans, with their hits counted.  On the CPU no graph is captured.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.apps import pir_store as ref_store  # noqa: E402
from dpf_tpu.core import knobs as ref_knobs  # noqa: E402
from dpf_tpu.core import plans as ref_plans  # noqa: E402
from dpf_tpu.ops import sbox_circuit as ref_sbox  # noqa: E402
import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu_torch import fast, interop  # noqa: E402
from dpf_tpu_torch.apps import aggregation as agg  # noqa: E402
from dpf_tpu_torch.apps import heavy_hitters as hh  # noqa: E402
from dpf_tpu_torch.apps import pir_store  # noqa: E402
from dpf_tpu_torch.core import bitpack, chacha_np, keys, keys_chacha  # noqa: E402
from dpf_tpu_torch.core import knobs, plans, spec  # noqa: E402
from dpf_tpu_torch.models import dcf, hh_fold, keys_gen, pir  # noqa: E402
from dpf_tpu_torch.models import dpf as md  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as mdc  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import to_carrier  # noqa: E402

CPU = "cpu"
# (log_n, K, Q): off-bucket key and query counts.
POINT_CASES = [(9, 3, 17), (10, 5, 33), (11, 3, 33), (12, 5, 17)]


@pytest.fixture(autouse=True)
def _fresh_knobs(monkeypatch):
    for name in list(knobs.REGISTRY) + ["DPF_TPU_PLAN_KFLOOR", "DPF_TPU_FUSE"]:
        monkeypatch.delenv(name, raising=False)


def _batches(log_n, k, seed):
    """Both parties' batches of the three key families, dealt on the CPU."""
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=k, dtype=np.uint64)
    return alphas, {
        "compat": port.gen_batch(alphas, log_n, rng, device=CPU),
        "fast": fast.gen_batch(alphas, log_n, rng, device=CPU),
        "dcf": dcf.gen_lt_batch(alphas, log_n, rng, device=CPU),
    }


# ---------------------------------------------------------------------------
# Buckets and keys, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("floor", ["", "32"])
def test_buckets_match_reference(monkeypatch, floor):
    monkeypatch.setenv("DPF_TPU_PLAN_KFLOOR", floor)
    monkeypatch.setenv("DPF_CUDA_PLAN_KFLOOR", floor)
    assert plans.k_floor() == ref_plans.k_floor()
    for n in range(0, 300):
        assert plans.k_bucket(n) == ref_plans.k_bucket(n), n
        assert plans.q_bucket(n) == ref_plans.q_bucket(n), n
        assert plans._pow2_bucket(n, 7) == ref_plans._pow2_bucket(n, 7)


def test_plan_routes_are_the_reference_routes():
    assert plans.PLAN_ROUTES == ref_plans.PLAN_ROUTES
    assert plans.PlanKey._fields == ref_plans.PlanKey._fields


@pytest.mark.parametrize("route", sorted(ref_plans.PLAN_ROUTES))
def test_plan_key_matches_reference(route):
    for profile in ("compat", "fast"):
        for log_n in (9, 20, 32):
            for k in (0, 1, 3, 5, 200, 1000, 4096):
                for q in (0, 1, 17, 33, 4000):
                    for variant in ("", "tree64"):
                        got = plans.plan_key(route, profile, log_n, k, q, True, 0, variant)
                        want = ref_plans.plan_key(route, profile, log_n, k, q, True, 0, variant)
                        assert got._replace(sbox="") == want._replace(sbox="")
                        assert want.sbox is ref_sbox.SBOX_IMPLS[got.sbox]


def test_plan_key_rejects_unknown_route_and_a_mesh():
    with pytest.raises(ValueError, match="unknown route"):
        plans.plan_key("evalful", "compat", 9, 1)
    with pytest.raises(ValueError, match="mesh"):
        plans.plan_key("points", "compat", 9, 1, 32, mesh=2)


# ---------------------------------------------------------------------------
# Every run_* on the CPU, against the direct model call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,profile", [("points", "compat"), ("points", "fast"),
                                           ("dcf_points", "fast")])
@pytest.mark.parametrize("log_n,K,Q", POINT_CASES)
def test_run_points_matches_direct_call(route, profile, log_n, K, Q):
    alphas, batches = _batches(log_n, K, log_n * 100 + K + Q)
    family = "dcf" if route == "dcf_points" else profile
    ka, kb = batches[family]
    rng = np.random.default_rng(Q)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    direct = {"compat": lambda b: md.eval_points(b, xs, packed=True, device=CPU),
              "fast": lambda b: mdc.eval_points(b, xs, packed=True, device=CPU),
              "dcf": lambda b: dcf.eval_lt_points(b, xs, packed=True, device=CPU)}[family]
    got = [plans.run_points(route, profile, b, xs, device=CPU) for b in (ka, kb)]
    for g, b in zip(got, (ka, kb)):
        assert g.dtype == np.uint32 and g.shape == (K, bitpack.packed_words(Q))
        np.testing.assert_array_equal(g, direct(b))
    bits = bitpack.unpack_bits(got[0] ^ got[1], Q)
    want = (xs < alphas[:, None]) if family == "dcf" else (xs == alphas[:, None])
    np.testing.assert_array_equal(bits, want.astype(np.uint8))
    if (log_n, K) == (9, 3):  # the numpy spec at every point of the cheapest case
        spec_point = {"compat": lambda key, x: spec.eval_point(key, x, log_n),
                      "fast": lambda key, x: chacha_np.eval_point(key, x, log_n)}
        if family == "dcf":
            np.testing.assert_array_equal(bitpack.unpack_bits(got[0], Q),
                                          dcf.eval_points_np(ka, xs))
        else:
            blobs = ka.to_bytes()
            np.testing.assert_array_equal(
                bitpack.unpack_bits(got[0], Q),
                [[spec_point[family](blobs[i], int(x)) for x in xs[i]] for i in range(K)])


@pytest.mark.parametrize("profile", ["compat", "fast"])
@pytest.mark.parametrize("log_n,K", [(9, 3), (10, 5), (12, 3)])
def test_run_evalfull_matches_direct_call_and_spec(profile, log_n, K):
    alphas, batches = _batches(log_n, K, log_n + K)
    ka, kb = batches[profile]
    model, full = (md, spec.eval_full) if profile == "compat" else (mdc, chacha_np.eval_full)
    got = plans.run_evalfull(profile, ka, device=CPU)
    np.testing.assert_array_equal(got, model.eval_full(ka, device=CPU))
    assert got[K - 1].tobytes() == full(ka.to_bytes()[K - 1], log_n)
    rec = np.unpackbits(got ^ plans.run_evalfull(profile, kb, device=CPU), axis=1,
                        bitorder="little")
    assert (rec.sum(1) == 1).all() and (rec[np.arange(K), alphas.astype(np.int64)] == 1).all()


@pytest.mark.parametrize("log_n,K,Q", [(10, 3, 17), (12, 5, 33)])
def test_run_interval_matches_direct_call(log_n, K, Q):
    rng = np.random.default_rng(log_n)
    lo = rng.integers(0, 1 << (log_n - 1), size=K, dtype=np.uint64)
    hi = lo + rng.integers(0, 1 << (log_n - 1), size=K, dtype=np.uint64)
    hi[0] = (1 << log_n) - 1  # the wrap edge
    ia, ib = dcf.gen_interval_batch(lo, hi, log_n, rng, device=CPU)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0], xs[:, 1] = lo, hi
    got = [plans.run_interval(ik, xs, device=CPU) for ik in (ia, ib)]
    for g, ik in zip(got, (ia, ib)):
        np.testing.assert_array_equal(g, dcf.eval_interval_points(ik, xs, packed=True,
                                                                  device=CPU))
    want = (lo[:, None] <= xs) & (xs <= hi[:, None])
    np.testing.assert_array_equal(bitpack.unpack_bits(got[0] ^ got[1], Q), want)


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_run_hh_level_matches_direct_call(profile):
    log_n, K, Q, level = 11, 5, 33, 4
    _, batches = _batches(log_n, K, 7)
    ka = batches[profile][0]
    xs = np.random.default_rng(1).integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    model = md if profile == "compat" else mdc
    np.testing.assert_array_equal(
        plans.run_hh_level(profile, ka, xs, level, device=CPU),
        model.eval_points_level_grouped(ka, xs, groups=1, packed=True, levels=(level,),
                                        device=CPU))


@pytest.mark.parametrize("G,W,q", [(3, 1, 17), (5, 2, 33), (5, 2, None)])
def test_run_hh_fold_matches_count_fold(G, W, q):
    rows = np.random.default_rng(G).integers(0, 1 << 32, size=(G, W), dtype=np.uint32)
    want = hh_fold.count_fold(rows, CPU)
    got = plans.run_hh_fold(rows, q, device=CPU)
    np.testing.assert_array_equal(got, want[: W * 32 if q is None else q])
    np.testing.assert_array_equal(got, hh.reconstruct_counts(rows, np.zeros_like(rows),
                                                             got.shape[0], fold="host"))


@pytest.mark.parametrize("op", ["xor", "add"])
@pytest.mark.parametrize("R,W", [(3, 5), (17, 33)])
def test_run_agg_fold_matches_numpy(op, R, W):
    rng = np.random.default_rng(R * W)
    rows = rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint32)
    carry = rng.integers(0, 1 << 32, size=W, dtype=np.uint32)
    fold = (np.bitwise_xor.reduce(rows, axis=0) ^ carry if op == "xor"
            else (rows.astype(np.uint64).sum(0) + carry).astype(np.uint32))
    np.testing.assert_array_equal(plans.run_agg_fold(op, carry, rows, device=CPU), fold)
    # Rows already in carriers on the device fold where they are.
    np.testing.assert_array_equal(plans.run_agg_fold(op, carry, to_carrier(rows), device=CPU),
                                  fold)


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_run_pir_matches_server_answer(profile):
    pir_store.reset()
    rng = np.random.default_rng(5)
    db = rng.integers(0, 256, size=(600, 8), dtype=np.uint8)
    entry = pir_store.registry().load("db-" + profile, db, profile)
    idx = [0, 5, 599]
    qa, qb = pir.pir_query(idx, 600, rng, profile, device=CPU)
    srv = pir.PirServer(db, profile=profile, device=CPU)
    got = [plans.run_pir(entry, q, device=CPU) for q in (qa, qb)]
    for g, q in zip(got, (qa, qb)):
        np.testing.assert_array_equal(g, srv.answer(q))
    np.testing.assert_array_equal(pir.pir_reconstruct(*got), db[idx])
    stats = pir_store.registry().stats()
    assert (stats["queries"], stats["scans"]) == (6, 2)
    with pytest.raises(ValueError, match="domain"):
        plans.run_pir(entry, port.gen_batch([1], 12, rng, device=CPU)[0], device=CPU)
    pir_store.reset()


@pytest.mark.parametrize("kind", ["compat", "fast", "dcf"])
@pytest.mark.parametrize("K", [3, 5, 0])
def test_run_gen_matches_host_tower(kind, K):
    draw, host = {"compat": (keys._draw_roots, keys._gen_from_roots),
                  "fast": (keys_chacha._draw_roots, keys_chacha._gen_from_roots),
                  "dcf": (keys_chacha._draw_roots, dcf._gen_lt_from_roots)}[kind]
    log_n = 12
    alphas = np.random.default_rng(K).integers(0, 1 << log_n, size=K, dtype=np.uint64)
    roots = draw(K, np.random.default_rng(K + 1))
    got = plans.run_gen(kind, alphas, log_n, *roots, device=CPU)
    want = host(alphas, log_n, *roots)
    for g, w in zip(got, want):
        assert g.to_bytes() == w.to_bytes()


def test_run_points_checks_its_queries():
    ka = port.gen_batch([1, 2], 9, np.random.default_rng(0), device=CPU)[0]
    with pytest.raises(ValueError, match="out of domain"):
        plans.run_points("points", "compat", ka, np.full((2, 1), 512, np.uint64), device=CPU)
    with pytest.raises(ValueError, match=r"\[K, Q\]"):
        plans.run_points("points", "compat", ka, np.zeros((3, 1), np.uint64), device=CPU)
    assert plans.run_points("points", "compat", ka, np.zeros((2, 0), np.uint64),
                            device=CPU).shape == (2, 0)


@pytest.fixture(scope="module")
def reference_points():
    """``dpf_tpu.core.plans.run_points`` compat at log_n 9, K 3, Q 17, as
    tests/test_serving.py runs it: its one compile."""
    from dpf_tpu.core.keys import gen_batch

    rng = np.random.default_rng(21)
    kb, _ = gen_batch(rng.integers(0, 512, size=3, dtype=np.uint64), 9, rng=rng)
    xs = rng.integers(0, 512, size=(3, 17), dtype=np.uint64)
    return kb, xs, ref_plans.run_points("points", "compat", kb, xs)


def test_run_points_matches_reference(reference_points):
    kb, xs, want = reference_points
    ours = interop.from_jax_keybatch(kb.log_n, kb.seeds, kb.ts, kb.scw, kb.tcw, kb.fcw)
    np.testing.assert_array_equal(plans.run_points("points", "compat", ours, xs, device=CPU),
                                  want)


# ---------------------------------------------------------------------------
# Plan bookkeeping (tests/test_serving.py's contracts)
# ---------------------------------------------------------------------------

WARM_SPECS = [
    {"route": "points", "profile": "compat", "log_n": 9, "k": 3, "q": 17},
    {"route": "points", "profile": "fast", "log_n": 10, "k": 5, "q": 33},
    {"route": "dcf_points", "log_n": 11, "k": 3, "q": 33},
    {"route": "dcf_interval", "log_n": 10, "k": 3, "q": 17},
    {"route": "evalfull", "profile": "compat", "log_n": 9, "k": 5},
    {"route": "evalfull", "profile": "fast", "log_n": 10, "k": 3, "stream": True},
    {"route": "hh_level", "profile": "fast", "log_n": 10, "k": 5, "q": 33},
    {"route": "hh_extend", "profile": "compat", "log_n": 9, "k": 3, "q": 64},
    {"route": "hh_fold", "log_n": 0, "k": 5, "q": 64},
    {"route": "agg_xor", "k": 3, "q": 64},
    {"route": "agg_add", "k": 3, "q": 64},
    {"route": "gen", "profile": "dcf", "log_n": 12, "k": 5},
]


def test_warmup_misses_then_hits_and_captures_nothing_on_the_cpu():
    plans.cache().clear()
    first = plans.warmup(WARM_SPECS, device=CPU)
    assert [s["route"] for s in first] == [s["route"] for s in WARM_SPECS]
    stats = plans.cache().stats()
    routes = {p["key"].split("/")[0] for p in stats["plans"]}
    assert {s["route"] for s in WARM_SPECS} <= routes
    assert stats["misses"] == len(stats["plans"])
    misses = stats["misses"]
    plans.warmup(WARM_SPECS, device=CPU)
    stats = plans.cache().stats()
    assert stats["misses"] == misses and stats["hits"] >= len(WARM_SPECS)
    assert plans.capture_count() == 0 and stats["graphs"] == 0
    # Requests inside the warmed buckets are hits.
    _, batches = _batches(9, 4, 3)
    xs = np.zeros((4, 20), np.uint64)
    plans.run_points("points", "compat", batches["compat"][0], xs, device=CPU)
    assert plans.cache().stats()["misses"] == misses
    plans.cache().clear()
    assert plans.cache().stats()["plans"] == []


def test_recent_shapes_excludes_pir_and_hh_extend():
    cache = plans.cache()
    seeded = [
        plans.plan_key("points", "fast", 10, 4, 32),
        plans.plan_key("hh_level", "fast", 12, 8, 64),
        plans.plan_key("agg_xor", "agg", 0, 32, 64 * 32),
        plans.plan_key("hh_extend", "fast", 12, 8, 64, variant="tree32"),
        plans.PlanKey("pir", "fast", 12, 8, 64, True, "off", plans.SBOX, 0),
    ]
    try:
        for i, key in enumerate(seeded):
            plan, _ = cache.get(key)
            plan.last_used = 1e12 + i  # newer than anything else
        shapes = plans.recent_shapes(limit=len(seeded))
        routes = [s["route"] for s in shapes]
        assert "pir" not in routes and "hh_extend" not in routes, shapes
        assert {"points", "hh_level", "agg_xor"} == set(routes), shapes
        for s in shapes:
            assert set(s) <= {"route", "profile", "log_n", "k", "q", "tuned"}
            assert s["tuned"] == "" and s["q"] >= 32
        assert plans.rewarm_recent(limit=len(seeded), device=CPU) == 3
    finally:
        with cache._lock:
            for key in seeded:
                cache._plans.pop(key, None)


@pytest.mark.parametrize("family", ["compat", "fast", "dcf"])
def test_plan_repeat_key_batch_reuses_padding(family):
    kb = _batches(9, 1, 3)[1][family][0]
    p1 = plans._pad_keys(kb, 3)
    assert p1 is plans._pad_keys(kb, 3) and p1.k == 4 and type(p1) is type(kb)
    assert plans._pad_keys(kb, 0) is kb
    assert p1.to_bytes()[0] == kb.to_bytes()[0]
    assert not any(p1.seeds[1:].ravel())


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PRG", "FUSE", "PLAN_KFLOOR", "PIR_CHUNK_ROWS",
                                  "PIR_DB_CHUNK_BYTES"])
def test_knob_defaults_are_the_reference_defaults(name):
    ours, theirs = knobs.knob(f"DPF_CUDA_{name}"), ref_knobs.knob(f"DPF_TPU_{name}")
    assert (ours.kind, ours.default) == (theirs.kind, theirs.default)


def test_knob_overrides_nest_and_unknown_names_raise(monkeypatch):
    monkeypatch.setenv("DPF_CUDA_FUSE", "3")
    assert knobs.get_str("DPF_CUDA_FUSE") == "3"
    with knobs.overrides({"DPF_CUDA_FUSE": "2"}):
        with knobs.overrides({"DPF_CUDA_FUSE": "auto", "DPF_CUDA_PLAN_KFLOOR": "8"}):
            assert knobs.get_str("DPF_CUDA_FUSE") == "auto"
            assert plans.k_bucket(3) == 8
        assert knobs.get_str("DPF_CUDA_FUSE") == "2" and plans.k_bucket(3) == 4
        with knobs.overrides({"DPF_CUDA_FUSE": ""}):  # '' means the default
            assert knobs.get_str("DPF_CUDA_FUSE") == "off"
    assert knobs.get_str("DPF_CUDA_FUSE") == "3"
    for call in (lambda: knobs.get_str("DPF_CUDA_FUZE"),
                 lambda: knobs.overrides({"DPF_TPU_FUSE": "2"}).__enter__()):
        with pytest.raises(KeyError, match="undeclared"):
            call()
    assert knobs.audit_environ({"DPF_CUDA_FUZE": "1", "DPF_CUDA_FUSE": "2",
                                "DPF_TPU_FUSE": "2"}) == ["DPF_CUDA_FUZE"]
    assert knobs.snapshot(["DPF_CUDA_FUSE"]) == {"DPF_CUDA_FUSE": "3"}
    assert knobs.is_set("DPF_CUDA_FUSE") and not knobs.is_set("DPF_CUDA_PRG")
    assert knobs.get_bool("DPF_CUDA_FUSE")


def test_fuse_knob_gives_the_fuse_argument_bytes(monkeypatch):
    # log_n 15, K 32: nu = 8, one fused level from level 7 at g = 2.
    ka, _ = port.gen_batch(np.random.default_rng(8).integers(0, 1 << 15, size=32,
                                                             dtype=np.uint64), 15,
                           np.random.default_rng(9), device=CPU)
    want = md.eval_full(ka, fuse=2, device=CPU)
    seen = []
    real = md._fused_groups
    monkeypatch.setattr(md, "_fused_groups", lambda *a: seen.append(a[6]) or real(*a))
    with knobs.overrides({"DPF_CUDA_FUSE": "2"}):
        assert md._fuse_plan(8, "pallas_bm", None) == (7, (1,))
        np.testing.assert_array_equal(md.eval_full(ka, device=CPU), want)
    assert seen == [(1,)]
    assert md._fuse_plan(8, "pallas_bm", None) is None  # off by default
    with knobs.overrides({"DPF_CUDA_FUSE": "auto"}):
        assert md._fuse_request() == 4
    with knobs.overrides({"DPF_CUDA_FUSE": "two"}), pytest.raises(ValueError, match="FUSE"):
        md._fuse_request()


def test_fuse_knob_takes_the_pir_fuse_route_with_the_same_answers(monkeypatch):
    db = np.random.default_rng(2).integers(0, 256, size=(1 << 15, 4), dtype=np.uint8)
    qa, qb = pir.pir_query([3, 30000], 1 << 15, np.random.default_rng(3), device=CPU)
    srv = pir.PirServer(db, device=CPU)
    want = [srv.answer(q) for q in (qa, qb)]
    seen = []
    real = md._fused_groups
    monkeypatch.setattr(md, "_fused_groups", lambda *a: seen.append(a[6]) or real(*a))
    with knobs.overrides({"DPF_CUDA_FUSE": "2"}):
        got = [srv.answer(q) for q in (qa, qb)]
    assert seen == [(1,), (1,)]  # the fused route ran, once an answer
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pir.pir_reconstruct(*got), db[[3, 30000]])


def test_prg_knob_picks_the_backend_with_the_same_bytes():
    ka, _ = port.gen_batch([5, 300], 10, np.random.default_rng(0), device=CPU)
    want = md.eval_full(ka, device=CPU)
    assert md._resolve_backend(None) == "pallas_bm"
    with knobs.overrides({"DPF_CUDA_PRG": "xla"}):
        assert md._resolve_backend(None) == "xla"
        assert md._resolve_backend("pallas_bm_il") == "pallas_bm_il"  # the keyword wins
        np.testing.assert_array_equal(md.eval_full(ka, device=CPU), want)
        assert plans.run_evalfull("compat", ka, device=CPU).tobytes() == want.tobytes()
    with knobs.overrides({"DPF_CUDA_PRG": "cuda"}), pytest.raises(ValueError, match="unknown"):
        md.eval_full(ka, device=CPU)


# ---------------------------------------------------------------------------
# The PIR store
# ---------------------------------------------------------------------------

NAMES = ["db", "a.b-c_9", "x" * 64, "x" * 65, "", "has space", "slash/no", "ü", "-", "..",
         None]


@pytest.mark.parametrize("name", NAMES, ids=repr)
def test_validate_name_matches_reference(name):
    try:
        want = ref_store.validate_name(name)
    except ValueError:
        with pytest.raises(ValueError):
            pir_store.validate_name(name)
    else:
        assert pir_store.validate_name(name) == want


def test_pir_store_load_get_drop_stats(monkeypatch):
    pir_store.reset()
    reg = pir_store.registry()
    db = np.arange(300 * 8, dtype=np.uint32).astype(np.uint8).reshape(300, 8)
    entry = reg.load("orders", db, "fast")
    assert reg.get("orders") is entry and reg.names() == ["orders"]
    assert (entry.log_n, entry.dom, entry.nu, entry.db_bytes) == (9, 512, 0, 4096)
    assert entry.dispatch_shards() == 0
    srv = entry.server(device=CPU)
    assert entry.server(device=CPU) is srv and srv.profile == "fast"
    with pytest.raises(ValueError, match="mesh"):
        entry.server(2, device=CPU)
    entry.note_scan(7, 1)
    entry.note_scan(1, 3)
    stats = reg.stats()
    assert (stats["dbs_resident"], stats["db_bytes_resident"], stats["queries"],
            stats["scans"], stats["bytes_scanned"]) == (1, 4096, 8, 2, 8192)
    assert stats["scan_chunks"]["counts"][:3] == [1, 0, 1]
    assert stats["resident"][0]["placements"] == [0]
    with pytest.raises(KeyError, match="unknown db"):
        reg.get("nope")
    with pytest.raises(ValueError):
        reg.load("bad name", db)
    assert reg.drop("orders") and not reg.drop("orders")
    for chunk in ("", "0", "1000"):
        monkeypatch.setenv("DPF_CUDA_PIR_DB_CHUNK_BYTES", chunk)
        monkeypatch.setenv("DPF_TPU_PIR_DB_CHUNK_BYTES", chunk)
        assert pir_store.upload_chunk_rows(24) == ref_store.upload_chunk_rows(24)
    pir_store.reset()


def test_warmup_of_a_registered_database():
    pir_store.reset()
    pir_store.registry().load("w", np.zeros((200, 4), np.uint8), "compat")
    out = plans.warmup([{"route": "pir", "db": "w", "k": 3}], device=CPU)
    assert out[0]["k_bucket"] == 4 and out[0]["q_bucket"] == 32
    assert pir_store.registry().stats()["queries"] == 4
    with pytest.raises(KeyError):
        plans.warmup([{"route": "pir", "db": "gone"}], device=CPU)
    pir_store.reset()


# ---------------------------------------------------------------------------
# The apps and the dealer through the plans
# ---------------------------------------------------------------------------


def _route_hits(route: str) -> int:
    return sum(p["hits"] + p["misses"] for p in plans.cache().stats()["plans"]
               if p["key"].split("/")[0] == route)


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_heavy_hitters_go_through_the_plans(profile):
    G, N, planted = 64, 9, np.array([5, 300], np.uint64)
    vals = np.random.default_rng(4).integers(0, 1 << N, size=G, dtype=np.uint64)
    vals[:12], vals[12:24] = planted[0], planted[1]
    sa, sb = hh.gen_shares(vals, N, profile, np.random.default_rng(5), device=CPU)
    results = []
    for state in (True, False):
        before = {r: _route_hits(r) for r in ("hh_level", "hh_extend", "hh_fold")}
        res = hh.find_heavy_hitters(sa, sb, threshold=10, state=state, fold="device",
                                    device=CPU)
        results.append((res.values.tolist(), res.counts.tolist()))
        moved = {r for r in before if _route_hits(r) > before[r]}
        assert moved == ({"hh_extend", "hh_fold"} if state else {"hh_level", "hh_fold"})
    assert results[0] == results[1] == ([5, 300], [12, 12])


def test_aggregation_goes_through_the_plans():
    rows = np.random.default_rng(6).integers(0, 1 << 32, size=(70, 5), dtype=np.uint32)
    before = _route_hits("agg_xor") + _route_hits("agg_add")
    np.testing.assert_array_equal(agg.aggregate_rows(rows, "xor", 30, device=CPU),
                                  np.bitwise_xor.reduce(rows, axis=0))
    np.testing.assert_array_equal(agg.aggregate_rows(rows, "add", 30, device=CPU),
                                  rows.astype(np.uint64).sum(0).astype(np.uint32))
    ka, _ = fast.gen_batch([1, 2, 3], 10, np.random.default_rng(0), device=CPU)
    np.testing.assert_array_equal(agg.aggregate_eval_full(ka, "xor", device=CPU),
                                  np.bitwise_xor.reduce(fast.eval_full_batch(
                                      ka, device=CPU).view("<u4"), axis=0))
    assert _route_hits("agg_xor") + _route_hits("agg_add") == before + 3 + 3 + 1


@pytest.mark.parametrize("entry", ["gen_batch", "fast.gen_batch", "dcf_gen_lt_batch",
                                   "pir_query", "gen_shares"])
def test_gens_on_the_card_go_through_run_gen(monkeypatch, entry):
    # Without a card, run_gen is swapped for one that records the call and
    # deals on the CPU: the entry points' card route reaches it, with the
    # host tower's bytes.
    seen = []
    real = plans.run_gen

    def run_gen(kind, *args, device=None):
        seen.append((kind, str(device)))
        return real(kind, *args, device=CPU)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(plans, "run_gen", run_gen)
    call, kind = {
        "gen_batch": (lambda **kw: port.gen_batch([5, 9], 8, np.random.default_rng(0), **kw),
                      "compat"),
        "fast.gen_batch": (lambda **kw: fast.gen_batch([5, 9], 12, np.random.default_rng(0),
                                                       **kw), "fast"),
        "dcf_gen_lt_batch": (lambda **kw: fast.dcf_gen_lt_batch(
            [3, 5], 8, np.random.default_rng(0), **kw), "dcf"),
        "pir_query": (lambda **kw: pir.pir_query([1, 7], 100, np.random.default_rng(0),
                                                 **kw), "compat"),
        "gen_shares": (lambda **kw: hh.gen_shares([3, 5, 5], 8, "fast",
                                                  np.random.default_rng(0), **kw), "fast"),
    }[entry]
    got = call()
    assert seen == [(kind, "cuda")]
    want = call(device=CPU)  # the host tower: run_gen is not called
    assert len(seen) == 1
    if entry == "gen_shares":
        got, want = [s.levels for s in got], [s.levels for s in want]
    assert [k.to_bytes() for k in got] == [k.to_bytes() for k in want]


def test_keys_gen_warm_makes_the_gen_plan(monkeypatch):
    seen = []
    monkeypatch.setattr(plans, "run_gen", lambda kind, a, log_n, *r, device=None:
                        seen.append((kind, a.shape[0], log_n, r[0].shape[0], device)))
    keys_gen.warm("dcf", 12, 4, np.random.default_rng(0), device=CPU)
    assert seen == [("dcf", 4, 12, 4, CPU)]
    with pytest.raises(ValueError, match="unknown kind"):
        keys_gen.warm("aes", 12, 4, np.random.default_rng(0))
