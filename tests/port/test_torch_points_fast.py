"""The port's fast-profile pointwise Eval (dpf_tpu_torch.fast.eval_points_batch
and the model's eval_points_level_grouped) against dpf_tpu.fast and the numpy
spec.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Keys
and queries come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where the walk wrapper runs its plain PyTorch version.  Each
JAX reference runs once per module: the XLA route at log_n 8 and 14 (one
batch of 17 keys each; the 9-key cases are its first rows), and the Pallas
walk kernel in interpret mode at log_n = 34 (the high index word; its XLA
route takes 11 s to compile there, the kernel 3.5 s) and on a level-grouped
batch, 128 keys each.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu import fast as ref_fast  # noqa: E402
from dpf_tpu.core import bitpack as ref_bitpack  # noqa: E402
from dpf_tpu.core import chacha_np as ref_cc  # noqa: E402
from dpf_tpu.models.keys_chacha import gen_batch as ref_gen_batch  # noqa: E402
from dpf_tpu.ops import chacha_pallas  # noqa: E402

from dpf_tpu_torch import fast  # noqa: E402
from dpf_tpu_torch.interop import from_jax_keybatch_fast  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as mdc  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier  # noqa: E402

REF_LOG_N = (8, 14)
REF_K, REF_Q = 17, 13


def _to_port(kb):
    return from_jax_keybatch_fast(kb.log_n, kb.seeds, kb.ts, kb.scw, kb.tcw, kb.fcw)


def _spec_bits(kb, xs):
    blobs = kb.to_bytes()
    return np.array(
        [[ref_cc.eval_point(blobs[i], int(x), kb.log_n) for x in row]
         for i, row in enumerate(xs)],
        dtype=np.uint8,
    ).reshape(xs.shape)


@pytest.fixture(scope="module")
def jax_points():
    """``dpf_tpu.fast.eval_points_batch`` (XLA on the CPU) at each REF_LOG_N,
    17 keys and 13 queries, xs[:, 0] = alphas: {log_n: (kb, xs, bits)}."""
    out = {}
    for log_n in REF_LOG_N:
        rng = np.random.default_rng(log_n)
        alphas = rng.integers(0, 1 << log_n, size=REF_K, dtype=np.uint64)
        kb, _ = ref_gen_batch(alphas, log_n, rng=rng)
        xs = rng.integers(0, 1 << log_n, size=(REF_K, REF_Q), dtype=np.uint64)
        xs[:, 0] = alphas
        out[log_n] = (kb, xs, ref_fast.eval_points_batch(kb, xs))
    return out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("K", [9, 17])
@pytest.mark.parametrize("log_n", REF_LOG_N)
def test_eval_points_batch_matches_reference(jax_points, log_n, K, packed):
    kb, xs, want = jax_points[log_n]
    kb = _to_port(kb)
    if K < REF_K:
        kb = fast.KeyBatchFast.from_bytes(kb.to_bytes()[:K], log_n)
    got = fast.eval_points_batch(kb, xs[:K], packed=packed, device="cpu")
    if packed:
        assert got.shape == (K, 1) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want[:K]))
    else:
        assert got.shape == (K, REF_Q) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[:K])


@pytest.fixture(scope="module")
def jax_walk34():
    """``chacha_pallas.eval_points_walk`` in interpret mode at log_n = 34,
    128 keys and 8 queries, xs[:, 0] = alphas."""
    rng = np.random.default_rng(34)
    log_n, K, Q = 34, 128, 8
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    kb, _ = ref_gen_batch(alphas, log_n, rng=rng)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    return kb, xs, chacha_pallas.eval_points_walk(kb, xs)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("K", [9, 128])
def test_eval_points_batch_matches_pallas_walk_high_word(jax_walk34, K, packed):
    kb, xs, want = jax_walk34
    kb = fast.KeyBatchFast.from_bytes(kb.to_bytes()[:K], kb.log_n)
    got = fast.eval_points_batch(kb, xs[:K], packed=packed, device="cpu")
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want[:K]) if packed else want[:K])


@pytest.mark.parametrize("log_n,K,Q", [(3, 2, 5), (9, 3, 33), (10, 1, 1), (20, 4, 7),
                                       (34, 2, 4)])
def test_eval_points_batch_matches_spec(log_n, K, Q):
    # nu = 0 (log_n <= 9), the first level, and the high index word.
    rng = np.random.default_rng(100 + log_n)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, kb = fast.gen_batch(alphas, log_n, rng, device="cpu")
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    got = fast.eval_points_batch(ka, xs, device="cpu")
    np.testing.assert_array_equal(got, _spec_bits(ka, xs))
    rec = got ^ fast.eval_points_batch(kb, xs, device="cpu")
    np.testing.assert_array_equal(rec, (xs == alphas[:, None]).astype(np.uint8))
    np.testing.assert_array_equal(fast.eval_points_batch(ka, xs, packed=True, device="cpu"),
                                  ref_bitpack.pack_bits(got))


# ---------------------------------------------------------------------------
# Level-grouped: against the Pallas walk kernel (interpret mode), once
# ---------------------------------------------------------------------------

GROUPED = dict(log_n=16, G=4, groups=2, Q=13)  # K = 2 * 16 * 4 = 128


@pytest.fixture(scope="module")
def jax_grouped():
    """``chacha_pallas.eval_points_walk`` in interpret mode on a
    level-grouped batch (the shape of tests/test_chacha_pallas.py), reduced
    and packed on the device."""
    n, G, groups, Q = (GROUPED[k] for k in ("log_n", "G", "groups", "Q"))
    rng = np.random.default_rng(16)
    kb, _ = ref_gen_batch(rng.integers(0, 1 << n, size=groups * n * G, dtype=np.uint64),
                          n, rng=rng)
    xs = rng.integers(0, 1 << n, size=(G, Q), dtype=np.uint64)
    words = chacha_pallas.eval_points_walk(kb, xs, groups=groups, reduce=True, packed=True)
    return kb, xs, words


def test_level_grouped_matches_pallas_walk(jax_grouped):
    kb, xs, want = jax_grouped
    got = mdc.eval_points_level_grouped(_to_port(kb), xs, GROUPED["groups"], reduce=True,
                                        packed=True, device="cpu")
    assert got.shape == want.shape == (GROUPED["G"], 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("groups", [0, 2])
def test_walk_operands_match_jax(jax_grouped, groups):
    kb = jax_grouped[0]
    want = chacha_pallas.walk_operands(kb, groups)
    got = chacha_cuda.walk_operands(_to_port(kb), groups, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(from_carrier(g), np.asarray(w))


def _grouped_spec(kb, xs, groups, levels):
    """Spec bits of a level-grouped batch at its masked queries."""
    n = kb.log_n
    lv = list(levels) if levels is not None else list(range(n))
    rows = []
    for b in range(groups * len(lv)):
        s = np.uint64(n - 1 - lv[b % len(lv)])
        rows.append((xs >> s) << s)
    return _spec_bits(kb, np.concatenate(rows))


@functools.cache
def _grouped_case(log_n, G, Q, groups, levels):
    """(keys, raw gate queries, spec bits at the masked queries)."""
    rng = np.random.default_rng(log_n + G)
    K = groups * (log_n if levels is None else len(levels)) * G
    kb, _ = fast.gen_batch(rng.integers(0, 1 << log_n, size=K, dtype=np.uint64), log_n, rng, device="cpu")
    xs = rng.integers(0, 1 << log_n, size=(G, Q), dtype=np.uint64)
    return kb, xs, _grouped_spec(kb, xs, groups, levels)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("log_n,G,Q,groups,levels", [
    (11, 2, 5, 1, None), (6, 1, 3, 2, None), (34, 2, 3, 1, (0, 25, 33)),
    (12, 3, 4, 2, (3, 11)),
])
def test_level_grouped_matches_spec(log_n, G, Q, groups, levels, packed):
    kb, xs, want = _grouped_case(log_n, G, Q, groups, levels)
    n_lv = log_n if levels is None else len(levels)
    fold = np.bitwise_xor.reduce(want.reshape(groups * n_lv, G, Q), axis=0)
    for reduce, rows in ((False, want), (True, fold)):
        got = mdc.eval_points_level_grouped(kb, xs, groups, reduce=reduce, packed=packed,
                                            levels=levels, device="cpu")
        np.testing.assert_array_equal(got, ref_bitpack.pack_bits(rows) if packed else rows)


def test_fast_eval_points_rejects_bad_queries():
    kb, _ = fast.gen_batch([3, 5], 12, np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError, match="out of domain"):
        fast.eval_points_batch(kb, np.array([[1], [4096]], np.uint64), device="cpu")
    with pytest.raises(ValueError, match=r"\[K, Q\]"):
        fast.eval_points_batch(kb, np.zeros((3, 2), np.uint64), device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        chacha_cuda.eval_points_walk(kb, np.zeros((2, 2), np.uint64), reduce=True,
                                     device="cpu")


# ---------------------------------------------------------------------------
# Empty batches (ROADMAP C.2) and the reference's signatures (C.3)
# ---------------------------------------------------------------------------


def _empty_call(ref, case, packed):
    """One empty-batch call at log_n 8 on keys from default_rng(0): alphas
    [3, 5] with xs uint64[2, 0]; no alphas with xs uint64[0, 4]; a grouped
    batch of 2 gates (16 keys) with Q 0, in full and reduced."""
    gen = ref_gen_batch if ref else fast.gen_batch
    kw = {} if ref else {"device": "cpu"}
    if case in ("Q0", "K0"):
        alphas = np.array([3, 5] if case == "Q0" else [], np.uint64)
        kb, _ = gen(alphas, 8, rng=np.random.default_rng(0), **kw)
        xs = np.zeros((2, 0) if case == "Q0" else (0, 4), np.uint64)
        return (ref_fast if ref else fast).eval_points_batch(kb, xs, packed=packed, **kw)
    from dpf_tpu.models import dpf_chacha as ref_mdc

    kb, _ = gen(np.arange(16, dtype=np.uint64), 8, rng=np.random.default_rng(0), **kw)
    return (ref_mdc if ref else mdc).eval_points_level_grouped(
        kb, np.zeros((2, 0), np.uint64), 1, reduce=case == "grouped_reduced",
        packed=packed, **kw)


EMPTY_SHAPES = {"Q0": (2, 0), "K0": (0, 4), "grouped": (16, 0), "grouped_reduced": (2, 0)}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", list(EMPTY_SHAPES))
def test_empty_batches_match_reference(monkeypatch, case, packed):
    want = _empty_call(True, case, packed)
    # Neither the operands nor the walk are reached, on any device.
    monkeypatch.setattr(chacha_cuda, "walk_args", None)
    got = _empty_call(False, case, packed)
    rows, q = EMPTY_SHAPES[case]
    assert got.shape == want.shape == ((rows, -(-q // 32)) if packed else (rows, q))
    assert got.dtype == want.dtype == (np.uint32 if packed else np.uint8)
    np.testing.assert_array_equal(got, want)


def test_eval_points_batch_takes_backend_third():
    # eval_points_batch(kb, xs, "cpu") is the host route, as in the reference;
    # "cpu" is not read as ``packed``.
    xs = np.array([[3, 4, 5], [5, 6, 7]], np.uint64)
    ka, _ = fast.gen_batch([3, 5], 8, np.random.default_rng(0), device="cpu")
    ra, _ = ref_gen_batch(np.array([3, 5], np.uint64), 8, rng=np.random.default_rng(0))
    got = fast.eval_points_batch(ka, xs, "cpu")
    want = ref_fast.eval_points_batch(ra, xs, "cpu")
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 1, 0], [1, 1, 0]])
    np.testing.assert_array_equal(fast.eval_points_batch(ka, xs, "cpu", True),
                                  ref_bitpack.pack_bits(want))


def _params(fn):
    """(name, default) of each parameter but ``**kwargs``, in order."""
    import inspect

    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.kind is not p.VAR_KEYWORD]


ENTRIES = ["Gen", "Eval", "EvalFull", "gen_batch", "eval_full_batch", "eval_points_batch"]


@pytest.mark.parametrize("profile", ["compat", "fast"])
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_signatures_follow_the_reference(profile, name):
    import dpf_tpu
    import dpf_tpu_torch

    ref, got = ((dpf_tpu, dpf_tpu_torch) if profile == "compat" else (ref_fast, fast))
    want = _params(getattr(ref, name))
    have = _params(getattr(got, name))
    assert have[: len(want)] == want
    assert [n for n, _ in have[len(want):]] in ([], ["device"])


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_eval_backend_routes(profile):
    # "auto" and "cpu" stay on the host; another backend walks on ``device``;
    # EvalFull's "cpu" is the host spec.
    import dpf_tpu_torch

    api = dpf_tpu_torch if profile == "compat" else fast
    ka, kb = api.Gen(77, 12, np.random.default_rng(1))
    for x in (76, 77, 78):
        host = api.Eval(ka, x, 12)
        assert api.Eval(ka, x, 12, "cpu") == host
        assert api.Eval(ka, x, 12, "jax", device="cpu") == host
        assert host ^ api.Eval(kb, x, 12, backend="jax", device="cpu") == int(x == 77)
    assert api.EvalFull(ka, 12, "cpu") == api.EvalFull(ka, 12, device="cpu")
