"""The port's fast-profile Gen -> EvalFull slice (dpf_tpu_torch.fast) as a
whole, against dpf_tpu.fast and the numpy spec.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Keys
come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where its kernel wrappers run their plain PyTorch versions
along the card's routes (prefix groups, tail, chunks).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu import fast as ref_fast  # noqa: E402
from dpf_tpu_torch import fast  # noqa: E402
from dpf_tpu_torch.core import chacha_np as cc  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as dc  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda as cp  # noqa: E402

REF_CASES = [(8, 3), (14, 5), (17, 3), (20, 8)]


def _batch(log_n, K, seed):
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    return alphas, fast.gen_batch(alphas, log_n, rng, device="cpu")


def _spec_rows(kb):
    return np.stack(
        [np.frombuffer(cc.eval_full(k, kb.log_n), np.uint8) for k in kb.to_bytes()]
    )


@pytest.fixture(scope="module")
def reference_outputs():
    """dpf_tpu.fast.eval_full_batch (XLA on the CPU) at each REF_CASES
    configuration, run once: {(log_n, K): (key bytes, output)}."""
    out = {}
    for log_n, K in REF_CASES:
        rng = np.random.default_rng(log_n * 10 + K)
        alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
        ka, _ = ref_fast.gen_batch(alphas, log_n, rng)
        out[(log_n, K)] = (ka.to_bytes(), ref_fast.eval_full_batch(ka))
    return out


@pytest.mark.parametrize("log_n,K", REF_CASES)
def test_eval_full_batch_matches_reference(reference_outputs, log_n, K):
    keys, want = reference_outputs[(log_n, K)]
    kb = fast.KeyBatchFast.from_bytes(keys, log_n)
    got = fast.eval_full_batch(kb, device="cpu")
    assert got.shape == (K, max(1 << (log_n - 3), 64)) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n,K", [(3, 2), (9, 3), (10, 1), (12, 9), (15, 4), (16, 17)])
def test_eval_full_batch_matches_spec(log_n, K):
    # Whole-tree (nu < 7, nu = 0), classic and padded-key cases.
    _, (ka, _) = _batch(log_n, K, seed=log_n + K)
    np.testing.assert_array_equal(fast.eval_full_batch(ka, device="cpu"), _spec_rows(ka))


@pytest.mark.parametrize("log_n,K", [(12, 3), (18, 5), (20, 8)])
def test_shares_reconstruct_at_alpha(log_n, K):
    alphas, (ka, kb) = _batch(log_n, K, seed=log_n)
    rec = fast.eval_full_batch(ka, device="cpu") ^ fast.eval_full_batch(kb, device="cpu")
    bits = np.unpackbits(rec, axis=1, bitorder="little")
    for row, alpha in zip(bits, alphas):
        assert np.flatnonzero(row).tolist() == [int(alpha)]


@pytest.mark.parametrize("log_n,K,cap", [(17, 3, 1 << 10), (18, 8, 1 << 11), (20, 2, 1 << 12)])
def test_chunked_equals_unchunked(log_n, K, cap):
    _, (ka, _) = _batch(log_n, K, seed=cap)
    ok, entry, kp, n_chunks = cp.expand_plan_chunked(ka.nu, K, cap)
    assert ok and n_chunks > 1 and not cp.expand_plan(ka.nu, K, cap)[0]
    np.testing.assert_array_equal(
        fast.eval_full_batch(ka, device="cpu", max_leaf_nodes=cap),
        fast.eval_full_batch(ka, device="cpu"),
    )


@pytest.mark.parametrize("log_n,K", [(22, 2), (23, 1)])
def test_deep_tree_plain_matches_spec(log_n, K):
    # nu = 13 and 14: deeper than the whole-tree route's 12 levels, where the
    # JAX fused schedule runs mid groups; here a prefix of 5 + 3 or 5 + 4.
    _, (ka, _) = _batch(log_n, K, seed=log_n)
    got = fast.eval_full_batch(ka, device="cpu", impl="plain")
    np.testing.assert_array_equal(got, _spec_rows(ka))


def test_routes_launch_nothing_on_the_cpu():
    _, (ka, _) = _batch(20, 3, seed=1)
    before = (cp.fused_levels.launches, cp.expand_tail.launches)
    fast.eval_full_batch(ka, device="cpu")
    assert (cp.fused_levels.launches, cp.expand_tail.launches) == before


def _route_calls(monkeypatch, log_n, **kwargs):
    """The (launch, entry width, levels) of each kernel call of one fast
    evaluation of 8 keys (``kwargs`` to ``eval_full_batch``), with
    stand-ins for the kernels."""
    calls = []

    def fused(state, scw, tcw):
        calls.append(("fused", state.shape[2], scw.shape[1]))
        return state.new_zeros((5, state.shape[1], state.shape[2] << scw.shape[1]))

    def tail(state, scw, tcw, fcw, out=None):
        calls.append(("tail", state.shape[2], scw.shape[1]))
        shape = (state.shape[1], state.shape[2] << scw.shape[1], 16)
        return state.new_zeros(shape) if out is None else out

    monkeypatch.setitem(dc._IMPLS, None, (fused, tail))
    _, (ka, _) = _batch(log_n, 8, seed=3)
    fast.eval_full_batch(ka, device="cpu", **kwargs)
    return calls


def test_route_schedule_at_the_headline(monkeypatch):
    # n=20: fused prefix groups of 5 + 2 levels from the root, then a tail of 4.
    want = [("fused", 1, 5), ("fused", 32, 2), ("tail", 128, 4)]
    assert _route_calls(monkeypatch, 20) == want


@pytest.mark.parametrize("log_n,want", [
    (9, [("tail", 1, 0)]),  # nu = 0: one leaf convert
    (14, [("tail", 1, 5)]),  # nu = 5: the whole-tree route
    (16, [("fused", 1, 5), ("fused", 32, 2), ("tail", 128, 0)]),
    (22, [("fused", 1, 5), ("fused", 32, 3), ("tail", 256, 5)]),
    (24, [("fused", 1, 5), ("fused", 32, 5), ("tail", 1024, 5)]),
])
def test_route_schedule(monkeypatch, log_n, want):
    # Fused prefix groups of at most 5 levels from the root up to the JAX
    # plan's entry level, then one tail; deep trees (nu > 12) the same way.
    assert _route_calls(monkeypatch, log_n) == want


# ROADMAP C.5: configurations where neither the classic or whole-tree plan
# nor the chunked plan fits, which raised "no kernel route" before the
# subtree route.  (15, 9, 1000): 16 padded keys, 2 chunks, c = 1; (17, 1,
# 512): nu = 8, c = 2, so an in-chunk fused group runs before the tail.
SUBTREE_CASES = [(14, 3, 16), (12, 9, 16), (10, 1, 1), (12, 8, 8), (15, 9, 1000),
                 (17, 1, 512)]


@pytest.mark.parametrize("log_n,K,cap", SUBTREE_CASES)
def test_subtree_route_matches_spec(log_n, K, cap):
    _, (ka, _) = _batch(log_n, K, seed=log_n + K)
    assert not cp.expand_plan(ka.nu, K, cap)[0] and not cp.expand_plan_chunked(ka.nu, K, cap)[0]
    got = fast.eval_full_batch(ka, device="cpu", max_leaf_nodes=cap)
    np.testing.assert_array_equal(got, _spec_rows(ka))


def test_subtree_route_matches_reference():
    # The JAX package's XLA chunk route on the CPU (no Pallas kernel runs).
    from dpf_tpu.models import dpf_chacha as ref_dc

    ka, _ = fast.gen_batch(np.array([3, 5, 700], np.uint64), 14, np.random.default_rng(0), device="cpu")
    want = ref_dc.eval_full(ref_fast.KeyBatchFast.from_bytes(ka.to_bytes(), 14), 16,
                            backend="xla")
    np.testing.assert_array_equal(fast.eval_full_batch(ka, device="cpu", max_leaf_nodes=16),
                                  want)


@pytest.mark.parametrize("nu,K,cap,n_chunks,c", [
    (20, 1024, 1 << 23, 128, 7), (13, 65536, 1 << 23, 64, 6), (6, 131073, 1 << 23, 2, 1),
    (6, 9, 1000, 2, 1), (8, 1, 512, 4, 2), (1, 1, 1, 16, 1), (8, 4, 16, 128, 7),
    (14, 8, 64, 2048, 11),
])
def test_subtree_plan_launches_at_most_five_levels(nu, K, cap, n_chunks, c):
    # A pure plan: neither other plan fits, the chunks are the reference's
    # (ceil(padded K 2^nu / cap), c = min(bit_length(n_chunks - 1), nu)),
    # the levels add up to nu, and no launch runs more than five.
    assert not cp.expand_plan(nu, K, cap)[0] and not cp.expand_plan_chunked(nu, K, cap)[0]
    plan = cp.expand_plan_subtrees(nu, K, cap)
    assert (plan.n_chunks, plan.c) == (n_chunks, c)
    assert sum(plan.prefix) == plan.c and plan.entry + plan.tail == nu
    assert plan.entry == max(c, nu - 5)
    assert max(plan.prefix + plan.groups + [plan.tail]) <= cp.fuse_auto_levels() == 5


def test_subtree_route_schedule(monkeypatch):
    # n=17 (nu = 8), 8 keys under a cap of 512 leaves: the prefix to level 2,
    # then each of its 4 subtrees (W = 1) as one fused level and a 5-level tail.
    want = [("fused", 1, 2)] + [("fused", 1, 1), ("tail", 2, 5)] * 4
    assert _route_calls(monkeypatch, 17, max_leaf_nodes=512) == want


def test_scalar_api():
    ka, kb = fast.Gen(777, 14, np.random.default_rng(5))
    assert len(ka) == fast.key_len(14)
    full = fast.EvalFull(ka, 14, device="cpu")
    assert full == cc.eval_full(ka, 14)
    bits = np.unpackbits(np.frombuffer(full, np.uint8), bitorder="little")
    for x in (0, 776, 777, 16383):
        assert fast.Eval(ka, x, 14) == bits[x]
        assert fast.Eval(ka, x, 14) ^ fast.Eval(kb, x, 14) == int(x == 777)


@pytest.mark.parametrize("bad", [dict(impl="triton"), dict(impl="cuda")])
def test_eval_full_device_rejects_bad_options(bad):
    _, (ka, _) = _batch(10, 1, seed=0)
    with pytest.raises(ValueError):
        dc.eval_full_device(dc.DeviceKeysFast(ka, "cpu"), **bad)
