"""The port's DCF (dpf_tpu_torch.models.dcf and the fast.dcf_* entries)
against dpf_tpu.models.dcf, its Pallas walk kernel and the numpy oracle.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Gates
and queries come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where the walk wrapper runs its plain PyTorch version.  Each
JAX reference runs once per module: the XLA route of ``eval_lt_points`` at
log_n 5 (nu = 0) and 13 (7 gates, 37 queries, not a multiple of 32), its
interval gates at log_n 13, and the Pallas DCF walk kernel in interpret mode
at log_n 34 (the high index word; 128 keys, its quantum), where the XLA
route takes 11 s to compile.
"""

import hashlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu import fast as ref_fast  # noqa: E402
from dpf_tpu.core import bitpack as ref_bitpack  # noqa: E402
from dpf_tpu.models import dcf as ref_dcf  # noqa: E402
from dpf_tpu.ops import chacha_pallas  # noqa: E402

from dpf_tpu_torch import fast  # noqa: E402
from dpf_tpu_torch.interop import from_jax_dcfkeybatch  # noqa: E402
from dpf_tpu_torch.models import dcf  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda, op_count  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier  # noqa: E402

K, Q = 7, 37
XLA_LOG_N = (5, 13)


def _to_port(kb):
    return from_jax_dcfkeybatch(kb.log_n, kb.seeds, kb.ts, kb.scw, kb.tcw, kb.vcw, kb.fvcw)


def _gates(log_n, k, q, seed):
    """(alphas with a never-true and an all-but-max gate, xs with each
    alpha and the point below it)."""
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=k, dtype=np.uint64)
    alphas[0] = 0
    if k > 1:
        alphas[1] = (1 << log_n) - 1
    xs = rng.integers(0, 1 << log_n, size=(k, q), dtype=np.uint64)
    xs[:, 0] = alphas
    xs[:, 1] = np.maximum(alphas, np.uint64(1)) - np.uint64(1)
    return alphas, xs


@pytest.fixture(scope="module")
def jax_lt():
    """``dpf_tpu.models.dcf``: keys of both parties from default_rng(log_n)
    and party A's shares through the XLA route, at each XLA_LOG_N:
    {log_n: (ka, kb, alphas, xs, bits)}."""
    out = {}
    for log_n in XLA_LOG_N:
        alphas, xs = _gates(log_n, K, Q, seed=log_n)
        ka, kb = ref_dcf.gen_lt_batch(alphas, log_n, rng=np.random.default_rng(log_n))
        out[log_n] = (ka, kb, alphas, xs, ref_dcf.eval_lt_points(ka, xs))
    return out


@pytest.mark.parametrize("log_n", XLA_LOG_N + (34,))
def test_gen_lt_batch_key_bytes_match_reference(log_n):
    alphas, _ = _gates(log_n, K, 2, seed=log_n)
    want = ref_dcf.gen_lt_batch(alphas, log_n, rng=np.random.default_rng(log_n))
    got = fast.dcf_gen_lt_batch(alphas, log_n, np.random.default_rng(log_n))
    for g, w in zip(got, want):
        assert g.to_bytes() == w.to_bytes()
        assert all(len(b) == fast.dcf_key_len(log_n) == ref_dcf.key_len(log_n)
                   for b in g.to_bytes())


# The widths at which the sweep below also runs the plain walk (some 0.2 s
# each): both ends of the leaf-only tree, the first tree with a level, the
# index word boundary and the widest domain.  The walk meets the JAX
# package at 5, 13 and 34 in the tests further down.
WALK_WIDTHS = (1, 9, 10, 32, 33, 63)


@pytest.mark.parametrize("log_n", range(1, 64))
def test_every_domain_width_matches_reference(log_n):
    # Every width the codec takes: the leaf-only tree (log_n <= 9, nu = 0),
    # the index word boundary (32, 33) and the widest domain (63).
    alphas, xs = _gates(log_n, 3, 4, seed=log_n)
    want = ref_dcf.gen_lt_batch(alphas, log_n, rng=np.random.default_rng(log_n))
    got = dcf.gen_lt_batch(alphas, log_n, np.random.default_rng(log_n))
    assert [g.to_bytes() for g in got] == [w.to_bytes() for w in want]
    assert len(got[0].to_bytes()[0]) == dcf.key_len(log_n) == ref_dcf.key_len(log_n)
    bits = [dcf.eval_points_np(g, xs) for g in got]
    np.testing.assert_array_equal(bits[0], ref_dcf.eval_points_np(want[0], xs))
    np.testing.assert_array_equal(bits[0] ^ bits[1], (xs < alphas[:, None]).astype(np.uint8))
    if log_n in WALK_WIDTHS:
        np.testing.assert_array_equal(dcf.eval_lt_points(got[0], xs, device="cpu"), bits[0])


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("log_n", XLA_LOG_N)
def test_eval_lt_points_matches_reference(jax_lt, log_n, k, packed):
    ka, _, _, xs, want = jax_lt[log_n]
    kb = dcf.DcfKeyBatch.from_bytes(ka.to_bytes()[:k], log_n)
    got = fast.dcf_eval_lt_points(kb, xs[:k], packed=packed, device="cpu")
    if packed:
        assert got.shape == (k, 2) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want[:k]))
    else:
        assert got.shape == (k, Q) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[:k])


@pytest.mark.parametrize("log_n", XLA_LOG_N)
def test_shares_reconstruct_the_comparison(jax_lt, log_n):
    ka, kb, alphas, xs, _ = jax_lt[log_n]
    a = dcf.eval_lt_points(_to_port(ka), xs, device="cpu")
    b = dcf.eval_lt_points(_to_port(kb), xs, device="cpu")
    np.testing.assert_array_equal(a ^ b, xs < alphas[:, None])
    np.testing.assert_array_equal(a, dcf.eval_points_np(_to_port(ka), xs))


def test_packed_xor_reconstructs_on_words(jax_lt):
    ka, kb, alphas, xs, _ = jax_lt[13]
    wa = dcf.eval_lt_points(_to_port(ka), xs, packed=True, device="cpu")
    wb = dcf.eval_lt_points(_to_port(kb), xs, packed=True, device="cpu")
    np.testing.assert_array_equal(wa ^ wb, ref_bitpack.pack_bits(xs < alphas[:, None]))


# ---------------------------------------------------------------------------
# The high index word: against the Pallas DCF walk kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_walk34():
    """``chacha_pallas.eval_points_walk_dcf`` in interpret mode at log_n 34,
    128 keys and 37 queries, with its operands."""
    alphas, xs = _gates(34, 128, Q, seed=34)
    ka, kb = ref_dcf.gen_lt_batch(alphas, 34, rng=np.random.default_rng(34))
    return ka, kb, alphas, xs, chacha_pallas.eval_points_walk_dcf(ka, xs)


def test_walk_dcf_plain_matches_pallas_kernel(jax_walk34):
    ka, _, _, xs, want = jax_walk34
    args = chacha_cuda.dcf_walk_args(_to_port(ka), xs)
    before = chacha_cuda.walk_dcf.launches
    got = chacha_cuda.walk_dcf(*args)  # CPU tensors: the plain version, no launch
    assert chacha_cuda.walk_dcf.launches == before
    np.testing.assert_array_equal(from_carrier(got).T, want)


def test_dcf_walk_operands_match_jax(jax_walk34):
    ka = jax_walk34[0]
    for got, want in zip(chacha_cuda.dcf_walk_operands(_to_port(ka)),
                         chacha_pallas.dcf_walk_operands(ka)):
        np.testing.assert_array_equal(from_carrier(got), np.asarray(want))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 9])
def test_eval_lt_points_high_word_matches_pallas(jax_walk34, k, packed):
    ka, kb, alphas, xs, want = jax_walk34
    port_a = dcf.DcfKeyBatch.from_bytes(ka.to_bytes()[:k], 34)
    got = dcf.eval_lt_points(port_a, xs[:k], packed=packed, device="cpu")
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want[:k]) if packed else want[:k])
    port_b = dcf.DcfKeyBatch.from_bytes(kb.to_bytes()[:k], 34)
    rec = got ^ dcf.eval_lt_points(port_b, xs[:k], packed=packed, device="cpu")
    lt = xs[:k] < alphas[:k, None]
    np.testing.assert_array_equal(rec, ref_bitpack.pack_bits(lt) if packed else lt)


# ---------------------------------------------------------------------------
# Interval gates
# ---------------------------------------------------------------------------

IV_LOG_N = 13


@pytest.fixture(scope="module")
def jax_interval():
    """``dpf_tpu.models.dcf`` interval gates at log_n 13 (the wrap edge
    hi = 2^n - 1, a one-point interval, the whole domain), party A's shares
    through the XLA route."""
    top = (1 << IV_LOG_N) - 1
    lo = np.array([0, 100, 4095, 17, 8000], np.uint64)
    hi = np.array([top, 5000, 4095, 17, top], np.uint64)
    rng = np.random.default_rng(7)
    xs = rng.integers(0, 1 << IV_LOG_N, size=(5, Q), dtype=np.uint64)
    xs[:, 0], xs[:, 1], xs[:, 2] = lo, hi, np.maximum(lo, np.uint64(1)) - np.uint64(1)
    ia, ib = ref_dcf.gen_interval_batch(lo, hi, IV_LOG_N, rng=np.random.default_rng(8))
    return lo, hi, xs, ia, ib, ref_dcf.eval_interval_points(ia, xs)


def test_gen_interval_batch_matches_reference(jax_interval):
    lo, hi, _, ia, ib, _ = jax_interval
    got = fast.dcf_gen_interval_batch(lo, hi, IV_LOG_N, np.random.default_rng(8))
    for g, w in zip(got, (ia, ib)):
        assert g[0].to_bytes() == w[0].to_bytes() and g[1].to_bytes() == w[1].to_bytes()
        np.testing.assert_array_equal(g[2], w[2])


def _port_triple(t):
    return _to_port(t[0]), _to_port(t[1]), t[2].copy()


@pytest.mark.parametrize("packed", [False, True])
def test_eval_interval_points_matches_reference(jax_interval, packed):
    lo, hi, xs, ia, ib, want = jax_interval
    pa, pb = _port_triple(ia), _port_triple(ib)
    got = fast.dcf_eval_interval_points(pa, xs, packed=packed, device="cpu")
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want) if packed else want)
    rec = got ^ fast.dcf_eval_interval_points(pb, xs, packed=packed, device="cpu")
    inside = (lo[:, None] <= xs) & (xs <= hi[:, None])
    np.testing.assert_array_equal(rec, ref_bitpack.pack_bits(inside) if packed else inside)


def test_interval_memo_is_keyed_on_the_pair(jax_interval):
    lo, hi, xs, ia, _, _ = jax_interval
    upper, lower, const = _port_triple(ia)
    first = dcf.eval_interval_points((upper, lower, const), xs, device="cpu")
    both = upper._both[2]
    assert both.k == 2 * upper.k
    assert dcf.eval_interval_points((upper, lower, const), xs, device="cpu") is not None
    assert upper._both[2] is both  # reused for the same lower half
    other = dcf.DcfKeyBatch.from_bytes(upper.to_bytes(), IV_LOG_N)  # a different lower
    got = dcf.eval_interval_points((upper, other, const), xs, device="cpu")
    assert upper._both[1] is other and upper._both[2] is not both
    np.testing.assert_array_equal(got, const[:, None] + np.zeros_like(first))


def test_eval_interval_points_takes_lt_eval(jax_interval):
    _, _, xs, ia, _, want = jax_interval
    calls = []

    def lt_eval(kb, q, packed=False):
        calls.append((kb.k, q.shape, packed))
        return chacha_cuda.eval_points_walk_dcf(kb, q, packed=packed,
                                                walk_fn=chacha_cuda.walk_dcf_plain)

    got = dcf.eval_interval_points(_port_triple(ia), xs, lt_eval=lt_eval)
    assert calls == [(10, (10, Q), False)]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Host-only checks: frozen vectors, the codec, entry points
# ---------------------------------------------------------------------------

# tests/test_dcf.py::_FROZEN: (log_n, seed, sha256 of party A's keys,
# sha256 of eval_points_np at 8 queries a gate).
FROZEN = [
    (8, 1, "14acbe434df26160be9ebe65c55f017d341127bca3a1c64562b3459833d96e4a",
     "29b9e2fda6decd2b3322bc2f16980a65bea98d0f53b4a6f9e20f571dc0e84c54"),
    (20, 2, "67a22b1b7fe0b965faf51ddeb97731dbe180c91e2969b334d180e42c0464eea4",
     "ca31a30f1b250dbfc89be5207766096a51b2e27ef7095d65c0a088a6359c1db4"),
    (33, 3, "484813746b5c80b7032f2bf4dc01a69f512d8b633db5ef7cca7aad5e375d267c",
     "75fcce774cba9a4ce5a3c12674fc8deeb08e8af3c9eec9e1c0179d6a0e8ba1a5"),
]


@pytest.mark.parametrize("log_n,seed,key_sha,out_sha", FROZEN)
def test_frozen_vectors(log_n, seed, key_sha, out_sha):
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=3, dtype=np.uint64)
    ka, _ = dcf.gen_lt_batch(alphas, log_n, rng=np.random.default_rng(seed + 100))
    assert hashlib.sha256(b"".join(ka.to_bytes())).hexdigest() == key_sha
    xs = rng.integers(0, 1 << log_n, size=(3, 8), dtype=np.uint64)
    bits = dcf.eval_points_np(ka, xs)
    assert hashlib.sha256(bits.tobytes()).hexdigest() == out_sha
    np.testing.assert_array_equal(dcf.eval_lt_points(ka, xs, device="cpu"), bits)


def test_lt_leaf_mask_matches_reference():
    low = np.array([0, 1, 31, 32, 33, 257, 511], np.uint64)
    np.testing.assert_array_equal(dcf._lt_leaf_mask(low), ref_dcf._lt_leaf_mask(low))


def _mutations(blob: bytes, log_n: int):
    """(what, mutated blob) pairs that make a key non-canonical."""
    nu = max(log_n - 9, 0)
    flips = [("ts", 16, 2), ("seed lsb", 0, 1)]
    if nu:
        flips += [("tcw", 17 + 16, 2), ("vcw", 17 + 18, 2), ("scw lsb", 17, 1)]
    for what, at, bit in flips:
        b = bytearray(blob)
        b[at] |= bit
        yield what, bytes(b)


@pytest.mark.parametrize("log_n", [8, 13])
def test_from_bytes_rejects_what_the_reference_rejects(log_n):
    ka, _ = ref_dcf.gen_lt_batch(np.array([5, 77], np.uint64), log_n,
                                 rng=np.random.default_rng(1))
    blobs = ka.to_bytes()
    assert dcf.DcfKeyBatch.from_bytes(blobs, log_n).to_bytes() == blobs
    for what, bad in _mutations(blobs[0], log_n):
        for cls in (ref_dcf.DcfKeyBatch, dcf.DcfKeyBatch):
            with pytest.raises(ValueError, match="non-canonical"):
                cls.from_bytes([bad, blobs[1]], log_n)
    for cls in (ref_dcf.DcfKeyBatch, dcf.DcfKeyBatch):
        with pytest.raises(ValueError, match="length"):
            cls.from_bytes([blobs[0][:-1]], log_n)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="invalid"):
        dcf.gen_lt_batch([300], 8)
    with pytest.raises(ValueError, match="invalid"):
        dcf.gen_lt_batch([0], 64)
    ka, _ = dcf.gen_lt_batch([3, 5], 8, np.random.default_rng(0))
    with pytest.raises(ValueError, match="out of domain"):
        dcf.eval_lt_points(ka, np.array([[1], [256]], np.uint64), device="cpu")
    with pytest.raises(ValueError, match=r"\[K, Q\]"):
        dcf.eval_lt_points(ka, np.zeros((3, 2), np.uint64), device="cpu")
    with pytest.raises(ValueError, match="lo > hi"):
        dcf.gen_interval_batch([5], [4], 8)
    with pytest.raises(ValueError, match="hi out of domain"):
        dcf.gen_interval_batch([5], [256], 8)
    with pytest.raises(ValueError, match="vcw"):
        from_jax_dcfkeybatch(8, ka.seeds, ka.ts, ka.scw, ka.tcw, ka.vcw[:, None], ka.fvcw)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(2, 0), (0, 4)])
def test_empty_batches(monkeypatch, shape, packed):
    ka, _ = dcf.gen_lt_batch(np.arange(shape[0], dtype=np.uint64), 8,
                             np.random.default_rng(0))
    monkeypatch.setattr(chacha_cuda, "dcf_walk_args", None)  # nothing is walked
    got = dcf.eval_lt_points(ka, np.zeros(shape, np.uint64), packed=packed, device="cpu")
    assert got.shape == ((shape[0], -(-shape[1] // 32)) if packed else shape)
    assert got.dtype == (np.uint32 if packed else np.uint8)


def test_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ka, _ = fast.dcf_gen_lt_batch([3, 5], 8, np.random.default_rng(0))
    ia, _ = fast.dcf_gen_interval_batch([1, 2], [3, 4], 8, np.random.default_rng(0))
    xs = np.array([[1, 5], [9, 200]], np.uint64)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fast.dcf_eval_lt_points(ka, xs)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fast.dcf_eval_interval_points(ia, xs)
    assert fast.dcf_eval_lt_points(ka, xs, device="cpu").shape == (2, 2)


DCF_ENTRIES = ["dcf_gen_lt_batch", "dcf_eval_lt_points", "dcf_gen_interval_batch",
               "dcf_eval_interval_points", "dcf_key_len"]


@pytest.mark.parametrize("name", DCF_ENTRIES)
def test_entry_signatures_follow_the_reference(name):
    import inspect

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    want, have = params(getattr(ref_fast, name)), params(getattr(fast, name))
    assert have[: len(want)] == want
    assert [n for n, _ in have[len(want):]] in ([], ["device"])


@pytest.mark.parametrize("nu", [0, 1, 23])
def test_walk_dcf_count_is_its_ciphers(nu):
    # One 9-word expansion block a level (one IADD more than the walk's) and
    # the leaf block; the ALU pipe's count equals the plain walk's.
    ops = op_count.walk_dcf_ops(nu)
    walk = op_count.walk_chacha_ops(nu)
    assert ops - walk == ({"IADD": nu} if nu else {})
    assert ops["LOP3"] + ops["SHF"] == walk["LOP3"] + walk["SHF"] == 380 * (nu + 1)
