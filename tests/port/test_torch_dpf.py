"""The port's compat Gen -> EvalFull slice (dpf_tpu_torch) against dpf_tpu.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Keys
come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where its kernel wrappers run their plain PyTorch versions.
"""

import hashlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import dpf_tpu  # noqa: E402
import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu.core import spec as ref_spec  # noqa: E402
from dpf_tpu.models import dpf as ref_dpf  # noqa: E402
from dpf_tpu_torch.core import spec  # noqa: E402
from dpf_tpu_torch.interop import from_jax_keybatch  # noqa: E402
from dpf_tpu_torch.models import dpf as port_dpf  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier  # noqa: E402
from test_golden_vectors import VECTORS  # noqa: E402


def _batch(log_n, K, seed):
    rng = np.random.default_rng(seed)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    return alphas, port.gen_batch(alphas, log_n, rng, device="cpu")


def _spec_rows(kb, log_n):
    return np.stack(
        [np.frombuffer(spec.eval_full(k, log_n), np.uint8) for k in kb.to_bytes()]
    )


@pytest.fixture(scope="module")
def xla_eval_full_n10():
    """dpf_tpu's XLA-backend eval_full at n=10, K=32, compiled once."""
    log_n, K = 10, 32
    rng = np.random.default_rng(10)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, _ = dpf_tpu.gen_batch(alphas, log_n, rng)
    return ka, ref_dpf.eval_full(ka, backend="xla")


@pytest.mark.parametrize("vec", VECTORS, ids=[f"n{v[0]}" for v in VECTORS])
def test_golden_vectors(vec):
    log_n, alpha, seed, key_hex, out_sha = vec
    ka, _ = port.Gen(alpha, log_n, np.random.default_rng(seed))
    got_key = ka.hex() if len(ka) <= 60 else hashlib.sha256(ka).hexdigest()
    assert got_key == key_hex
    out = port.EvalFull(ka, log_n, device="cpu")
    assert hashlib.sha256(out).hexdigest() == out_sha


@pytest.mark.parametrize("log_n,K", [(5, 3), (12, 40), (20, 33)])
def test_gen_batch_matches_reference(log_n, K):
    alphas = np.random.default_rng(log_n).integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, kb = port.gen_batch(alphas, log_n, np.random.default_rng(K), device="cpu")
    ra, rb = dpf_tpu.gen_batch(alphas, log_n, np.random.default_rng(K))
    assert ka.to_bytes() == ra.to_bytes()
    assert kb.to_bytes() == rb.to_bytes()


def test_eval_full_matches_reference_xla(xla_eval_full_n10):
    ra, want = xla_eval_full_n10
    ka = port.KeyBatch.from_bytes(ra.to_bytes(), ra.log_n)
    got = port.eval_full_batch(ka, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n,K", [(3, 5), (7, 33), (12, 40), (12, 64)])
def test_eval_full_matches_spec(log_n, K):
    alphas, (ka, kb) = _batch(log_n, K, seed=log_n + K)
    got = port.eval_full_batch(ka, device="cpu")
    assert got.shape == (K, max(1 << (log_n - 3), 16)) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _spec_rows(ka, log_n))
    rec = np.unpackbits(got ^ port.eval_full_batch(kb, device="cpu"), axis=1, bitorder="little")
    assert (rec.sum(axis=1) == 1).all()
    assert (rec[np.arange(K), alphas.astype(np.int64)] == 1).all()


@pytest.mark.parametrize("max_plane_words", [4, 16])
def test_eval_full_chunked_matches_unchunked(max_plane_words):
    _, (ka, _) = _batch(12, 3, seed=2)
    full = port_dpf.eval_full(ka, device="cpu")
    chunked = port_dpf.eval_full(ka, max_plane_words=max_plane_words, device="cpu")
    np.testing.assert_array_equal(full, chunked)


def test_device_keys_match_reference():
    log_n, K = 11, 40
    rng = np.random.default_rng(11)
    ra, _ = dpf_tpu.gen_batch(rng.integers(0, 1 << log_n, size=K, dtype=np.uint64), log_n, rng)
    ref = ref_dpf.DeviceKeys(ra)
    dk = port_dpf.DeviceKeys(port.KeyBatch.from_bytes(ra.to_bytes(), log_n), "cpu")
    for name in ("seed_planes", "t_words", "scw_planes", "tl_words", "tr_words", "fcw_planes"):
        np.testing.assert_array_equal(
            from_carrier(getattr(dk, name)), np.asarray(getattr(ref, name)), err_msg=name
        )


def test_from_jax_keybatch_keeps_bytes():
    log_n, K = 13, 7
    rng = np.random.default_rng(13)
    ra, _ = dpf_tpu.gen_batch(rng.integers(0, 1 << log_n, size=K, dtype=np.uint64), log_n, rng)
    kb = from_jax_keybatch(ra.log_n, ra.seeds, ra.ts, ra.scw, ra.tcw, ra.fcw)
    assert kb.to_bytes() == ra.to_bytes()
    with pytest.raises(ValueError):
        from_jax_keybatch(ra.log_n, ra.seeds, ra.ts, ra.scw[:, :1], ra.tcw, ra.fcw)


def test_eval_point_matches_reference():
    log_n = 9
    ka, kb = port.Gen(300, log_n, np.random.default_rng(1))
    xs = [0, 1, 299, 300, 301, 511]
    assert [port.Eval(ka, x, log_n) for x in xs] == [ref_spec.eval_point(ka, x, log_n) for x in xs]
    assert [port.Eval(ka, x, log_n) ^ port.Eval(kb, x, log_n) for x in xs] == [0, 0, 0, 1, 0, 0]


def test_key_len_and_bytes_roundtrip():
    _, (ka, _) = _batch(14, 4, seed=14)
    blobs = ka.to_bytes()
    assert all(len(b) == port.key_len(14) == ref_spec.key_len(14) for b in blobs)
    assert port.KeyBatch.from_bytes(blobs, 14).to_bytes() == blobs
