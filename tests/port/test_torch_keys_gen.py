"""The dealer (``dpf_tpu_torch/models/keys_gen.py``) against the JAX package.

The port's torch towers (``gen_device_cc`` for the fast and DCF families,
``gen_device_compat`` on bitsliced planes; with ``device="cpu"`` they run
the plain versions of ``gen_tower_cc_kernel`` and ``prg_canon_kernel``) give
the same key bytes as ``dpf_tpu``'s ``gen_batch`` / ``gen_lt_batch`` on the
same rng (the host tower off the TPU), at compat log_n {1, 7, 8, 10, 16},
fast {1, 9, 10, 20} and DCF {1, 20, 32}, K in {0, 1, 33}.  At one small
log_n a family, the port's tower bodies equal the JAX ``_gen_cc_jit`` /
``_gen_compat_jit(nu, True, ...)`` bodies on the same operands (the compat
body only fused: unrolled, it compiles for minutes on the CPU).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dpf_tpu.core import keys as ref_keys  # noqa: E402
from dpf_tpu.models import dcf as ref_dcf  # noqa: E402
from dpf_tpu.models import keys_chacha as ref_kc  # noqa: E402
from dpf_tpu.models import keys_gen as ref_kg  # noqa: E402
from dpf_tpu.ops.aes_bitslice import pack_blocks_np as ref_pack_blocks_np  # noqa: E402
from dpf_tpu_torch.core import keys, keys_chacha  # noqa: E402
from dpf_tpu_torch.models import dcf, keys_gen  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda, op_count  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, pack_blocks_np, to_carrier  # noqa: E402

FAMILIES = {"compat": (1, 7, 8, 10, 16), "fast": (1, 9, 10, 20), "dcf": (1, 20, 32)}
CASES = [(fam, n, k) for fam, ns in FAMILIES.items() for n in ns for k in (0, 1, 33)]
FIELDS = {"compat": ("seeds", "ts", "scw", "tcw", "fcw"),
          "fast": ("seeds", "ts", "scw", "tcw", "fcw"),
          "dcf": ("seeds", "ts", "scw", "tcw", "vcw", "fvcw")}


def _alphas(log_n, K, seed):
    return np.random.default_rng(seed).integers(0, 1 << log_n, size=K, dtype=np.uint64)


def _reference(fam, alphas, log_n, seed):
    rng = np.random.default_rng(seed)
    if fam == "compat":
        return ref_keys.gen_batch(alphas, log_n, rng=rng)
    if fam == "fast":
        return ref_kc.gen_batch(alphas, log_n, rng=rng)
    return ref_dcf.gen_lt_batch(alphas, log_n, rng=rng)


def _port_tower(fam, alphas, log_n, seed):
    """The port's torch tower on the CPU, on roots drawn from the same rng."""
    draw = keys._draw_roots if fam == "compat" else keys_chacha._draw_roots
    s0, t0, s1, t1 = draw(alphas.shape[0], np.random.default_rng(seed))
    if fam == "compat":
        return keys_gen.gen_device_compat(alphas, log_n, s0, t0, s1, t1, device="cpu")
    return keys_gen.gen_device_cc(fam, alphas, log_n, s0, t0, s1, t1, device="cpu")


@pytest.mark.parametrize("fam,log_n,K", CASES)
def test_torch_tower_bytes_match_reference(fam, log_n, K):
    alphas = _alphas(log_n, K, 7 * log_n + K)
    want = _reference(fam, alphas, log_n, log_n + K)
    got = _port_tower(fam, alphas, log_n, log_n + K)
    for w, g in zip(want, got):
        for f in FIELDS[fam]:
            a, b = getattr(w, f), getattr(g, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (f, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert w.to_bytes() == g.to_bytes()


def test_gen_batch_on_the_cpu_is_the_host_tower():
    # device="cpu" takes the numpy tower, which the torch tower equals.
    alphas = _alphas(12, 9, 1)
    for fam, gen in (("compat", keys.gen_batch), ("fast", keys_chacha.gen_batch),
                     ("dcf", dcf.gen_lt_batch)):
        host = gen(alphas, 12, np.random.default_rng(3), device="cpu")
        tower = _port_tower(fam, alphas, 12, 3)
        assert [k.to_bytes() for k in host] == [k.to_bytes() for k in tower]


def _cc_operands(K, nu, seed):
    rng = np.random.default_rng(seed)
    s0 = rng.integers(0, 1 << 32, size=(K, 4), dtype=np.uint32)
    s1 = rng.integers(0, 1 << 32, size=(K, 4), dtype=np.uint32)
    s0[:, 0] &= ~np.uint32(1)
    s1[:, 0] &= ~np.uint32(1)
    t0 = rng.integers(0, 2, size=K, dtype=np.uint32)
    bits = rng.integers(0, 2, size=(nu, K), dtype=np.uint32)
    return s0, s1, t0, t0 ^ np.uint32(1), bits


@pytest.mark.parametrize("dcf_tower", [False, True], ids=["fast", "dcf"])
def test_cc_body_matches_jax_body(dcf_tower):
    nu = 3
    ops = _cc_operands(33, nu, 5 + dcf_tower)
    want = ref_kg._gen_cc_jit(nu, dcf_tower, True, *(jnp.asarray(a) for a in ops))
    got = keys_gen._gen_cc_body(nu, dcf_tower, *(to_carrier(a) for a in ops))
    # The wrapper on CPU tensors is the plain body, launching nothing.
    before = chacha_cuda.gen_tower.launches
    wrapped = chacha_cuda.gen_tower(*(to_carrier(a) for a in ops), dcf_tower)
    assert chacha_cuda.gen_tower.launches == before
    assert len(want) == len(got) == len(wrapped) == 4 + dcf_tower
    for w, g, h in zip(want, got, wrapped):
        np.testing.assert_array_equal(np.asarray(w), from_carrier(g))
        assert torch.equal(g, h)


def test_compat_body_matches_jax_fused_body():
    nu, W = 3, 2
    rng = np.random.default_rng(9)
    S0 = rng.integers(0, 1 << 32, size=(128, W), dtype=np.uint32)
    S1 = rng.integers(0, 1 << 32, size=(128, W), dtype=np.uint32)
    S0[0] = 0
    S1[0] = 0
    T0 = rng.integers(0, 1 << 32, size=W, dtype=np.uint32)
    BM = rng.integers(0, 1 << 32, size=(nu, W), dtype=np.uint32)
    ops = (S0, S1, T0, T0 ^ np.uint32(0xFFFFFFFF), BM)
    want = ref_kg._gen_compat_jit(nu, True, *(jnp.asarray(a) for a in ops))
    got = keys_gen._gen_compat_body(nu, *(to_carrier(a) for a in ops))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), from_carrier(g))


@pytest.mark.parametrize("n", [0, 1, 31, 33])
def test_pack_blocks_np_is_the_reference(n):
    blocks = np.random.default_rng(n).integers(0, 256, size=(n, 16), dtype=np.uint8)
    np.testing.assert_array_equal(pack_blocks_np(blocks), ref_pack_blocks_np(blocks))


@pytest.mark.parametrize("fam,log_n", [("compat", 9), ("fast", 11), ("dcf", 11)])
def test_device_towers_without_cuda_raise_unless_cpu(monkeypatch, fam, log_n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    alphas = _alphas(log_n, 3, 2)
    draw = keys._draw_roots if fam == "compat" else keys_chacha._draw_roots
    roots = draw(3, np.random.default_rng(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if fam == "compat":
            keys_gen.gen_device_compat(alphas, log_n, *roots)
        else:
            keys_gen.gen_device_cc(fam, alphas, log_n, *roots)


@pytest.mark.parametrize("nu", [0, 11, 23])
def test_gen_tower_ops_are_its_ciphers(nu):
    # Two expansion blocks a level (8 words; 9 with the DCF value word) and
    # two leaf blocks a key.
    fast, dcf_ops = op_count.gen_tower_ops(nu, False), op_count.gen_tower_ops(nu, True)
    assert fast == op_count.walk_chacha_ops(nu) + op_count.walk_chacha_ops(nu)
    assert dcf_ops - fast == ({"IADD": 2 * nu} if nu else {})
