"""The port's AES building blocks (dpf_tpu_torch) against dpf_tpu's.

Every comparison is bitwise exact: this is integer cryptography, the
tolerance is zero.  Inputs come from numpy.random.default_rng(seed) and go
through both the dpf_tpu function (JAX on the CPU; Pallas kernels in
interpret mode, as tests/test_aes_pallas.py runs them) and the port's
counterpart on CPU tensors, which is its plain PyTorch version.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dpf_tpu.core import aes_np as ref_aes_np  # noqa: E402
from dpf_tpu.ops import aes_bitslice as ref_bs  # noqa: E402
from dpf_tpu.ops import aes_pallas as ref_pallas  # noqa: E402
from dpf_tpu_torch.core import aes_np  # noqa: E402
from dpf_tpu_torch.ops import aes_bitslice as bs  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda  # noqa: E402
from dpf_tpu_torch.ops.sbox_circuit import SBOX_IMPLS  # noqa: E402


def _rand_words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.fixture(scope="module")
def pallas_bm_ref():
    """dpf_tpu's bit-major Pallas kernels at [128, 128], run once for the
    module (interpret mode on the CPU)."""
    S = _rand_words((128, 128), seed=7)
    L, R = ref_pallas.prg_planes_pallas_bm(jnp.asarray(S))
    C = ref_pallas.mmo_planes_pallas_bm_canon(jnp.asarray(S))
    return S, np.asarray(L), np.asarray(R), np.asarray(C)


@pytest.mark.parametrize("name", sorted(SBOX_IMPLS))
def test_sbox_circuit_exhaustive(name):
    x = np.arange(256, dtype=np.uint8)
    # int32 0/-1 planes, MSB-first as the circuit wants them.
    planes = [torch.from_numpy(-((x >> (7 - i)) & 1).astype(np.int32)) for i in range(8)]
    y = SBOX_IMPLS[name](planes)
    for p in y:
        assert bool(((p == 0) | (p == -1)).all())
    got = sum((y[i] & 1).numpy().astype(np.uint8) << (7 - i) for i in range(8))
    np.testing.assert_array_equal(got.astype(np.uint8), ref_aes_np.SBOX)


@pytest.mark.parametrize(
    "name", ["SBOX", "XTIME", "SHIFT_ROWS_PERM", "ROUND_KEYS_L", "ROUND_KEYS_R"]
)
def test_aes_np_copy_matches_reference(name):
    np.testing.assert_array_equal(getattr(aes_np, name), getattr(ref_aes_np, name))


def test_aes_np_mmo_matches_reference():
    blocks = np.random.default_rng(3).integers(0, 256, size=(64, 16), dtype=np.uint8)
    np.testing.assert_array_equal(aes_np.mmo_l(blocks), ref_aes_np.mmo_l(blocks))
    np.testing.assert_array_equal(aes_np.mmo_r(blocks), ref_aes_np.mmo_r(blocks))


def test_fips197_c1_through_planes():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    masks = bs.round_key_masks(aes_np.expand_key(key))
    words = np.zeros((32, 1, 4), np.uint32)  # one block, padded to 32 keys
    words[0, 0] = np.frombuffer(pt, "<u4")
    planes = bs.pack_padded_keys(bs.to_carrier(words))  # [128, 1, 1]
    ct = bs.aes128_encrypt_planes(planes.reshape(128, 1), masks)
    out = bs.from_carrier(bs.unpack_planes(ct.reshape(128, 1, 1)))[0, 0]
    assert out.view("<u1").tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_prg_and_mmo_planes_match_reference():
    S = _rand_words((128, 100), seed=1)
    L, R = bs.prg_planes(bs.to_carrier(S))
    rL, rR = ref_bs.prg_planes(jnp.asarray(S))
    np.testing.assert_array_equal(bs.from_carrier(L), np.asarray(rL))
    np.testing.assert_array_equal(bs.from_carrier(R), np.asarray(rR))
    C = bs.aes128_mmo_planes(bs.to_carrier(S), bs.RK_MASKS_R)
    rC = ref_bs.aes128_mmo_planes(jnp.asarray(S), ref_bs.RK_MASKS_R)
    np.testing.assert_array_equal(bs.from_carrier(C), np.asarray(rC))


@pytest.mark.parametrize("via", ["wrapper", "plain"])
def test_prg_bm_matches_pallas_kernel(pallas_bm_ref, via):
    S, rL, rR, _ = pallas_bm_ref
    fn = aes_cuda.prg_planes_bm if via == "wrapper" else aes_cuda.prg_planes_bm_plain
    L, R = fn(bs.to_carrier(S))
    np.testing.assert_array_equal(bs.from_carrier(L), rL)
    np.testing.assert_array_equal(bs.from_carrier(R), rR)


@pytest.mark.parametrize("via", ["wrapper", "plain"])
def test_mmo_bm_canon_matches_pallas_kernel(pallas_bm_ref, via):
    # The plain leaf MMO equals the Pallas kernel's planes; the leaf-convert
    # wrapper (on CPU tensors, its plain version) equals them with the final
    # CW under t and the unpack to per-key words (the unpack is held to the
    # reference's by test_pack_unpack_match_reference).
    S, _, _, rC = pallas_bm_ref
    if via == "plain":
        got = aes_cuda.mmo_planes_bm_canon_plain(bs.to_carrier(S))
        np.testing.assert_array_equal(bs.from_carrier(got), rC)
        return
    T, fcw = _rand_words((4, 32), seed=8), _rand_words((128, 1, 32), seed=9)
    got = aes_cuda.convert_leaves_bm(*(bs.to_carrier(a) for a in (S.reshape(128, 4, 32), T, fcw)))
    want = bs.unpack_planes(bs.to_carrier(rC.reshape(128, 4, 32) ^ (fcw & T)))
    np.testing.assert_array_equal(bs.from_carrier(got), bs.from_carrier(want))


@pytest.mark.parametrize("K,N", [(32, 1), (64, 3), (96, 5)])
def test_pack_unpack_roundtrip(K, N):
    W = _rand_words((K, N, 4), seed=K + N)
    P = bs.pack_padded_keys(bs.to_carrier(W))
    assert P.shape == (128, N, K // 32)
    np.testing.assert_array_equal(bs.from_carrier(bs.unpack_planes(P)), W)


def test_pack_unpack_match_reference():
    W = _rand_words((64, 3, 4), seed=5)
    P = bs.from_carrier(bs.pack_padded_keys(bs.to_carrier(W)))
    np.testing.assert_array_equal(
        P, np.asarray(ref_bs.pack_padded_keys(jnp.asarray(W)))
    )
    np.testing.assert_array_equal(
        bs.from_carrier(bs.unpack_planes(bs.to_carrier(P))),
        np.asarray(ref_bs.unpack_planes(jnp.asarray(P))),
    )


def test_transpose32_matches_reference():
    A = _rand_words((32, 5), seed=9)
    np.testing.assert_array_equal(
        bs.from_carrier(bs.transpose32(bs.to_carrier(A))),
        np.asarray(ref_bs.transpose32(jnp.asarray(A))),
    )


@pytest.mark.parametrize("name", ["RK_MASKS_L", "RK_MASKS_R"])
def test_round_key_masks_match_reference(name):
    np.testing.assert_array_equal(getattr(bs, name), getattr(ref_bs, name))


@pytest.mark.parametrize("name", ["_TO_BM", "_FROM_BM"])
def test_bit_major_tables_match_reference(name):
    np.testing.assert_array_equal(
        np.asarray(getattr(aes_cuda, name)), np.asarray(getattr(ref_pallas, name))
    )


@pytest.mark.parametrize("key", [0, 1])
def test_rk_sbox_round_0_matches_reference(key):
    # Round 0 of the kernels' masks is the key itself, which the reference
    # keeps in bit-major order (_RK_BOTH_BM).
    np.testing.assert_array_equal(aes_cuda._RK_SBOX[key, 0][aes_cuda._TO_BM],
                                  ref_pallas._RK_BOTH_BM[key, 0])


@pytest.mark.parametrize("k", [1, 7, 16, 31])
def test_lshr_matches_numpy(k):
    w = _rand_words((1000,), seed=k)
    got = bs.from_carrier(bs.lshr(bs.to_carrier(w), k))
    np.testing.assert_array_equal(got, w >> np.uint32(k))


def test_carrier_roundtrip_keeps_bits():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = bs.to_carrier(w)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(bs.from_carrier(t), w)
