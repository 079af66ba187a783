"""The port's fast-profile pieces (dpf_tpu_torch) against dpf_tpu, one by one:
the numpy spec copy, the key batch, the int32 carrier arithmetic, the plan
functions, and the plain versions of the two expansion kernels.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Inputs
come from numpy.random.default_rng(seed).  No chacha Pallas kernel runs in
interpret mode below a 128-node entry here: the one interpret run enters the
tail at 128 nodes.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from dpf_tpu.core import chacha_np as ref_cc  # noqa: E402
from dpf_tpu.models import dpf_chacha as ref_dc  # noqa: E402
from dpf_tpu.models import keys_chacha as ref_kc  # noqa: E402
from dpf_tpu.ops import chacha_pallas as ref_cp  # noqa: E402
from dpf_tpu.parallel.sharding import _pad_fast_batch as ref_pad  # noqa: E402
from dpf_tpu_torch.core import chacha_np as cc  # noqa: E402
from dpf_tpu_torch.core import keys_chacha as kc  # noqa: E402
from dpf_tpu_torch.interop import from_jax_keybatch_fast  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as dc  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda as cp  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402


def _words(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _ref_state_and_cws(K, W, G, seed):
    """Random level state (4 seed words, t bits) and G levels of CWs."""
    rng = np.random.default_rng(seed)
    S = _words(rng, 4, K, W)
    S[0] &= ~np.uint32(1)
    T = rng.integers(0, 2, size=(K, W), dtype=np.uint32)
    scw = _words(rng, K, G, 4)
    scw[:, :, 0] &= ~np.uint32(1)
    tcw = rng.integers(0, 2, size=(K, G, 2), dtype=np.uint32)
    fcw = _words(rng, K, 16)
    return S, T, scw, tcw, fcw


# ---------------------------------------------------------------------------
# The numpy spec copy
# ---------------------------------------------------------------------------


def test_rfc8439_block_vector():
    # RFC 8439 sec 2.3.2: key 00..1f, counter 1, nonce 00:00:00:09:00:00:00:4a:00:00:00:00
    key = np.frombuffer(bytes(range(32)), dtype="<u4")
    out = cc.chacha_block(key, counter=1, nonce=(0x09000000, 0x4A000000, 0), rounds=20)
    want = [
        0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3,
        0xC7F4D1C7, 0x0368C033, 0x9AAA2204, 0x4E6CD4C3,
        0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
        0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2,
    ]
    assert [int(v) for v in out] == want


@pytest.mark.parametrize("fn", ["prg_expand", "prg_expand_v", "convert_leaf"])
def test_spec_prg_and_convert_match_reference(fn):
    seeds = _words(np.random.default_rng(3), 64, 4)
    got, want = getattr(cc, fn)(seeds), getattr(ref_cc, fn)(seeds)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("log_n", [1, 8, 9, 10, 14])
def test_spec_gen_eval_match_reference(log_n):
    rng = np.random.default_rng(log_n)
    alpha = int(rng.integers(0, 1 << log_n))
    ka, kb = cc.gen(alpha, log_n, np.random.default_rng(log_n))
    assert (ka, kb) == ref_cc.gen(alpha, log_n, np.random.default_rng(log_n))
    assert cc.eval_full(ka, log_n) == ref_cc.eval_full(ka, log_n)
    for x in {0, alpha, (1 << log_n) - 1, int(rng.integers(0, 1 << log_n))}:
        assert cc.eval_point(ka, x, log_n) == ref_cc.eval_point(ka, x, log_n)
        assert cc.eval_point(ka, x, log_n) ^ cc.eval_point(kb, x, log_n) == int(x == alpha)


@pytest.mark.parametrize("log_n", [0, 1, 9, 10, 20, 34, 63])
def test_key_len_matches_reference(log_n):
    assert cc.key_len(log_n) == ref_cc.key_len(log_n)
    assert cc.nu_of(log_n) == ref_cc.nu_of(log_n)


def test_spec_rejects_bad_keys():
    ka, _ = cc.gen(5, 12, np.random.default_rng(0))
    with pytest.raises(ValueError, match="bad key length"):
        cc.eval_full(ka[:-1], 12)
    bad = bytearray(ka)
    bad[16] = 2  # t byte > 1
    with pytest.raises(ValueError, match="non-canonical"):
        cc.eval_full(bytes(bad), 12)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", [8, 12, 20, 34])
def test_gen_batch_bytes_match_reference(log_n):
    K = 5
    alphas = np.random.default_rng(log_n).integers(0, 1 << min(log_n, 62), size=K,
                                                   dtype=np.uint64)
    ka, kb = kc.gen_batch(alphas, log_n, np.random.default_rng(K), device="cpu")
    ra, rb = ref_kc.gen_batch(alphas, log_n, np.random.default_rng(K))
    assert ka.to_bytes() == ra.to_bytes()
    assert kb.to_bytes() == rb.to_bytes()


def test_key_batch_round_trip_and_jax_interop():
    ra, _ = ref_kc.gen_batch([3, 700, 1023], 10, np.random.default_rng(1))
    kb = kc.KeyBatchFast.from_bytes(ra.to_bytes(), 10)
    assert kb.to_bytes() == ra.to_bytes()
    carried = from_jax_keybatch_fast(ra.log_n, ra.seeds, ra.ts, ra.scw, ra.tcw, ra.fcw)
    assert carried.to_bytes() == ra.to_bytes()
    for name in ("seeds", "ts", "scw", "tcw", "fcw"):
        assert getattr(carried, name) is not getattr(ra, name)
    with pytest.raises(ValueError, match="fcw"):
        from_jax_keybatch_fast(10, ra.seeds, ra.ts, ra.scw, ra.tcw, ra.fcw[:, :4])


def test_pad_fast_batch_matches_reference():
    ra, _ = ref_kc.gen_batch([1, 2, 3], 12, np.random.default_rng(2))
    got = kc._pad_fast_batch(kc.KeyBatchFast.from_bytes(ra.to_bytes(), 12), 5)
    want = ref_pad(ra, 5)
    assert got.k == 8 and got.to_bytes() == want.to_bytes()


# ---------------------------------------------------------------------------
# Carrier arithmetic and the torch ChaCha core
# ---------------------------------------------------------------------------

_EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                  dtype=np.uint32)


@pytest.mark.parametrize("r", [16, 12, 8, 7])
def test_rotl_matches_numpy(r):
    x = np.concatenate([_EDGES, _words(np.random.default_rng(r), 1000)])
    want = (x << np.uint32(r)) | (x >> np.uint32(32 - r))
    np.testing.assert_array_equal(from_carrier(dc._rotl(to_carrier(x), r)), want)


def test_add_wraps_as_uint32():
    a = np.concatenate([_EDGES, _EDGES[::-1], _words(np.random.default_rng(1), 1000)])
    b = np.concatenate([_EDGES[::-1], _EDGES, _words(np.random.default_rng(2), 1000)])
    with np.errstate(over="ignore"):
        want = a + b
    np.testing.assert_array_equal(from_carrier(to_carrier(a) + to_carrier(b)), want)


@pytest.mark.parametrize("leaf", [False, True], ids=["expand", "leaf"])
def test_chacha_core_matches_numpy(leaf):
    seeds = _words(np.random.default_rng(int(leaf)), 6, 4)
    ds = cc.DS_LEAF if leaf else cc.DS_EXPAND
    want = cc.chacha_block(np.concatenate([seeds, np.broadcast_to(ds, seeds.shape)], 1),
                           rounds=cc.ROUNDS)
    got = dc._chacha_core([to_carrier(seeds[:, i]) for i in range(4)],
                          dc._DSL if leaf else dc._DSX, 16)
    np.testing.assert_array_equal(np.stack([from_carrier(g) for g in got], 1), want)


# ---------------------------------------------------------------------------
# Plan functions
# ---------------------------------------------------------------------------

_KS = (1, 7, 8, 9, 1024)
_CAPS = (1 << 10, 1 << 16, 1 << 19, 1 << 23)


@pytest.mark.parametrize("k", _KS)
@pytest.mark.parametrize("nu", range(0, 17))
def test_expand_plan_matches_reference(monkeypatch, nu, k):
    # The port's plan is the JAX one as it decides on the TPU, knob unset.
    monkeypatch.setattr(ref_cp, "_on_tpu", lambda: True)
    monkeypatch.setattr(ref_cp, "_SMALL_TREE_BROKEN", False)
    monkeypatch.delenv("DPF_TPU_EXPAND_ENTRY", raising=False)
    assert cp.small_tree_entry(nu) == ref_cp.small_tree_entry(nu)
    for cap in _CAPS:
        assert cp.expand_plan(nu, k, cap) == ref_cp.expand_plan(nu, k, cap)
        assert cp.expand_plan_chunked(nu, k, cap) == ref_cp.expand_plan_chunked(nu, k, cap)
    assert cp.kernel_usable(nu, k) == ref_cp.kernel_usable(nu, k)
    for floor in (7, 8, 10):
        assert cp.entry_level(nu, floor) == ref_cp.entry_level(nu, floor)


def test_fuse_auto_levels_matches_reference():
    assert cp.fuse_auto_levels() == ref_cp.fuse_auto_levels()


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the JAX functions they replace
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def finish_pk_log18():
    """dpf_tpu's tail at log_n=18, K=9 (padded to 16): entry level 7, two
    levels and the leaf convert in the Pallas kernel (interpret mode, a
    128-node entry), run once."""
    log_n, K = 18, 9
    rng = np.random.default_rng(18)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, _ = ref_kc.gen_batch(alphas, log_n, rng)
    pk = ref_pad(ka, (-K) % ref_cp._EKT)
    seeds, ts, scw, tcw, _ = pk.device_args()
    entry = ref_cp.entry_level(pk.nu)
    S, T = ref_dc._expand_prefix_cc_jit(entry, seeds, ts, scw, tcw)
    ops = ref_cp.cw_operands(pk.scw, pk.tcw.astype(np.uint32), pk.fcw, entry, pk.nu)
    words = ref_dc._finish_pk_jit(pk.nu, entry, *S, T, *ops)
    state = np.stack([np.asarray(s) for s in S] + [np.asarray(T)])
    return pk, entry, state, np.asarray(words)


def test_tail_plain_matches_finish_pk(finish_pk_log18):
    pk, entry, state, want = finish_pk_log18
    assert (entry, state.shape) == (7, (5, 16, 128))
    dk = dc.DeviceKeysFast(kc.KeyBatchFast.from_bytes(pk.to_bytes(), pk.log_n), "cpu")
    got = cp.expand_tail_plain(to_carrier(state), dk.scw[:, entry:], dk.tcw[:, entry:],
                               dk.fcw)
    np.testing.assert_array_equal(from_carrier(got), want)


def test_tail_wrapper_chunks_match_finish_pk(finish_pk_log18):
    # The chunked route's node-range views, through the wrapper on the CPU.
    pk, entry, state, want = finish_pk_log18
    dk = dc.DeviceKeysFast(kc.KeyBatchFast.from_bytes(pk.to_bytes(), pk.log_n), "cpu")
    st = to_carrier(state)
    out = torch.zeros((16, 512, 16), dtype=torch.int32)
    for a in range(0, 128, 32):
        cp.expand_tail(st[:, :, a : a + 32], dk.scw[:, entry:], dk.tcw[:, entry:],
                       dk.fcw, out=out[:, a << 2 : (a + 32) << 2])
    np.testing.assert_array_equal(from_carrier(out), want)


@pytest.mark.parametrize("K,W,G", [(1, 1, 5), (9, 3, 2), (8, 128, 1), (3, 2, 0)])
def test_fused_plain_matches_level_steps(K, W, G):
    # The function fused_levels_raw computes (then deinterleaved): G of the
    # JAX _level_step_cc, run level by level (never the Pallas kernel).
    S, T, scw, tcw, _ = _ref_state_and_cws(K, W, G, seed=K * 100 + W + G)
    rS, rT = [jnp.asarray(s) for s in S], jnp.asarray(T)
    for i in range(G):
        rS, rT = ref_dc._level_step_cc(
            rS, rT, [jnp.asarray(scw[:, i, w]) for w in range(4)],
            jnp.asarray(tcw[:, i, 0]), jnp.asarray(tcw[:, i, 1]),
        )
    want = np.stack([np.asarray(s) for s in rS] + [np.asarray(rT)])
    got = cp.fused_levels_plain(to_carrier(np.concatenate([S, T[None]])),
                                to_carrier(scw), to_carrier(tcw))
    assert got.shape == (5, K, W << G)
    np.testing.assert_array_equal(from_carrier(got), want)


def test_eval_full_cc_matches_reference():
    # The plain whole-tree level loop against dpf_tpu's _eval_full_cc_jit.
    ka, _ = ref_kc.gen_batch([0, 4000, 8191], 13, np.random.default_rng(13))
    seeds, ts, scw, tcw, fcw = ka.device_args()
    want = np.asarray(ref_dc._eval_full_cc_jit(ka.nu, seeds, ts, scw, tcw, fcw))
    dk = dc.DeviceKeysFast(kc.KeyBatchFast.from_bytes(ka.to_bytes(), 13), "cpu")
    got = dc._eval_full_cc(dk.nu, dk.seeds, dk.ts, dk.scw, dk.tcw, dk.fcw)
    np.testing.assert_array_equal(from_carrier(got), want)
