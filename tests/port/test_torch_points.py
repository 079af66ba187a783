"""The port's compat pointwise Eval (dpf_tpu_torch.eval_points_batch and the
model's eval_points_level_grouped) against dpf_tpu and the numpy spec.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Keys
and queries come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where the walk wrapper runs its plain PyTorch version.  Each
JAX reference runs once per module: the Pallas walk kernel in interpret mode
at log_n = 33 (key and query padding, the high index word), and the XLA
route at log_n = 6.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402

import dpf_tpu  # noqa: E402
from dpf_tpu.core import bitpack as ref_bitpack  # noqa: E402
from dpf_tpu.core import spec as ref_spec  # noqa: E402
from dpf_tpu.core.keys import gen_batch as ref_gen_batch  # noqa: E402
from dpf_tpu.models import dpf as ref_dpf  # noqa: E402
from dpf_tpu.ops import aes_pallas  # noqa: E402

import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu_torch.core import bitpack  # noqa: E402
from dpf_tpu_torch.interop import from_jax_keybatch  # noqa: E402
from dpf_tpu_torch.models import dpf as md  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402


def _to_port(kb):
    return from_jax_keybatch(kb.log_n, kb.seeds, kb.ts, kb.scw, kb.tcw, kb.fcw)


def _spec_bits(kb, xs):
    blobs = kb.to_bytes()
    return np.array(
        [[ref_spec.eval_point(blobs[i], int(x), kb.log_n) for x in row]
         for i, row in enumerate(xs)],
        dtype=np.uint8,
    ).reshape(xs.shape)


# ---------------------------------------------------------------------------
# Against the spec: every log_n, K and Q of the grid once (a Latin square),
# at each key's alpha and three more of its queries (a spec point costs 18 ms
# at log_n = 33; the JAX comparisons below check every output bit)
# ---------------------------------------------------------------------------

SPEC_CASES = [(6, 1, 1), (6, 5, 13), (6, 8, 33), (13, 1, 13), (13, 5, 33),
              (13, 8, 1), (33, 1, 33), (33, 5, 1), (33, 8, 13)]


@functools.cache
def _spec_case(log_n, K, Q):
    """(alphas, party keys, xs with xs[:, 0] = alphas, checked (key, query)
    positions, party 0's spec bits there)."""
    rng = np.random.default_rng(1000 * log_n + 10 * K + Q)
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, kb = port.gen_batch(alphas, log_n, rng)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    cols = [np.unique(np.r_[0, rng.integers(0, Q, size=3)]) for _ in range(K)]
    pos = (np.repeat(np.arange(K), [len(c) for c in cols]), np.concatenate(cols))
    blobs = ka.to_bytes()
    want = np.array([ref_spec.eval_point(blobs[i], int(xs[i, j]), log_n)
                     for i, j in zip(*pos)], np.uint8)
    return alphas, ka, kb, xs, pos, want


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("log_n,K,Q", SPEC_CASES)
def test_eval_points_batch_matches_spec(log_n, K, Q, packed):
    _, ka, _, xs, pos, want = _spec_case(log_n, K, Q)
    got = port.eval_points_batch(ka, xs, packed=packed, device="cpu")
    if packed:
        assert got.shape == (K, -(-Q // 32)) and got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref_bitpack.mask_tail(got, Q))
        got = ref_bitpack.unpack_bits(got, Q)
    assert got.shape == (K, Q) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[pos], want)


@pytest.mark.parametrize("log_n,K,Q", SPEC_CASES[1::3])
def test_shares_reconstruct_the_indicator(log_n, K, Q):
    alphas, ka, kb, xs, _, _ = _spec_case(log_n, K, Q)
    rec = port.eval_points_batch(ka, xs, device="cpu") ^ port.eval_points_batch(
        kb, xs, device="cpu")
    np.testing.assert_array_equal(rec, (xs == alphas[:, None]).astype(np.uint8))


# ---------------------------------------------------------------------------
# Against the Pallas walk kernel (interpret mode), once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_walk():
    """``dpf_tpu.models.dpf._eval_points_walk_compat`` at log_n = 33, K = 5,
    Q = 13 (keys pad to 8, queries to 32), with the operands and the result
    of its ``aes_pallas.eval_points_walk_planes`` call captured."""
    rng = np.random.default_rng(33)
    log_n, K, Q = 33, 5, 13
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    ka, _ = ref_gen_batch(alphas, log_n, rng=rng)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    seen = {}
    real = aes_pallas.eval_points_walk_planes

    def spy(*args):
        *ops, nu = args
        seen["nu"] = nu
        jax.debug.callback(lambda *a: seen.update(ops=[np.asarray(x) for x in a]), *ops)
        out = real(*args)
        jax.debug.callback(lambda o: seen.update(out=np.asarray(o)), out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aes_pallas, "eval_points_walk_planes", spy)
        ref_dpf._eval_points_walk_jit.clear_cache()  # trace again, through the spy
        bits = ref_dpf._eval_points_walk_compat(ka, xs)
        words = ref_dpf._eval_points_walk_compat(ka, xs, packed=True)
    jax.effects_barrier()
    return dict(kb=ka, xs=xs, bits=bits, words=words, **seen)


def test_eval_points_batch_matches_jax_walk_kernel(jax_walk):
    kb = _to_port(jax_walk["kb"])
    got = port.eval_points_batch(kb, jax_walk["xs"], device="cpu")
    np.testing.assert_array_equal(got, jax_walk["bits"])


def test_eval_points_batch_packed_matches_jax_walk_kernel(jax_walk):
    kb = _to_port(jax_walk["kb"])
    got = port.eval_points_batch(kb, jax_walk["xs"], packed=True, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jax_walk["words"])


def test_walk_planes_plain_is_the_pallas_kernel(jax_walk):
    # The kernel boundary: the Pallas kernel's own operands (8 padded keys)
    # through the port's wrapper on CPU tensors (its plain version).
    ops = [to_carrier(a) for a in jax_walk["ops"]]
    before = aes_cuda.eval_points_walk_planes.launches
    got = aes_cuda.eval_points_walk_planes(*ops, jax_walk["nu"])
    assert aes_cuda.eval_points_walk_planes.launches == before
    np.testing.assert_array_equal(from_carrier(got), jax_walk["out"])


# The key axis of each walk operand: seeds_bm [128, K], t [K], scw_bm
# [nu, 128, K], tl and tr [nu, K], fcw [128, K], pw [nu, K, qp], sel
# [128, K, qp].
WALK_KEY_AXIS = (1, 0, 2, 1, 1, 1, 1, 1)


def test_operand_prep_matches_jax(jax_walk):
    # The port's masks, path words and leaf select equal the JAX body's for
    # the real keys (the JAX route pads keys to 8; the port does not).
    kb = _to_port(jax_walk["kb"])
    xs_hi, xs_lo = md._split_words(md._pad_queries(jax_walk["xs"]), kb.log_n, "cpu")
    *ops, nu = md._eval_points_walk_body(kb.nu, kb.log_n, *md._point_masks(kb, "cpu"),
                                         xs_hi, xs_lo, lambda *a: a)
    assert nu == jax_walk["nu"] == kb.nu
    for got, want, axis in zip(ops, jax_walk["ops"], WALK_KEY_AXIS):
        np.testing.assert_array_equal(from_carrier(got),
                                      np.take(want, np.arange(kb.k), axis=axis))


# ---------------------------------------------------------------------------
# Level-grouped, and against the JAX XLA route once
# ---------------------------------------------------------------------------

G6, N6, Q6 = 3, 6, 13
LEVELS6 = (1, 4, 5)  # groups = 2: 2 * 3 * 3 keys, the same 18 rows as groups = 1


@pytest.fixture(scope="module")
def jax_xla6():
    """The JAX XLA route at log_n = 6 (one compile: every call below walks
    18 keys at 13 queries): eval_points_batch, and eval_points_level_grouped
    with K = 18 (not a multiple of 8, so its host-expansion route) in full,
    reduced, and with ``levels=``."""
    rng = np.random.default_rng(6)
    K = N6 * G6
    kg, _ = ref_gen_batch(rng.integers(0, 1 << N6, size=K, dtype=np.uint64), N6, rng=rng)
    kl, _ = ref_gen_batch(rng.integers(0, 1 << N6, size=K, dtype=np.uint64), N6, rng=rng)
    xg = rng.integers(0, 1 << N6, size=(G6, Q6), dtype=np.uint64)
    xk = rng.integers(0, 1 << N6, size=(K, Q6), dtype=np.uint64)
    return dict(
        kg=kg, kl=kl, xg=xg, xk=xk,
        points=dpf_tpu.eval_points_batch(kg, xk),
        grouped=ref_dpf.eval_points_level_grouped(kg, xg, 1),
        grouped_reduced=ref_dpf.eval_points_level_grouped(kg, xg, 1, reduce=True),
        levels=ref_dpf.eval_points_level_grouped(kl, xg, 2, levels=LEVELS6),
        levels_reduced=ref_dpf.eval_points_level_grouped(kl, xg, 2, reduce=True,
                                                         levels=LEVELS6),
    )


@pytest.mark.parametrize("packed", [False, True])
def test_eval_points_batch_matches_jax_xla(jax_xla6, packed):
    got = port.eval_points_batch(_to_port(jax_xla6["kg"]), jax_xla6["xk"], packed=packed,
                                 device="cpu")
    want = jax_xla6["points"]
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want) if packed else want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("levels", [None, LEVELS6])
def test_level_grouped_matches_jax(jax_xla6, levels, reduce, packed):
    kb = _to_port(jax_xla6["kg" if levels is None else "kl"])
    groups = 1 if levels is None else 2
    got = md.eval_points_level_grouped(kb, jax_xla6["xg"], groups, reduce=reduce,
                                       packed=packed, levels=levels, device="cpu")
    want = jax_xla6[("grouped" if levels is None else "levels")
                    + ("_reduced" if reduce else "")]
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want) if packed else want)


def _grouped_spec(kb, xs, groups, levels):
    """Spec bits of a level-grouped batch at its masked queries: row
    b * G + g is evaluated at xs[g] with its low log_n - 1 - level(b) bits
    zeroed."""
    G, n = xs.shape[0], kb.log_n
    lv = list(levels) if levels is not None else list(range(n))
    rows = []
    for b in range(groups * len(lv)):
        s = np.uint64(n - 1 - lv[b % len(lv)])
        rows.append((xs >> s) << s)
    return _spec_bits(kb, np.concatenate(rows))


@pytest.mark.parametrize("log_n,G,Q,groups,levels", [
    (13, 2, 2, 1, None), (9, 1, 3, 2, None), (33, 2, 3, 1, (0, 20, 32)),
])
def test_level_grouped_matches_spec(log_n, G, Q, groups, levels):
    rng = np.random.default_rng(log_n + G)
    n_lv = log_n if levels is None else len(levels)
    K = groups * n_lv * G
    kb, _ = port.gen_batch(rng.integers(0, 1 << log_n, size=K, dtype=np.uint64), log_n, rng)
    xs = rng.integers(0, 1 << log_n, size=(G, Q), dtype=np.uint64)
    want = _grouped_spec(kb, xs, groups, levels)
    full = md.eval_points_level_grouped(kb, xs, groups, levels=levels, device="cpu")
    np.testing.assert_array_equal(full, want)
    reduced = md.eval_points_level_grouped(kb, xs, groups, reduce=True, packed=True,
                                           levels=levels, device="cpu")
    fold = np.bitwise_xor.reduce(want.reshape(groups * n_lv, G, Q), axis=0)
    np.testing.assert_array_equal(reduced, ref_bitpack.pack_bits(fold))


def test_eval_points_rejects_bad_queries():
    kb, _ = port.gen_batch([3, 5], 8, np.random.default_rng(0))
    with pytest.raises(ValueError, match="out of domain"):
        port.eval_points_batch(kb, np.array([[1], [256]], np.uint64), device="cpu")
    with pytest.raises(ValueError, match="match key batch"):
        port.eval_points_batch(kb, np.zeros((3, 2), np.uint64), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        md.eval_points(kb, np.zeros((2, 2), np.uint64), device="cpu", impl="triton")


# ---------------------------------------------------------------------------
# The port's copy of core/bitpack.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q", [1, 31, 32, 33, 100])
def test_bitpack_copy_matches_reference(Q):
    rng = np.random.default_rng(Q)
    bits = rng.integers(0, 2, size=(3, Q), dtype=np.uint8)
    words = rng.integers(0, 1 << 32, size=(3, -(-Q // 32)), dtype=np.uint32)
    np.testing.assert_array_equal(bitpack.pack_bits(bits), ref_bitpack.pack_bits(bits))
    np.testing.assert_array_equal(bitpack.unpack_bits(words, Q),
                                  ref_bitpack.unpack_bits(words, Q))
    np.testing.assert_array_equal(bitpack.mask_tail(words, Q), ref_bitpack.mask_tail(words, Q))
    rows = ref_bitpack.words_to_wire_rows(words, Q)
    np.testing.assert_array_equal(bitpack.byte_rows_to_words(rows, Q),
                                  ref_bitpack.byte_rows_to_words(rows, Q))
    assert bitpack.packed_words(Q) == ref_bitpack.packed_words(Q)
    # The torch packers, key-major and query-major.
    t = torch.from_numpy(bits.astype(np.int32))
    np.testing.assert_array_equal(from_carrier(bitpack.pack_bits_torch(t)),
                                  ref_bitpack.pack_bits(bits))
    np.testing.assert_array_equal(from_carrier(bitpack.pack_bits_qmajor_torch(t.T)),
                                  ref_bitpack.pack_bits(bits))


# ---------------------------------------------------------------------------
# Empty batches: no keys, or no queries (ROADMAP C.1)
# ---------------------------------------------------------------------------

EMPTY_LOG_N = 6


def _empty_call(pkg, case, packed):
    """One empty-batch call of ``pkg`` (dpf_tpu or the port) at log_n 6 on
    keys from default_rng(0): alphas [3, 5] with xs uint64[2, 0]; no alphas
    with xs uint64[0, 4]; a grouped batch of 2 gates (12 keys) with Q 0, in
    full, reduced, and through ``levels=``."""
    ref = pkg is dpf_tpu
    model = ref_dpf if ref else md
    kw = {} if ref else {"device": "cpu"}
    if case in ("Q0", "K0"):
        alphas = [3, 5] if case == "Q0" else np.zeros(0, np.uint64)
        kb, _ = pkg.gen_batch(alphas, EMPTY_LOG_N, np.random.default_rng(0))
        xs = np.zeros((2, 0) if case == "Q0" else (0, 4), np.uint64)
        return pkg.eval_points_batch(kb, xs, packed=packed, **kw)
    kb, _ = pkg.gen_batch(np.arange(12, dtype=np.uint64), EMPTY_LOG_N,
                          np.random.default_rng(0))
    levels = tuple(range(EMPTY_LOG_N)) if case.startswith("levels") else None
    return model.eval_points_level_grouped(kb, np.zeros((2, 0), np.uint64), 1,
                                           reduce=case.endswith("reduced"),
                                           packed=packed, levels=levels, **kw)


EMPTY_SHAPES = {"Q0": (2, 0), "K0": (0, 4), "grouped": (12, 0), "grouped_reduced": (2, 0),
                "levels": (12, 0), "levels_reduced": (2, 0)}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("case", list(EMPTY_SHAPES))
def test_empty_batches_match_reference(monkeypatch, case, packed):
    want = _empty_call(dpf_tpu, case, packed)
    # Nothing is walked: the entry returns before it builds an operand.
    monkeypatch.setattr(md, "_point_masks", None)
    got = _empty_call(port, case, packed)
    rows, q = EMPTY_SHAPES[case]
    assert got.shape == want.shape == ((rows, bitpack.packed_words(q)) if packed else (rows, q))
    assert got.dtype == want.dtype == (np.uint32 if packed else np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
def test_grouped_batch_of_no_gates_is_empty(packed):
    # The reference's packed form raises here (a reshape of no gates); the
    # port returns the empty rows.
    kb, _ = port.gen_batch(np.zeros(0, np.uint64), EMPTY_LOG_N, np.random.default_rng(0))
    got = md.eval_points_level_grouped(kb, np.zeros((0, 5), np.uint64), 1, reduce=True,
                                       packed=packed, device="cpu")
    assert got.shape == ((0, 1) if packed else (0, 5))
