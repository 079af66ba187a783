"""The port's FSS gates (dpf_tpu_torch.fss, models/fss.py) against
dpf_tpu.models.fss, and the slice end to end.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Gates
and queries come from numpy.random.default_rng(seed); the port evaluates on
device="cpu", where the walk wrappers run their plain PyTorch versions.  The
JAX references run once per module: the fast profile's comparison and
interval gates and ``ge_full_from_dpf`` at log_n 12, and ONE compat gate
call (comparison, log_n 8; a compat JAX gate call costs 2.5-12 s here,
growing with log_n).  The
compat ``ge_full_from_dpf`` is held to the prefix XOR of the numpy spec's
``eval_full`` instead (the compat ``eval_full`` itself is held to JAX by
tests/port/test_torch_dpf.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dpf_tpu.core import bitpack as ref_bitpack  # noqa: E402
from dpf_tpu.core import spec as ref_spec  # noqa: E402
from dpf_tpu.models import fss as ref_fss  # noqa: E402

import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu_torch import fast, fss  # noqa: E402
from dpf_tpu_torch.interop import from_jax_keybatch, from_jax_keybatch_fast  # noqa: E402
from dpf_tpu_torch.models import dcf  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402

Q = 40
REF_LOG_N = {"fast": 12, "compat": 8}


def _port_levels(kb, profile):
    conv = from_jax_keybatch_fast if profile == "fast" else from_jax_keybatch
    return conv(kb.log_n, kb.seeds, kb.ts, kb.scw, kb.tcw, kb.fcw)


def _port_cmp(ck):
    return fss.CmpKeyBatch(ck.log_n, _port_levels(ck.levels, ck.profile), ck.profile)


def _port_interval(ik):
    return fss.IntervalKeyBatch(_port_cmp(ik.upper), _port_cmp(ik.lower), ik.const.copy())


def _edge_gates(log_n, seed):
    """alphas with 0, 1, 2^n - 1 and a random point; queries at each alpha
    and the point below it."""
    rng = np.random.default_rng(seed)
    alphas = np.array([0, 1, (1 << log_n) - 1, rng.integers(0, 1 << log_n)], np.uint64)
    xs = rng.integers(0, 1 << log_n, size=(len(alphas), Q), dtype=np.uint64)
    xs[:, 0] = alphas
    xs[:, 1] = np.maximum(alphas, np.uint64(1)) - np.uint64(1)
    return alphas, xs


def _interval_bounds(log_n):
    """(lo, hi): the wrap edge hi = 2^n - 1, the whole domain, one point,
    a random range."""
    top = (1 << log_n) - 1
    return (np.array([5, 0, 77, 100], np.uint64),
            np.array([top, top, 77, top // 2 + 60], np.uint64))


@pytest.fixture(scope="module")
def jax_gates():
    """Per profile: the reference's gate pairs from default_rng(log_n) and
    party A's comparison shares; for the fast profile also the interval
    gates and their shares."""
    out = {}
    for profile, log_n in REF_LOG_N.items():
        alphas, xs = _edge_gates(log_n, seed=log_n)
        ca, cb = ref_fss.gen_lt_batch(alphas, log_n, rng=np.random.default_rng(log_n),
                                      profile=profile)
        case = dict(alphas=alphas, xs=xs, ca=ca, cb=cb, lt=ref_fss.eval_lt_points(ca, xs))
        if profile == "fast":
            lo, hi = _interval_bounds(log_n)
            ia, ib = ref_fss.gen_interval_batch(lo, hi, log_n,
                                                rng=np.random.default_rng(log_n + 1),
                                                profile=profile)
            case.update(lo=lo, hi=hi, ia=ia, ib=ib,
                        interval=ref_fss.eval_interval_points(ia, xs))
        out[profile] = case
    return out


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_gen_lt_batch_blobs_match_reference(jax_gates, profile):
    c = jax_gates[profile]
    log_n = REF_LOG_N[profile]
    got = fss.gen_lt_batch(c["alphas"], log_n, np.random.default_rng(log_n), profile, device="cpu")
    for g, w in zip(got, (c["ca"], c["cb"])):
        assert g.to_bytes() == w.to_bytes()
        assert g.g == w.g == 4 and g.profile == profile
    back = fss.CmpKeyBatch.from_bytes(got[0].to_bytes(), log_n, profile)
    assert back.levels.to_bytes() == got[0].levels.to_bytes()


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_gen_interval_batch_blobs_match_reference(profile):
    log_n = 9
    lo, hi = _interval_bounds(log_n)
    want = ref_fss.gen_interval_batch(lo, hi, log_n, rng=np.random.default_rng(3),
                                      profile=profile)
    got = fss.gen_interval_batch(lo, hi, log_n, np.random.default_rng(3), profile, device="cpu")
    for g, w in zip(got, want):
        assert g.upper.to_bytes() == w.upper.to_bytes()
        assert g.lower.to_bytes() == w.lower.to_bytes()
        np.testing.assert_array_equal(g.const, w.const)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_eval_lt_points_matches_reference(jax_gates, profile, packed):
    c = jax_gates[profile]
    got = fss.eval_lt_points(_port_cmp(c["ca"]), c["xs"], packed=packed, device="cpu")
    want = c["lt"]
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want) if packed else want)
    rec = got ^ fss.eval_lt_points(_port_cmp(c["cb"]), c["xs"], packed=packed, device="cpu")
    lt = c["xs"] < c["alphas"][:, None]
    np.testing.assert_array_equal(rec, ref_bitpack.pack_bits(lt) if packed else lt)


@pytest.mark.parametrize("packed", [False, True])
def test_eval_interval_points_matches_reference(jax_gates, packed):
    c = jax_gates["fast"]
    ia = _port_interval(c["ia"])
    got = fss.eval_interval_points(ia, c["xs"], packed=packed, device="cpu")
    want = c["interval"]
    np.testing.assert_array_equal(got, ref_bitpack.pack_bits(want) if packed else want)
    assert ia._both is not None and ia._both[2].k == 2 * REF_LOG_N["fast"] * 4
    rec = got ^ fss.eval_interval_points(_port_interval(c["ib"]), c["xs"], packed=packed,
                                         device="cpu")
    inside = (c["lo"][:, None] <= c["xs"]) & (c["xs"] <= c["hi"][:, None])
    np.testing.assert_array_equal(rec, ref_bitpack.pack_bits(inside) if packed else inside)


def test_grouped_walk_equals_host_expanded_queries(jax_gates):
    # The grouped walk's on-device masking is the host-expanded dyadic-prefix
    # queries of _masked_prefix_queries, folded over the levels.
    c = jax_gates["fast"]
    ck, n = _port_cmp(c["ca"]), REF_LOG_N["fast"]
    q = fss._masked_prefix_queries(c["xs"], n)
    np.testing.assert_array_equal(q, ref_fss._masked_prefix_queries(c["xs"], n))
    bits = fast.eval_points_batch(ck.levels, q, device="cpu")
    np.testing.assert_array_equal(np.bitwise_xor.reduce(bits.reshape(n, ck.g, -1), axis=0),
                                  fss.eval_lt_points(ck, c["xs"], device="cpu"))


# ---------------------------------------------------------------------------
# Reconstruction, both profiles: the wrap edge and a deep domain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("profile,log_n", [("compat", 9), ("compat", 33), ("fast", 11),
                                           ("fast", 33)])
def test_interval_reconstructs(profile, log_n, packed):
    lo, hi = _interval_bounds(log_n)
    rng = np.random.default_rng(log_n)
    xs = rng.integers(0, 1 << log_n, size=(4, 9), dtype=np.uint64)
    xs[:, 0], xs[:, 1], xs[:, 2] = lo, hi, np.maximum(lo, np.uint64(1)) - np.uint64(1)
    ia, ib = fss.gen_interval_batch(lo, hi, log_n, rng, profile, device="cpu")
    rec = (fss.eval_interval_points(ia, xs, packed=packed, device="cpu")
           ^ fss.eval_interval_points(ib, xs, packed=packed, device="cpu"))
    inside = (lo[:, None] <= xs) & (xs <= hi[:, None])
    np.testing.assert_array_equal(rec, ref_bitpack.pack_bits(inside) if packed else inside)


# ---------------------------------------------------------------------------
# ge_full_from_dpf and the prefix XOR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_xor_words_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(3, 37), dtype=np.uint32)
    w[:, ::3] |= np.uint32(1 << 31)  # bit 31 set in every third word
    w[1] = 0
    w[2, 5] = np.uint32(1 << 31)
    want = np.asarray(ref_fss._prefix_xor_words(jnp.asarray(w)))
    np.testing.assert_array_equal(from_carrier(fss._prefix_xor_words(to_carrier(w))), want)


def _ge(table, log_n):
    """uint8 bit-packed rows -> 0/1 bits over the domain."""
    return np.unpackbits(table, axis=1, bitorder="little")[:, : 1 << log_n]


def test_ge_full_from_dpf_fast_matches_reference():
    log_n = 12
    alphas = np.array([0, 1, 4095, 1234, 511, 512], np.uint64)
    ka, kb = fast.gen_batch(alphas, log_n, np.random.default_rng(4), device="cpu")
    from dpf_tpu.models.keys_chacha import KeyBatchFast as RefBatch

    ref_a = RefBatch.from_bytes(ka.to_bytes(), log_n)
    got = fss.ge_full_from_dpf(ka, device="cpu")
    np.testing.assert_array_equal(got, ref_fss.ge_full_from_dpf(ref_a))
    rec = _ge(got ^ fss.ge_full_from_dpf(kb, device="cpu"), log_n)
    np.testing.assert_array_equal(rec, np.arange(1 << log_n)[None] >= alphas[:, None])


@pytest.mark.parametrize("log_n", [6, 11])
def test_ge_full_from_dpf_compat_matches_spec(log_n):
    # K = 3 pads to 32 keys inside the evaluator; the rows are sliced back.
    alphas = np.array([0, (1 << log_n) - 1, 37], np.uint64)
    ka, kb = port.gen_batch(alphas, log_n, np.random.default_rng(log_n), device="cpu")
    got = fss.ge_full_from_dpf(ka, device="cpu")
    spec_rows = np.stack([np.frombuffer(ref_spec.eval_full(k, log_n), np.uint8)
                          for k in ka.to_bytes()])
    want = np.bitwise_xor.accumulate(_ge(spec_rows, log_n), axis=1)
    np.testing.assert_array_equal(_ge(got, log_n), want)
    assert got.shape == spec_rows.shape
    rec = _ge(got ^ fss.ge_full_from_dpf(kb, device="cpu"), log_n)
    np.testing.assert_array_equal(rec, np.arange(1 << log_n)[None] >= alphas[:, None])


def test_reference_compat_ge_full_runs_the_per_level_kernels(monkeypatch):
    # The reference's compat eval_full_device (under ge_full_from_dpf) takes
    # its level-fused kernel, aes_pallas._fused_levels_kernel_bm, only when
    # DPF_TPU_FUSE asks for it.  Unset, the knob is "off" and every domain
    # runs the per-level PRG and leaf kernels (_prg_kernel_bm,
    # _mmo_canon_kernel_bm), whose counterparts the port's compat
    # eval_full_device launches.
    from dpf_tpu.core import knobs
    from dpf_tpu.models import dpf as ref_dpf

    monkeypatch.delenv("DPF_TPU_FUSE", raising=False)
    assert knobs.knob("DPF_TPU_FUSE").default == "off"
    assert all(ref_dpf._fuse_plan(nu, "pallas_bm", None) is None for nu in range(64))
    monkeypatch.setenv("DPF_TPU_FUSE", "2")  # the option that does fuse
    assert ref_dpf._fuse_plan(13, "pallas_bm", None) == (7, (2, 2, 2))


# ---------------------------------------------------------------------------
# The slice end to end, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", ["dcf", "fss-compat", "fss-fast"])
def test_slice_end_to_end(gate):
    # Config 5's shape cut down: gen of both parties on the host, then the
    # gate shares of both, then reconstruction, comparison and interval.
    log_n, G = {"dcf": (13, 6), "fss-compat": (10, 3), "fss-fast": (12, 4)}[gate]
    rng = np.random.default_rng(55)
    alphas = rng.integers(0, 1 << log_n, size=G, dtype=np.uint64)
    xs = rng.integers(0, 1 << log_n, size=(G, 48), dtype=np.uint64)
    xs[:, 0] = alphas
    lo = np.minimum(alphas, xs[:, 5])
    hi = np.maximum(alphas, xs[:, 5])
    if gate == "dcf":
        lt_a, lt_b = fast.dcf_gen_lt_batch(alphas, log_n, rng, device="cpu")
        iv_a, iv_b = fast.dcf_gen_interval_batch(lo, hi, log_n, rng, device="cpu")
        lt_eval, iv_eval = fast.dcf_eval_lt_points, fast.dcf_eval_interval_points
    else:
        profile = gate.split("-")[1]
        lt_a, lt_b = port.fss.gen_lt_batch(alphas, log_n, rng, profile, device="cpu")
        iv_a, iv_b = port.fss.gen_interval_batch(lo, hi, log_n, rng, profile, device="cpu")
        lt_eval, iv_eval = port.fss.eval_lt_points, port.fss.eval_interval_points
    rec = lt_eval(lt_a, xs, device="cpu") ^ lt_eval(lt_b, xs, device="cpu")
    np.testing.assert_array_equal(rec, xs < alphas[:, None])
    rec = iv_eval(iv_a, xs, device="cpu") ^ iv_eval(iv_b, xs, device="cpu")
    np.testing.assert_array_equal(rec, (lo[:, None] <= xs) & (xs <= hi[:, None]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="unknown profile"):
        fss.gen_lt_batch([1], 8, profile="aes", device="cpu")
    with pytest.raises(ValueError, match="out of domain"):
        fss.gen_lt_batch([256], 8, device="cpu")
    with pytest.raises(ValueError, match="lo > hi"):
        fss.gen_interval_batch([5], [4], 8, device="cpu")
    ca, _ = fss.gen_lt_batch([3, 5], 8, np.random.default_rng(0), "fast", device="cpu")
    with pytest.raises(ValueError, match=r"\[G, Q\]"):
        fss.eval_lt_points(ca, np.zeros((3, 2), np.uint64), device="cpu")
    with pytest.raises(ValueError, match="blob length"):
        fss.CmpKeyBatch.from_bytes([b"\0" * 5], 8, "fast")


def test_without_cuda_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xs = np.array([[1, 5], [9, 200]], np.uint64)
    for profile in ("compat", "fast"):
        ca, _ = fss.gen_lt_batch([3, 5], 8, np.random.default_rng(0), profile, device="cpu")
        ia, _ = fss.gen_interval_batch([1, 2], [3, 4], 8, np.random.default_rng(0), profile, device="cpu")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fss.eval_lt_points(ca, xs)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fss.eval_interval_points(ia, xs)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fss.ge_full_from_dpf(ca.levels)
        assert fss.eval_lt_points(ca, xs, device="cpu").shape == (2, 2)


@pytest.mark.parametrize("name", fss.__all__)
def test_entry_signatures_follow_the_reference(name):
    import inspect

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    want, have = params(getattr(ref_fss, name)), params(getattr(fss, name))
    if name in ("CmpKeyBatch", "IntervalKeyBatch"):
        assert [n for n, _ in have] == [n for n, _ in want]
    else:
        assert have[: len(want)] == want
        assert [n for n, _ in have[len(want):]] in ([], ["device"])


def test_fss_is_served_by_the_package():
    assert port.fss is fss
    assert dcf.DcfKeyBatch is fast.DcfKeyBatch
