"""Heavy hitters (``dpf_tpu_torch/apps``) against the JAX package.

At ``bench_all.py``'s small size (256 clients, n=10, 4 planted values x 16
clients, threshold 8, seed 24), for both profiles: the dealt shares' bytes;
the port's ``FrontierState`` rows over the descent's round sequence, for
both aggregators, against ``dpf_tpu.apps.hh_state.FrontierState`` on the
same shares (carried across through ``interop.from_jax_hhshare``); the
incremental and stateless ``find_heavy_hitters`` against the reference's
incremental descent (its stateless one gives the same hitters and rounds by
contract, and compiles a walk per round bucket: some 12 s in the compat
profile), the stateless rounds' PRG evaluations against the reference's
from-root count; the heavy-hitter bodies of ``models/dpf.py`` and
``models/dpf_chacha.py`` against the JAX bodies at the descent's shapes (so
their compiles are the descent's); ``reconstruct_counts`` and the count fold
against the reference's; the wire helpers of ``core/bitpack.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dpf_tpu.apps import heavy_hitters as ref_hh  # noqa: E402
from dpf_tpu.apps import hh_state as ref_hs  # noqa: E402
from dpf_tpu.core import bitpack as ref_bitpack  # noqa: E402
from dpf_tpu.models import dpf as ref_dpf  # noqa: E402
from dpf_tpu.models import dpf_chacha as ref_dc  # noqa: E402
from dpf_tpu.models import hh_fold as ref_hh_fold  # noqa: E402
from dpf_tpu_torch import interop  # noqa: E402
from dpf_tpu_torch.apps import heavy_hitters as hh  # noqa: E402
from dpf_tpu_torch.apps import hh_state  # noqa: E402
from dpf_tpu_torch.core import bitpack  # noqa: E402
from dpf_tpu_torch.models import dpf as md  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as mdc  # noqa: E402
from dpf_tpu_torch.models import hh_fold  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402

G, N, PER, THR = 256, 10, 16, 8
PLANTED = np.array([5, 1234 % (1 << N), (1 << N) - 7, (1 << N) // 3], np.uint64)


def _values():
    rng = np.random.default_rng(24)
    vals = rng.integers(0, 1 << N, size=G, dtype=np.uint64)
    for i, hv in enumerate(PLANTED):
        vals[i * PER : (i + 1) * PER] = hv
    return vals


def _round_sequence(vals, levels_per_round=4):
    """The descent's (candidates, depth) per round: survivors are the
    prefixes at least THR values start with (the protocol's exact counts)."""
    frontier, depth, seq = np.zeros(1, np.uint64), 0, []
    while depth < N and frontier.size:
        r = min(levels_per_round, N - depth)
        cands = ((frontier[:, None] << np.uint64(r))
                 | np.arange(1 << r, dtype=np.uint64)[None, :]).reshape(-1)
        depth += r
        seq.append((cands, depth))
        prefixes = vals >> np.uint64(N - depth)
        frontier = cands[np.array([(prefixes == c).sum() >= THR for c in cands])]
    return seq


def _port_share(ref_share):
    lv = ref_share.levels
    return interop.from_jax_hhshare(ref_share.log_n, ref_share.profile, lv.seeds, lv.ts,
                                    lv.scw, lv.tcw, lv.fcw)


@pytest.fixture(scope="module", params=["compat", "fast"])
def case(request):
    """The reference's shares, descents and frontier rows of one profile."""
    profile = request.param
    vals = _values()
    ra, rb = ref_hh.gen_shares(vals, N, profile, rng=np.random.default_rng(24))
    seq = _round_sequence(vals)
    rows = []
    for share in (ra, rb):
        fs = ref_hs.FrontierState(profile, share.level_keys(N - 1))
        rows.append([fs.advance(c, d) for c, d in seq])
    result = ref_hh.find_heavy_hitters(ra, rb, threshold=THR, state=True)
    return dict(profile=profile, vals=vals, ra=ra, rb=rb, seq=seq, rows=rows,
                result=result, pa=_port_share(ra), pb=_port_share(rb))


def test_gen_shares_bytes_match_reference(case):
    pa, pb = hh.gen_shares(case["vals"], N, case["profile"], rng=np.random.default_rng(24),
                           device="cpu")
    for got, want in ((pa, case["ra"]), (pb, case["rb"])):
        assert got.levels.to_bytes() == want.levels.to_bytes()
        blob = hh.share_to_blob(got)
        assert blob == ref_hh.share_to_blob(want)
        back = hh.share_from_blob(blob, N, G, case["profile"])
        assert back.levels.to_bytes() == got.levels.to_bytes()


def test_frontier_rows_match_reference(case):
    for share, want in zip((case["pa"], case["pb"]), case["rows"]):
        fs = hh_state.FrontierState(case["profile"], share.level_keys(N - 1), device="cpu")
        for (cands, depth), w in zip(case["seq"], want):
            got = fs.advance(cands, depth)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, w)
        with pytest.raises(hh_state.StaleState):  # inside the tree it must deepen
            fs.advance(np.arange(2, dtype=np.uint64), 1)
        fs.reset()  # a root replant serves any depth, byte for byte
        np.testing.assert_array_equal(fs.advance(*case["seq"][0]), want[0])


@pytest.mark.parametrize("state", [True, False], ids=["incremental", "stateless"])
def test_find_heavy_hitters_matches_reference(case, state):
    got = hh.find_heavy_hitters(case["pa"], case["pb"], threshold=THR, state=state,
                                device="cpu")
    want = case["result"]
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.counts, want.counts)
    vals = case["vals"]
    assert {int(v): int(c) for v, c in zip(got.values, got.counts)} == {
        int(v): int((vals == v).sum()) for v in PLANTED}
    assert [(r.depth, r.levels, r.n_candidates, r.n_survivors, r.key_evals)
            for r in got.rounds] == [(r.depth, r.levels, r.n_candidates, r.n_survivors,
                                      r.key_evals) for r in want.rounds]
    if state:
        assert [r.prg_level_evals for r in got.rounds] == [
            r.prg_level_evals for r in want.rounds]
    else:  # every stateless round walks from the root
        nu = case["pa"].levels.nu
        assert [r.prg_level_evals for r in got.rounds] == [
            2 * ref_hs.stateless_round_evals(nu, G, r.n_candidates) for r in got.rounds]


def test_callable_aggregators_take_wire_bytes(case):
    # Callables evaluate stateless; a reply of packed wire bytes is read
    # through bitpack.wire_to_words.
    def agg(share):
        def call(level, cands):
            rows = hh.eval_level_shares(share, level, cands, device="cpu")
            return bitpack.words_to_wire(rows, len(cands))
        return call

    got = hh.find_heavy_hitters(agg(case["pa"]), agg(case["pb"]), log_n=N, threshold=THR,
                                device="cpu")
    np.testing.assert_array_equal(got.values, case["result"].values)
    np.testing.assert_array_equal(got.counts, case["result"].counts)


def test_device_failure_propagates(case, monkeypatch):
    # No recovery branch: a failure in the frontier's extension leaves the
    # descent; it does not finish stateless.
    def fail(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(hh_state.FrontierState, "_tree_step", fail)
    with pytest.raises(RuntimeError, match="device fault"):
        hh.find_heavy_hitters(case["pa"], case["pb"], threshold=THR, device="cpu")


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("phase", ["extend", "leaf_first", "leaf_fold"])
def test_compat_hh_bodies_match_reference(phase):
    # The descent's shapes: K 256 (Kp 8), bucket 32, 16 gathered parents,
    # ibits 7.
    rng = np.random.default_rng(len(phase))
    S, T = _u32(rng, 128, 32, 8), _u32(rng, 32, 8)
    sel = rng.integers(0, 32, size=16).astype(np.int32)
    sel_t = torch.from_numpy(sel.astype(np.int64))
    if phase == "extend":
        cw, tl, tr = _u32(rng, 128, 8), _u32(rng, 8), _u32(rng, 8)
        cw[0] = 0
        want = ref_dpf._hh_extend_jit(*(jnp.asarray(a) for a in (S, T, sel, cw, tl, tr)))
        c = [to_carrier(a) for a in (S, T)]
        got = md._hh_extend_body(c[0], c[1], sel_t, *(to_carrier(a) for a in (cw, tl, tr)))
    elif phase == "leaf_first":
        fcw = _u32(rng, 128, 1, 8)
        want = ref_dpf._hh_leaf_first_jit(7, *(jnp.asarray(a) for a in (S, T, sel, fcw)))
        got = md._hh_leaf_first_body(7, to_carrier(S), to_carrier(T), sel_t, to_carrier(fcw))
    else:
        C = _u32(rng, 128, 16, 8)
        idx = rng.integers(0, 16 * 4, size=32).astype(np.int32)
        want = (ref_dpf._hh_leaf_fold_jit(2, 7, jnp.asarray(C), jnp.asarray(idx)),)
        got = (md._hh_leaf_fold_body(2, 7, to_carrier(C),
                                     torch.from_numpy(idx.astype(np.int64))),)
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_array_equal(from_carrier(g)[: w.shape[0]], w)


@pytest.mark.parametrize("phase", ["extend", "leaf_first", "leaf_fold"])
def test_fast_hh_bodies_match_reference(phase):
    # The descent's shapes: K 256, bucket 32, 16 gathered parents, ibits 9.
    rng = np.random.default_rng(10 + len(phase))
    K = 256
    words = [_u32(rng, K, 32) for _ in range(4)]
    words[0] &= ~np.uint32(1)
    T = rng.integers(0, 2, size=(K, 32), dtype=np.uint32)
    state = to_carrier(np.stack(words + [T]))
    sel = rng.integers(0, 32, size=16).astype(np.int32)
    sel_t = torch.from_numpy(sel.astype(np.int64))
    jwords = [jnp.asarray(a) for a in words + [T]]
    if phase == "extend":
        scw = _u32(rng, K, 1, 4)
        scw[:, :, 0] &= ~np.uint32(1)
        tcw = rng.integers(0, 2, size=(K, 1, 2), dtype=np.uint32)
        want = ref_dc._hh_extend_cc_jit(
            *jwords, jnp.asarray(sel), *(jnp.asarray(scw[:, 0, i]) for i in range(4)),
            jnp.asarray(tcw[:, 0, 0]), jnp.asarray(tcw[:, 0, 1]))
        new, rows = mdc._hh_extend_cc_body(state, sel_t, to_carrier(scw), to_carrier(tcw))
        got = [new[i] for i in range(5)] + [rows]
    elif phase == "leaf_first":
        fcw = _u32(rng, K, 16)
        want = ref_dc._hh_leaf_first_cc_jit(
            9, *jwords, jnp.asarray(sel), *(jnp.asarray(fcw[:, j]) for j in range(16)))
        got = mdc._hh_leaf_first_cc_body(
            9, state, sel_t, torch.zeros((K, 0, 4), dtype=torch.int32),
            torch.zeros((K, 0, 2), dtype=torch.int32), to_carrier(fcw))
    else:
        P = _u32(rng, K, 16, 16)
        idx = rng.integers(0, 16 * 4, size=32).astype(np.int32)
        want = (ref_dc._hh_leaf_fold_cc_jit(2, 9, jnp.asarray(P), jnp.asarray(idx)),)
        got = (mdc._hh_leaf_fold_cc_body(2, 9, to_carrier(P),
                                         torch.from_numpy(idx.astype(np.int64))),)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(from_carrier(g), np.asarray(w))


@pytest.mark.parametrize("ibits,m", [(7, 1), (7, 7), (3, 2), (9, 4), (9, 9), (1, 1)])
def test_leaf_folds_match_reference(ibits, m):
    # The compat leaf holds 2**7 bits, the fast one 2**9.
    rng = np.random.default_rng(ibits * 10 + m)
    if ibits <= 7:
        C = _u32(rng, 128, 3, 2)
        np.testing.assert_array_equal(
            from_carrier(md.hh_leaf_fold_planes(to_carrier(C), m, ibits)),
            np.asarray(ref_dpf.hh_leaf_fold_planes(jnp.asarray(C), m, ibits)))
    P = _u32(rng, 5, 3, 16)
    np.testing.assert_array_equal(from_carrier(mdc.hh_leaf_fold_cc(to_carrier(P), m, ibits)),
                                  np.asarray(ref_dc.hh_leaf_fold_cc(jnp.asarray(P), m, ibits)))


@pytest.mark.parametrize("q", [1, 31, 64, 100, 200])
def test_reconstruct_counts_match_reference(q):
    rng = np.random.default_rng(q)
    a, b = _u32(rng, G, 4), _u32(rng, G, 4)
    want = ref_hh.reconstruct_counts(a, b, q)
    for fold in ("host", "device", "auto"):
        got = hh.reconstruct_counts(a, b, q, fold=fold, device="cpu")
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_count_fold_matches_reference():
    x = _u32(np.random.default_rng(3), G, 16)
    np.testing.assert_array_equal(hh_fold.count_fold(x, device="cpu"),
                                  ref_hh_fold.count_fold(x))


@pytest.mark.parametrize("q", [1, 7, 8, 31, 33, 64, 100])
def test_wire_helpers_match_reference(q):
    words = _u32(np.random.default_rng(q), 3, bitpack.packed_words(q))
    assert bitpack.packed_bytes(q) == ref_bitpack.packed_bytes(q)
    np.testing.assert_array_equal(bitpack.words_to_wire_rows(words, q),
                                  ref_bitpack.words_to_wire_rows(words, q))
    blob = bitpack.words_to_wire(words, q)
    assert blob == ref_bitpack.words_to_wire(words, q)
    np.testing.assert_array_equal(bitpack.wire_to_words(blob, 3, q),
                                  ref_bitpack.wire_to_words(blob, 3, q))


def test_threshold_must_be_explicit(case):
    with pytest.raises(ValueError, match="threshold"):
        hh.find_heavy_hitters(case["pa"], case["pb"], device="cpu")
