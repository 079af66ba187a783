"""The port's streaming full-domain evaluation (``eval_full_stream`` of both
profiles, ``core/stream.py``) against dpf_tpu's.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Keys
come from numpy.random.default_rng(seed); the port runs on device="cpu",
where its kernel wrappers run their plain PyTorch versions along the card's
routes.  The reference's compat stream runs its Pallas kernels in interpret
mode, whose compile costs seconds a shape, so its cases are few, shallow
(nu <= 1) and computed once for the module; the cases that share a key
padding and a split share the reference's compiles.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu.core.keys import gen_batch as ref_gen_batch  # noqa: E402
from dpf_tpu.models import dpf as ref_dpf  # noqa: E402
from dpf_tpu.models import dpf_chacha as ref_dpf_chacha  # noqa: E402
from dpf_tpu.models.keys_chacha import gen_batch as ref_gen_fast  # noqa: E402
from dpf_tpu_torch.core import stream  # noqa: E402
from dpf_tpu_torch.core.keys import KeyBatch, gen_batch  # noqa: E402
from dpf_tpu_torch.core.keys_chacha import KeyBatchFast  # noqa: E402
from dpf_tpu_torch.core.keys_chacha import gen_batch as gen_fast  # noqa: E402
from dpf_tpu_torch.models import dpf as md  # noqa: E402
from dpf_tpu_torch.models import dpf_chacha as mdc  # noqa: E402
from dpf_tpu_torch.ops import chacha_cuda as cp  # noqa: E402

# (log_n, K, max_plane_words, min_chunks, backend): nu = 0 gives c = 0,
# nu = 1 gives c = 1.  K 1 and 5 pad to one key word and share the
# reference's compiles; K 33 pads to two.
COMPAT_CASES = [
    (7, 33, 4, 4, "pallas"),  # c = 0
    (8, 5, 1 << 19, 2, "pallas_bm"),  # c = 1
    (8, 1, 4, 4, "pallas_bm"),  # c = 1
]
# (log_n, K, max_leaf_nodes, min_chunks): c = 0; c = 3 from the cap (33
# keys of 8 leaves, 64 a chunk); c = 2 from min_chunks.
FAST_CASES = [(9, 1, 1 << 23, 2), (12, 33, 64, 2), (12, 5, 1 << 23, 4)]


def _alphas(log_n, K, seed):
    return np.random.default_rng(seed).integers(0, 1 << log_n, size=K, dtype=np.uint64)


@pytest.fixture(scope="module")
def compat_reference():
    """dpf_tpu's eval_full_stream at each COMPAT_CASES case, run once:
    {case: (key bytes, blocks, events)}."""
    out = {}
    for case in COMPAT_CASES:
        log_n, K, mpw, mc, backend = case
        ka, _ = ref_gen_batch(_alphas(log_n, K, K), log_n, rng=np.random.default_rng(K))
        ev = []
        blocks = list(ref_dpf.eval_full_stream(ka, mpw, backend, mc, ev))
        out[case] = (ka.to_bytes(), blocks, ev)
    return out


@pytest.fixture(scope="module")
def fast_reference():
    """dpf_tpu's fast eval_full_stream (XLA on the CPU) at each FAST_CASES
    case, run once: {case: (key bytes, blocks, events)}."""
    out = {}
    for case in FAST_CASES:
        log_n, K, cap, mc = case
        ka, _ = ref_gen_fast(_alphas(log_n, K, K), log_n, rng=np.random.default_rng(K))
        ev = []
        blocks = list(ref_dpf_chacha.eval_full_stream(ka, cap, mc, ev))
        out[case] = (ka.to_bytes(), blocks, ev)
    return out


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", COMPAT_CASES, ids=str)
def test_compat_stream_matches_reference(compat_reference, case):
    log_n, K, mpw, mc, backend = case
    keys, want, want_ev = compat_reference[case]
    ev = []
    got = list(md.eval_full_stream(KeyBatch.from_bytes(keys, log_n), mpw, backend, mc, ev,
                                   device="cpu"))
    _same_blocks(got, want)
    assert ev == want_ev


@pytest.mark.parametrize("case", FAST_CASES, ids=str)
def test_fast_stream_matches_reference(fast_reference, case):
    log_n, K, cap, mc = case
    keys, want, want_ev = fast_reference[case]
    ev = []
    got = list(mdc.eval_full_stream(KeyBatchFast.from_bytes(keys, log_n), cap, mc, ev,
                                    device="cpu"))
    _same_blocks(got, want)
    assert ev == want_ev


# Port-only cases, against the port's blocking eval_full: deeper trees and
# more chunks than the reference can afford here.
@pytest.mark.parametrize("log_n,K,mpw,mc,backend,c", [
    (10, 5, 1, 2, "pallas_bm", 3),
    (10, 33, 1 << 19, 8, "xla", 3),
    (11, 40, 8, 2, "pallas_bm_il", 2),
    (3, 2, 1, 4, None, 0),
])
def test_compat_stream_blocks_are_eval_full(log_n, K, mpw, mc, backend, c):
    ka, _ = gen_batch(_alphas(log_n, K, log_n), log_n, np.random.default_rng(log_n), device="cpu")
    ev = []
    blocks = list(md.eval_full_stream(ka, mpw, backend, mc, ev, device="cpu"))
    assert len(blocks) == 1 << c
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  md.eval_full(ka, device="cpu"))
    assert ev == _driver_events(c)


@pytest.mark.parametrize("log_n,K,cap,mc,c", [
    (16, 3, 1 << 23, 2, 1),  # nu 7: the 7-level prefix splits at 1
    (17, 9, 1 << 9, 2, 3),  # 9 keys x 2^8 leaves, 2^9 a chunk: 5 chunks
    (12, 9, 1, 2, 3),  # a leaf a chunk: c = nu
    (3, 2, 1, 8, 0),  # nu 0
])
def test_fast_stream_blocks_are_eval_full(log_n, K, cap, mc, c):
    ka, _ = gen_fast(_alphas(log_n, K, log_n), log_n, np.random.default_rng(log_n), device="cpu")
    blocks = list(mdc.eval_full_stream(ka, cap, mc, device="cpu"))
    assert len(blocks) == 1 << c
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  mdc.eval_full(ka, device="cpu"))


def _driver_events(c):
    """The reference driver's event order for 2^c chunks."""
    n = 1 << c
    ev = [("dispatch", 0)]
    for j in range(1, n):
        ev += [("dispatch", j), ("d2h_start", j - 1), ("d2h_done", j - 1)]
    return ev + [("d2h_start", n - 1), ("d2h_done", n - 1)]


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_blocks_stay_right_while_all_are_held(profile):
    # Each block owns its buffer: a later chunk never overwrites an earlier
    # block that the consumer still holds.
    if profile == "compat":
        ka, _ = gen_batch(_alphas(11, 7, 3), 11, np.random.default_rng(3), device="cpu")
        full = md.eval_full(ka, device="cpu")
        gen = md.eval_full_stream(ka, 8, min_chunks=4, device="cpu")
    else:
        ka, _ = gen_fast(_alphas(13, 7, 3), 13, np.random.default_rng(3), device="cpu")
        full = mdc.eval_full(ka, device="cpu")
        gen = mdc.eval_full_stream(ka, 64, min_chunks=4, device="cpu")
    held = list(gen)
    width = held[0].shape[1]
    assert len(held) >= 4
    for j, block in enumerate(held):
        np.testing.assert_array_equal(block, full[:, j * width : (j + 1) * width])


class _Timer:
    def __init__(self):
        self.phases = []

    def phase(self, name):
        import contextlib

        self.phases.append(name)
        return contextlib.nullcontext()


def test_stream_driver_order_timer_and_ownership():
    src = torch.arange(4 * 3 * 2, dtype=torch.int32).view(4, 3, 2)
    ev, timer = [], _Timer()
    blocks = list(stream.stream_chunks(2, lambda j: src[j : j + 1], lambda w: w.copy(), ev,
                                       timer, device="cpu"))
    assert ev == _driver_events(2)
    assert timer.phases == ["dispatch", "dispatch", "d2h", "dispatch", "d2h", "dispatch",
                            "d2h", "d2h"]
    src.zero_()  # the blocks are copies
    for j, b in enumerate(blocks):
        assert b.dtype == np.uint32
        np.testing.assert_array_equal(b, np.arange(6 * j, 6 * j + 6).reshape(1, 3, 2))


@pytest.mark.parametrize("total,cap,mc,nu", [
    (1, 4, 2, 0), (4, 4, 1, 5), (5, 4, 1, 5), (4, 4, 4, 5), (1 << 20, 1 << 19, 2, 13),
    (1 << 18, 1 << 19, 2, 13), (100, 7, 3, 3), (8, 1, 0, 9),
])
def test_chunk_levels_matches_reference(total, cap, mc, nu):
    from dpf_tpu.core.stream import chunk_levels as ref_chunk_levels

    assert stream.chunk_levels(total, cap, mc, nu) == ref_chunk_levels(total, cap, mc, nu)


def _old_expand_plan_subtrees(nu, k, cap):
    """expand_plan_subtrees as it read before subtree_plan was factored out."""
    kp = k + (-k) % cp._EKT
    n_chunks = -(-(kp << nu) // cap)
    c = min((n_chunks - 1).bit_length(), nu)
    entry = max(c, nu - cp._EXP_LEVELS)
    return cp.SubtreePlan(n_chunks, c, cp.level_groups(c), cp.level_groups(entry - c),
                          nu - entry)


def test_expand_plan_subtrees_is_unchanged():
    for nu in range(0, 26):
        for k in (1, 3, 8, 9, 1024, 131073):
            for cap in (1, 8, 16, 512, 1000, 1 << 23):
                assert cp.expand_plan_subtrees(nu, k, cap) == \
                    _old_expand_plan_subtrees(nu, k, cap), (nu, k, cap)


@pytest.mark.parametrize("nu,c", [(11, 1), (15, 3), (6, 6), (20, 12), (0, 0)])
def test_subtree_plan_covers_the_levels(nu, c):
    plan = cp.subtree_plan(nu, c)
    assert plan.n_chunks == 1 << c and plan.c == c
    assert sum(plan.prefix) == c and plan.entry + plan.tail == nu
    assert max(plan.prefix + plan.groups + [plan.tail]) <= cp._EXP_LEVELS


@pytest.mark.parametrize("profile", ["compat", "fast"])
def test_device_keys_are_built_once_per_batch_and_device(monkeypatch, profile):
    mod, cls, gen = {
        "compat": (md, md.DeviceKeys, gen_batch),
        "fast": (mdc, mdc.DeviceKeysFast, gen_fast),
    }[profile]
    built = []

    class Counting(cls):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(mod, cls.__name__, Counting)
    log_n = 12
    ka, kb = gen(_alphas(log_n, 9, 5), log_n, np.random.default_rng(5), device="cpu")
    first = mod.eval_full(ka, device="cpu")
    np.testing.assert_array_equal(mod.eval_full(ka, device=torch.device("cpu")), first)
    np.testing.assert_array_equal(
        np.concatenate(list(mod.eval_full_stream(ka, min_chunks=4, device="cpu")), 1), first)
    assert len(built) == 1
    assert list(ka._device_keys) == [torch.device("cpu")]
    mod.eval_full(kb, device="cpu")
    assert len(built) == 2
    if profile == "fast":  # the cached keys are the batch padded to 8
        assert ka._device_keys[torch.device("cpu")].k == 16
