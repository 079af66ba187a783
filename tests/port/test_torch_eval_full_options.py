"""The compat EvalFull kernel options of the port (``backend=``, ``fuse=``)
against dpf_tpu, and the model functions' signatures against the reference's.

Byte-exact throughout (integer cryptography: the tolerance is zero).  Inputs
come from numpy.random.default_rng(seed); the port runs on device="cpu",
where its kernel wrappers run their plain PyTorch versions.  The reference's
canonical Pallas kernels run once each in interpret mode at [128, 128]; its
fused kernel is never called here (in interpret mode it takes minutes), so
the fused levels are held to its per-level step instead.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import dpf_tpu  # noqa: E402
import dpf_tpu_torch as port  # noqa: E402
from dpf_tpu.models import dcf as ref_dcf  # noqa: E402
from dpf_tpu.models import dpf as ref_dpf  # noqa: E402
from dpf_tpu.models import dpf_chacha as ref_dpf_chacha  # noqa: E402
from dpf_tpu.models import fss as ref_fss  # noqa: E402
from dpf_tpu.ops import aes_bitslice as ref_bitslice  # noqa: E402
from dpf_tpu.ops import aes_pallas  # noqa: E402
from dpf_tpu_torch import fast  # noqa: E402
from dpf_tpu_torch.core import chacha_np, spec  # noqa: E402
from dpf_tpu_torch.core.keys import KeyBatch  # noqa: E402
from dpf_tpu_torch.models import dcf, dpf_chacha, fss  # noqa: E402
from dpf_tpu_torch.models import dpf as md  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402

BACKENDS = ("xla", "pallas", "pallas_bm", "pallas_bm_il")
FUSES = (None, 0, 2, 4)


def _planes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _spec_row(kb, i, log_n):
    return np.frombuffer(spec.eval_full(kb.to_bytes()[i], log_n), np.uint8)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference's kernels
# ---------------------------------------------------------------------------


def test_canon_prg_plain_matches_reference_pallas_kernel():
    S = _planes(1, 128, 128)
    L, R = aes_pallas.prg_planes_pallas(jnp.asarray(S))  # interpret mode
    pL, pR = aes_cuda.prg_planes_canon_plain(to_carrier(S))
    np.testing.assert_array_equal(from_carrier(pL), np.asarray(L))
    np.testing.assert_array_equal(from_carrier(pR), np.asarray(R))


def test_canon_mmo_plain_matches_reference_pallas_kernel():
    S = _planes(2, 128, 128)
    O = aes_pallas.mmo_planes_pallas(jnp.asarray(S))  # interpret mode
    np.testing.assert_array_equal(
        from_carrier(aes_cuda.mmo_planes_canon_plain(to_carrier(S))), np.asarray(O))


# The leaf convert's checks: (W, Kp) at one Pallas tile (128 columns, so
# the reference compiles its cipher once a backend); the reference's leaf
# convert of each backend, layout and shape runs once for the module.
LEAF_SHAPES = ((4, 32), (16, 8))
LEAF_CONVERTS = {"xla": aes_cuda.convert_leaves_canon_plain,
                 "pallas_bm": aes_cuda.convert_leaves_bm_plain}


@pytest.fixture(scope="module")
def leaf_reference():
    """The reference's ``_convert_leaves`` (level-major) and
    ``_convert_leaves_fused`` (node-minor) on numpy-seeded planes, control
    words and final CW planes -> {(backend, layout, W, Kp): (S, T, fcw,
    words)}.  Backend ``pallas_bm`` runs its Pallas kernel in interpret mode
    at 128 columns."""
    out = {}
    for backend in LEAF_CONVERTS:
        for layout in ("level_major", "node_minor"):
            for W, kp in LEAF_SHAPES:
                cols = (kp, W) if layout == "node_minor" else (W, kp)
                seed = 700 + 10 * W + kp + (layout == "node_minor")
                S, T, fcw = _planes(seed, 128, *cols), _planes(seed + 1, *cols), \
                    _planes(seed + 2, 128, 1, kp)
                ref = (ref_dpf._convert_leaves_fused if layout == "node_minor"
                       else ref_dpf._convert_leaves)
                words = ref(jnp.asarray(S), jnp.asarray(T), jnp.asarray(fcw), backend)
                out[backend, layout, W, kp] = S, T, fcw, np.asarray(words)
    return out


@pytest.mark.parametrize("W,kp", LEAF_SHAPES)
@pytest.mark.parametrize("layout", ["level_major", "node_minor"])
@pytest.mark.parametrize("backend", sorted(LEAF_CONVERTS))
def test_leaf_convert_plain_matches_reference(leaf_reference, backend, layout, W, kp):
    # The plain leaf convert (the MMO, the final CW under t, the unpack to
    # per-key words) equals the reference's on the same words, bit for bit.
    S, T, fcw, want = leaf_reference[backend, layout, W, kp]
    got = LEAF_CONVERTS[backend](to_carrier(S), to_carrier(T), to_carrier(fcw),
                                 node_minor=layout == "node_minor")
    np.testing.assert_array_equal(from_carrier(got), want)


@pytest.fixture(scope="module")
def interleaved_reference():
    """The reference contract of prg_planes_pallas_bm_il at B = 128 and at a
    width its TPU kernel cannot tile (33): the canonical PRG between the
    plane-order permutes, both widths in one call -> {B: (S, L, R)}."""
    widths = (128, 33)
    S = np.concatenate([_planes(3 + B, 128, B) for B in widths], axis=1)
    L, R = (np.asarray(x)[aes_pallas._TO_BM] for x in
            jax.jit(ref_bitslice.prg_planes)(jnp.asarray(S[aes_pallas._FROM_BM])))
    cuts = np.cumsum((0,) + widths)
    return {B: (S[:, a:b], L[:, a:b], R[:, a:b]) for B, a, b in zip(widths, cuts, cuts[1:])}


@pytest.mark.parametrize("B", [128, 33])
def test_interleaved_prg_plain_matches_reference_contract(interleaved_reference, B):
    S, L, R = interleaved_reference[B]
    pL, pR = aes_cuda.prg_planes_bm_il_plain(to_carrier(np.ascontiguousarray(S)))
    np.testing.assert_array_equal(from_carrier(pL), L)
    np.testing.assert_array_equal(from_carrier(pR), R)


# The reference's level step, jitted once at one padded shape: a node's
# children depend only on it, its key word's CWs and its t, so zero padding
# on the node and key-word axes leaves the real nodes' children unchanged.
_PAD_W, _PAD_KP = 16, 2


@functools.cache
def _ref_level_step():
    return jax.jit(functools.partial(ref_dpf._level_step, backend="xla"))


def _ref_step(S, T, cw, tl, tr):
    """dpf_tpu's _level_step(..., "xla") on canonical S [128, W, kp]."""
    _, W, kp = S.shape
    Sp = np.zeros((128, _PAD_W, _PAD_KP), np.uint32)
    Tp = np.zeros((_PAD_W, _PAD_KP), np.uint32)
    cwp = np.zeros((128, _PAD_KP), np.uint32)
    tlp, trp = np.zeros(_PAD_KP, np.uint32), np.zeros(_PAD_KP, np.uint32)
    Sp[:, :W, :kp], Tp[:W, :kp], cwp[:, :kp], tlp[:kp], trp[:kp] = S, T, cw, tl, tr
    S2, T2 = _ref_level_step()(*(jnp.asarray(a) for a in (Sp, Tp, cwp, tlp, trp)))
    return np.asarray(S2)[:, : 2 * W, :kp], np.asarray(T2)[: 2 * W, :kp]


@pytest.mark.parametrize("g,W,kp", [(1, 8, 2), (2, 8, 2), (3, 4, 1), (4, 2, 1)])
def test_fused_levels_plain_matches_reference_level_steps(g, W, kp):
    # tests/test_fused_expand.py::_check_fused_kernel's contract on random
    # bit-major state, plane 0 of each sCW zero as Gen makes it.
    rng = np.random.default_rng(20 + g)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    S, T = words(128, W, kp), words(W, kp)
    scw, tl, tr = words(g, 128, kp), words(g, kp), words(g, kp)
    scw[:, 0] = 0
    Sc, Tc = S[aes_pallas._FROM_BM], T
    for i in range(g):
        Sc, Tc = _ref_step(Sc, Tc, scw[i][aes_pallas._FROM_BM], tl[i], tr[i])
    So, To = aes_cuda.fused_levels_planes_plain(
        *(to_carrier(np.ascontiguousarray(a)) for a in
          (S.transpose(0, 2, 1), T.T, scw, tl, tr)))
    np.testing.assert_array_equal(
        from_carrier(So).transpose(0, 2, 1), Sc[aes_pallas._TO_BM])
    np.testing.assert_array_equal(from_carrier(To).T, Tc)


# ---------------------------------------------------------------------------
# The fused schedule, copied from the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("floor", [2, 7])
@pytest.mark.parametrize("g", range(7))
def test_fuse_schedule_matches_reference(g, floor):
    for n_levels in range(21):
        assert md._fuse_schedule(n_levels, g, floor) == ref_dpf._fuse_schedule(
            n_levels, g, floor)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fuse", [None, 0, 1, 2, 3, 4, 6])
def test_fuse_plan_matches_reference(backend, fuse, monkeypatch):
    monkeypatch.delenv("DPF_TPU_FUSE", raising=False)  # the knob's default, off
    for nu in range(21):
        assert md._fuse_plan(nu, backend, fuse) == ref_dpf._fuse_plan(nu, backend, fuse)


def test_fused_kernel_cap_splits_groups():
    # A group above the kernel's cap runs as launches of at most the cap.
    assert aes_cuda.FUSE_MAX_LEVELS == 4
    assert md._fuse_schedule(20, 6) == (7, (6, 6, 1))


# ---------------------------------------------------------------------------
# End to end on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batch15():
    rng = np.random.default_rng(15)
    alphas = rng.integers(0, 1 << 15, size=32, dtype=np.uint64)
    ka, kb = port.gen_batch(alphas, 15, rng, device="cpu")
    return alphas, ka, kb, md.eval_full(ka, device="cpu")


@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_eval_full_options_equal_default_and_spec(batch15, backend, fuse):
    # log_n 15, K 32: nu = 8, the least depth at which floor 7 fuses.
    alphas, ka, kb, base = batch15
    got = port.eval_full_batch(ka, backend=backend, fuse=fuse, device="cpu")
    np.testing.assert_array_equal(got, base)
    for i in (0, ka.k - 1):
        np.testing.assert_array_equal(got[i], _spec_row(ka, i, 15))
    rec = np.unpackbits(got ^ port.eval_full_batch(kb, backend=backend, fuse=fuse,
                                                    device="cpu"),
                        axis=1, bitorder="little")
    assert [list(np.flatnonzero(r)) for r in rec] == [[int(a)] for a in alphas]


@pytest.mark.parametrize("backend", ["pallas", "pallas_bm_il"])
def test_eval_full_options_chunked(batch15, backend):
    _, ka, _, base = batch15
    got = md.eval_full(ka, 1 << 7, backend, 2, device="cpu")  # 2 subtree chunks
    np.testing.assert_array_equal(got, base)


def _floor2(monkeypatch):
    monkeypatch.setattr(md, "_fuse_schedule",
                        functools.partial(md._fuse_schedule, floor=2))


@pytest.mark.parametrize("log_n,fuse", [(10, 1), (11, 2), (12, 3), (13, 4), (15, 6)])
@pytest.mark.parametrize("backend", ["pallas_bm", "pallas_bm_il"])
def test_fused_route_from_level_2(monkeypatch, log_n, fuse, backend):
    # One fused group of 1, 2, 3, 4 or 6 levels from a level-2 entry
    # (nu = log_n - 7).
    rng = np.random.default_rng(log_n + fuse)
    ka, _ = port.gen_batch(rng.integers(0, 1 << log_n, size=40, dtype=np.uint64),
                           log_n, rng, device="cpu")
    base = md.eval_full(ka, device="cpu")
    _floor2(monkeypatch)
    assert md._fuse_plan(ka.nu, backend, fuse)[0] == 2
    got = md.eval_full(ka, backend=backend, fuse=fuse, device="cpu")
    np.testing.assert_array_equal(got, base)
    for i in (0, 39):
        np.testing.assert_array_equal(got[i], _spec_row(ka, i, log_n))


@pytest.fixture(scope="module")
def reference_xla_n12():
    """dpf_tpu's XLA-backend eval_full at n=12, K=32, compiled once."""
    rng = np.random.default_rng(12)
    ka, _ = dpf_tpu.gen_batch(rng.integers(0, 1 << 12, size=32, dtype=np.uint64), 12, rng)
    return KeyBatch.from_bytes(ka.to_bytes(), 12), ref_dpf.eval_full(ka, backend="xla")


@pytest.mark.parametrize("backend,fuse", [("xla", None), ("pallas", None),
                                          ("pallas_bm", 3), ("pallas_bm_il", 2)])
def test_eval_full_options_match_reference(reference_xla_n12, monkeypatch, backend, fuse):
    kb, want = reference_xla_n12
    _floor2(monkeypatch)  # nu = 5: fused groups from level 2
    np.testing.assert_array_equal(md.eval_full(kb, backend=backend, fuse=fuse, device="cpu"),
                                  want)


@pytest.mark.parametrize("call", [
    lambda kb: port.eval_full_batch(kb, backend="triton", device="cpu"),
    lambda kb: md.eval_full_device(md.DeviceKeys(kb, "cpu"), backend="cuda"),
    lambda kb: md.eval_points(kb, np.zeros((kb.k, 1), np.uint64), "gpu", device="cpu"),
])
def test_unknown_backend_raises(batch15, call):
    with pytest.raises(ValueError, match="pallas_bm_il"):
        call(batch15[1])


# ---------------------------------------------------------------------------
# ROADMAP C.4: the model functions take the reference's parameters
# ---------------------------------------------------------------------------

_MODULES = [(md, ref_dpf), (dpf_chacha, ref_dpf_chacha), (dcf, ref_dcf), (fss, ref_fss)]


def _public_functions():
    return [(mod, ref, name) for mod, ref in _MODULES
            for name, fn in sorted(vars(mod).items())
            if not name.startswith("_") and inspect.isfunction(fn)
            and fn.__module__ == mod.__name__]


@pytest.mark.parametrize("mod,ref,name", _public_functions(),
                         ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1])
def test_model_signature_extends_reference(mod, ref, name):
    # The reference's parameters, names, kinds' order and defaults are a
    # prefix of the port's; only device and impl may follow.
    assert hasattr(ref, name), f"{mod.__name__}.{name} has no reference counterpart"
    got = list(inspect.signature(getattr(mod, name)).parameters.values())
    want = list(inspect.signature(getattr(ref, name)).parameters.values())
    assert [(p.name, p.default) for p in got[: len(want)]] == [
        (p.name, p.default) for p in want]
    assert all(p.name in ("device", "impl") for p in got[len(want):])


def test_eval_points_backend_positional_matches_reference():
    # The repro: "xla" in the reference's third position is the backend,
    # not ``packed``.  [[0, 1, 0], [1, 0, 0]] is what
    # dpf_tpu.models.dpf.eval_points(kr, xs, "xla") returns.
    kr, _ = dpf_tpu.gen_batch([3, 5], 8, rng=np.random.default_rng(0))
    ka = KeyBatch.from_bytes(kr.to_bytes(), 8)
    xs = np.array([[3, 4, 5], [5, 6, 7]], dtype=np.uint64)
    got = md.eval_points(ka, xs, "xla", device="cpu")
    assert got.dtype == np.uint8 and got.shape == (2, 3)
    np.testing.assert_array_equal(got, [[0, 1, 0], [1, 0, 0]])


def test_eval_points_level_grouped_backend_positional():
    rng = np.random.default_rng(4)
    G, log_n = 2, 6
    kg, _ = port.gen_batch(rng.integers(0, 1 << log_n, size=log_n * G, dtype=np.uint64),
                           log_n, rng, device="cpu")
    xs = rng.integers(0, 1 << log_n, size=(G, 5), dtype=np.uint64)
    got = md.eval_points_level_grouped(kg, xs, 1, False, "xla", device="cpu")
    np.testing.assert_array_equal(got, md.eval_points_level_grouped(kg, xs, 1,
                                                                    device="cpu"))
    assert got.dtype == np.uint8 and got.shape == (log_n * G, 5)


@pytest.mark.parametrize("backend", [None, "xla", "pallas"])
def test_fast_eval_full_takes_reference_arguments(backend):
    rng = np.random.default_rng(7)
    kb, _ = fast.gen_batch(rng.integers(0, 1 << 12, size=3, dtype=np.uint64), 12, rng, device="cpu")
    words = dpf_chacha.eval_full_device(kb, dpf_chacha.MAX_LEAF_NODES, backend, 2,
                                        device="cpu")
    assert words.shape == (3, 1 << kb.nu, 16)
    got = fast.eval_full_batch(kb, backend=backend, fuse=2, device="cpu")
    np.testing.assert_array_equal(from_carrier(words).view("<u1").reshape(3, -1), got)
    for i, key in enumerate(kb.to_bytes()):
        assert got[i].tobytes() == chacha_np.eval_full(key, 12)
    with pytest.raises(ValueError, match="unknown backend"):
        dpf_chacha.eval_full(kb, backend="pallas_bm", device="cpu")


# ---------------------------------------------------------------------------
# The new wrappers: the kernel or nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrapper", ["prg_planes_canon", "convert_leaves_canon",
                                     "prg_planes_bm_il", "fused_levels_planes"])
def test_new_wrappers_take_only_cpu_or_cuda_tensors(wrapper):
    # A tensor on another device raises; a CPU tensor runs the plain
    # version and launches nothing.
    fn = getattr(aes_cuda, wrapper)
    before = fn.launches

    def operands(device):
        z = functools.partial(torch.zeros, dtype=torch.int32, device=device)
        if wrapper == "fused_levels_planes":
            return z((128, 2, 4)), z((2, 4)), z((2, 128, 2)), z((2, 2)), z((2, 2))
        if wrapper == "convert_leaves_canon":
            return z((128, 4, 2)), z((4, 2)), z((128, 1, 2))
        return (z((128, 32)),)

    with pytest.raises(ValueError):
        fn(*operands("meta"))
    fn(*operands("cpu"))
    assert fn.launches == before


def test_fused_source_is_built():
    from dpf_tpu_torch.ops import build

    assert build.LIBRARIES["aes_fused"][0].name == "aes_fused.cu"
    assert "dpf_fused_bm" in build._SIGNATURES["aes_fused"]
