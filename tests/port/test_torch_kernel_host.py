"""The CUDA kernels' arithmetic, compiled as host C++.

``dpf_tpu_torch/ops/csrc/aes_mmo.cu`` keeps its per-column functions
(S-box wiring, ShiftRows/MixColumns, round-key masks, MMO feed-forward,
canonical input and output orders, the interleaved PRG's warp pairs)
compilable as plain C++: a shim defines ``__host__``, ``__device__`` and
``__constant__`` as empty, and the ``__global__`` kernels sit under
``__CUDACC__``.  This test builds those functions with g++ and holds them,
bit for bit, against the plain PyTorch versions on random int32[128, B]
planes.  ``csrc/aes_fused.cu`` builds into the same library: every (entry
column, path prefix) thread of a fused launch runs in turn and is held
against ``fused_levels_planes_plain`` for g = 1 to 4.  ``csrc/chacha_expand.cu`` is built the same way: its
per-thread work (ChaCha12 core, level step, depth-first subtree walk, leaf
convert, ascending store) runs for every thread index of a launch and is held
against the plain versions of ``ops/chacha_cuda.py``.  The pointwise walks
(``csrc/aes_walk.cu``, ``csrc/chacha_walk.cu``) build into the same two
libraries: every column or lane of a launch runs in turn and is held against
``eval_points_walk_planes_plain`` and ``walk_plain`` (walk order, plane
orders, the 64-bit index split, the level-grouping masks); the DCF lane of
``csrc/chacha_walk.cu`` against ``walk_dcf_plain`` on random words and against
the numpy oracle ``models.dcf.eval_points_np`` on real keys (the value word's
index, the parent's t).  It runs without a GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu_torch.models import dcf  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda, build, chacha_cuda  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402

SHIM = """\
#define __host__
#define __device__
#define __constant__
#define __forceinline__ inline
"""

HOST_ENTRY = """\
#include "aes_fused.cu"
#include "aes_mmo.cu"
#include "aes_walk.cu"

// Every column (key k, query word j) of one walk launch, in turn.
extern "C" void host_walk_bm(const uint32_t* seeds, const uint32_t* t,
                             const uint32_t* scw, const uint32_t* tl,
                             const uint32_t* tr, const uint32_t* fcw,
                             const uint32_t* pw, const uint32_t* sel, uint32_t* out,
                             long long K, long long qp, int nu) {
  const WalkArgs a{seeds, t, scw, tl, tr, fcw, pw, sel, out, K, qp, nu};
  uint32_t st[128], nx[128];
  for (long long k = 0; k < K; ++k)
    for (long long j = 0; j < qp; ++j) walk_column<1>(a, k, j, st, nx);
}

extern "C" void host_prg(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  for (long long j = 0; j < B; ++j) {
    mmo_column<false>(S, L, B, j, 0);
    mmo_column<false>(S, R, B, j, 1);
  }
}

extern "C" void host_mmo_canon(const uint32_t* S, uint32_t* O, long long B) {
  for (long long j = 0; j < B; ++j) mmo_column<true>(S, O, B, j, 0);
}

// The canonical-order PRG and leaf MMO (prg_canon_kernel, mmo_canon_kernel).
extern "C" void host_prg_canon(const uint32_t* S, uint32_t* L, uint32_t* R,
                               long long B) {
  for (long long j = 0; j < B; ++j) {
    mmo_column<true, true>(S, L, B, j, 0);
    mmo_column<true, true>(S, R, B, j, 1);
  }
}

extern "C" void host_mmo_canon_canon(const uint32_t* S, uint32_t* O, long long B) {
  for (long long j = 0; j < B; ++j) mmo_column<true, true>(S, O, B, j, 0);
}

// Every thread of every block of one prg_bm_il_kernel launch, in turn.
extern "C" void host_prg_il(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  const long long blocks = (B + kThreads / 2 - 1) / (kThreads / 2);
  for (long long b = 0; b < blocks; ++b)
    for (int t = 0; t < kThreads; ++t) prg_il_thread(S, L, R, B, b, t);
}

// Every (entry column, path prefix) thread of one fused launch, in turn.
extern "C" void host_fused(const uint32_t* S, const uint32_t* T, const uint32_t* scw,
                           const uint32_t* tl, const uint32_t* tr, uint32_t* So,
                           uint32_t* To, long long Kp, long long W, int g) {
  const FusedArgs a{S, T, scw, tl, tr, So, To, Kp * W, W, Kp, g};
  uint32_t st[128];
  for (long long j = 0; j < Kp * W; ++j)
    for (unsigned q = 0; q < (1u << (g - 1)); ++q) fused_column<1>(a, j, q, st);
}
"""


CHACHA_HOST_ENTRY = """\
#include "chacha_expand.cu"
#include "chacha_walk.cu"

// Every lane (query i / K, key i % K) of one walk launch, in turn.
extern "C" void host_chacha_walk(const uint32_t* meta, const uint32_t* seeds,
                                 const uint32_t* scw, const uint32_t* tcw,
                                 const uint32_t* fcw, const uint32_t* xs_lo,
                                 const uint32_t* xs_hi, uint32_t* out, long long Q,
                                 long long K, int log_n, int nu) {
  const ChachaWalkArgs a{meta, seeds, scw, tcw, fcw, xs_lo, xs_hi, out, Q, K, log_n, nu};
  for (long long i = 0; i < Q * K; ++i) walk_lane<false>(a, i);
}

// Every lane of one DCF walk launch, in turn.
extern "C" void host_chacha_walk_dcf(const uint32_t* meta, const uint32_t* seeds,
                                     const uint32_t* scw, const uint32_t* tcw,
                                     const uint32_t* vcw, const uint32_t* fcw,
                                     const uint32_t* xs_lo, const uint32_t* xs_hi,
                                     uint32_t* out, long long Q, long long K, int log_n,
                                     int nu) {
  const ChachaWalkArgs a{meta, seeds, scw, tcw, fcw, xs_lo, xs_hi, out, Q, K, log_n, nu,
                         vcw};
  for (long long i = 0; i < Q * K; ++i) walk_lane<true>(a, i);
}

// Every thread index of one launch, in turn, as the kernels run them.
extern "C" void host_expand(int leaf, const uint32_t* st, long long st_row,
                            long long st_key, long long K, long long W, int levels,
                            const uint32_t* scw, long long scw_key,
                            const uint32_t* tcw, long long tcw_key,
                            const uint32_t* fcw, long long fcw_key, uint32_t* out,
                            long long out_row, long long out_key) {
  const ExpandArgs a{st, st_row, st_key, K, W, levels, scw, scw_key, tcw,
                     tcw_key, fcw, fcw_key, out, out_row, out_key};
  for (long long i = 0; i < K * W; ++i) {
    if (leaf) expand_node<true>(a, i); else expand_node<false>(a, i);
  }
}
"""


def _host_build(tmp_path_factory, name, entry):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.h").write_text(SHIM)
    (d / "host_entry.cpp").write_text(entry)
    so = d / f"lib{name}.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-include", str(d / "shim.h"),
         "-I", str(build.CSRC), "-o", str(so), str(d / "host_entry.cpp")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "aes_mmo_host", HOST_ENTRY)
    vp = ctypes.c_void_p
    lib.host_prg.argtypes = [vp, vp, vp, ctypes.c_longlong]
    lib.host_prg.restype = None
    lib.host_mmo_canon.argtypes = [vp, vp, ctypes.c_longlong]
    lib.host_mmo_canon.restype = None
    lib.host_walk_bm.argtypes = [vp] * 9 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.host_walk_bm.restype = None
    for fn in (lib.host_prg_canon, lib.host_prg_il):
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong]
        fn.restype = None
    lib.host_mmo_canon_canon.argtypes = [vp, vp, ctypes.c_longlong]
    lib.host_mmo_canon_canon.restype = None
    lib.host_fused.argtypes = [vp] * 7 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.host_fused.restype = None
    return lib


def _planes(seed, B=64):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=(128, B), dtype=np.uint32)


@pytest.mark.parametrize("half", ["L", "R"])
def test_prg_column_matches_plain(host_lib, half):
    S = _planes(seed=1)
    L, R = np.empty_like(S), np.empty_like(S)
    host_lib.host_prg(S.ctypes.data, L.ctypes.data, R.ctypes.data, S.shape[1])
    pL, pR = aes_cuda.prg_planes_bm_plain(to_carrier(S))
    got, want = (L, pL) if half == "L" else (R, pR)
    np.testing.assert_array_equal(got, from_carrier(want))


def test_mmo_canon_column_matches_plain(host_lib):
    S = _planes(seed=2)
    O = np.empty_like(S)
    host_lib.host_mmo_canon(S.ctypes.data, O.ctypes.data, S.shape[1])
    np.testing.assert_array_equal(
        O, from_carrier(aes_cuda.mmo_planes_bm_canon_plain(to_carrier(S)))
    )


@pytest.mark.parametrize("kind,B", [("canon", 64), ("il", 64), ("il", 33), ("il", 97)])
def test_prg_canon_and_il_columns_match_plain(host_lib, kind, B):
    # The interleaved kernel at widths that leave a warp pair half empty and
    # a block's second pair empty.
    S = _planes(seed=3 + B, B=B)
    L, R = np.zeros_like(S), np.zeros_like(S)
    fn, plain = ((host_lib.host_prg_canon, aes_cuda.prg_planes_canon_plain)
                 if kind == "canon" else (host_lib.host_prg_il, aes_cuda.prg_planes_bm_il_plain))
    fn(S.ctypes.data, L.ctypes.data, R.ctypes.data, B)
    pL, pR = plain(to_carrier(S))
    np.testing.assert_array_equal(L, from_carrier(pL))
    np.testing.assert_array_equal(R, from_carrier(pR))


def test_mmo_canon_canon_column_matches_plain(host_lib):
    S = _planes(seed=4)
    O = np.empty_like(S)
    host_lib.host_mmo_canon_canon(S.ctypes.data, O.ctypes.data, S.shape[1])
    np.testing.assert_array_equal(
        O, from_carrier(aes_cuda.mmo_planes_canon_plain(to_carrier(S)))
    )


@pytest.mark.parametrize("g,Kp,W", [(1, 2, 3), (2, 1, 4), (3, 2, 1), (4, 1, 2)])
def test_fused_column_matches_plain(host_lib, g, Kp, W):
    # Random words everywhere, plane 0 of the CWs included: the kernel and
    # the plain version compute the same function of any words.
    rng = np.random.default_rng(400 + 10 * g + W)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    ops = [words(128, Kp, W), words(Kp, W), words(g, 128, Kp), words(g, Kp), words(g, Kp)]
    So = np.zeros((128, Kp, W << g), np.uint32)
    To = np.zeros((Kp, W << g), np.uint32)
    host_lib.host_fused(*(_p(a) for a in ops), _p(So), _p(To), Kp, W, g)
    pS, pT = aes_cuda.fused_levels_planes_plain(*(to_carrier(a) for a in ops))
    np.testing.assert_array_equal(So, from_carrier(pS))
    np.testing.assert_array_equal(To, from_carrier(pT))


@pytest.fixture(scope="module")
def chacha_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "chacha_host", CHACHA_HOST_ENTRY)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_expand.argtypes = [ctypes.c_int, vp, ll, ll, ll, ll, ctypes.c_int,
                                vp, ll, vp, ll, vp, ll, vp, ll, ll]
    lib.host_expand.restype = None
    lib.host_chacha_walk.argtypes = [vp] * 8 + [ll, ll, ctypes.c_int, ctypes.c_int]
    lib.host_chacha_walk.restype = None
    lib.host_chacha_walk_dcf.argtypes = [vp] * 9 + [ll, ll, ctypes.c_int, ctypes.c_int]
    lib.host_chacha_walk_dcf.restype = None
    return lib


def _state_and_cws(K, W, levels, seed):
    rng = np.random.default_rng(seed)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    st = words(5, K, W)
    st[0] &= ~np.uint32(1)
    st[4] = rng.integers(0, 2, size=(K, W), dtype=np.uint32)
    scw = words(K, levels, 4)
    scw[:, :, 0] &= ~np.uint32(1)
    tcw = rng.integers(0, 2, size=(K, levels, 2), dtype=np.uint32)
    return st, scw, tcw, words(K, 16)


def _p(a):
    return a.ctypes.data


@pytest.mark.parametrize("K,W,levels", [(1, 1, 0), (1, 1, 6), (3, 5, 2), (9, 16, 4), (2, 3, 5)])
def test_chacha_tail_matches_plain(chacha_lib, K, W, levels):
    st, scw, tcw, fcw = _state_and_cws(K, W, levels, seed=K + W + levels)
    out = np.zeros((K, W << levels, 16), np.uint32)
    chacha_lib.host_expand(1, _p(st), K * W, W, K, W, levels, _p(scw), 4 * levels,
                           _p(tcw), 2 * levels, _p(fcw), 16, _p(out), 0, (W << levels) * 16)
    want = chacha_cuda.expand_tail_plain(to_carrier(st), to_carrier(scw),
                                         to_carrier(tcw), to_carrier(fcw))
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("K,W,levels", [(1, 1, 5), (4, 3, 2), (2, 8, 0)])
def test_chacha_fused_matches_plain(chacha_lib, K, W, levels):
    st, scw, tcw, _ = _state_and_cws(K, W, levels, seed=10 * K + W + levels)
    out = np.zeros((5, K, W << levels), np.uint32)
    chacha_lib.host_expand(0, _p(st), K * W, W, K, W, levels, _p(scw), 4 * levels,
                           _p(tcw), 2 * levels, None, 0, _p(out), K * (W << levels),
                           W << levels)
    want = chacha_cuda.fused_levels_plain(to_carrier(st), to_carrier(scw), to_carrier(tcw))
    np.testing.assert_array_equal(out, from_carrier(want))


def test_chacha_tail_strided_views_match_plain(chacha_lib):
    # The chunked route's operands: a node range of a wider state, the CWs of
    # the last levels of a deeper key, and a node range of a wider output.
    K, W, nu, first = 3, 8, 6, 4
    st, scw, tcw, fcw = _state_and_cws(K, W, nu, seed=7)
    levels = nu - first
    out = np.zeros((K, W << levels, 16), np.uint32)
    a, b = 2, 6
    sub = st[:, :, a:]
    chacha_lib.host_expand(1, _p(st) + 4 * a, K * W, W, K, b - a, levels,
                           _p(scw) + 16 * first, 4 * nu, _p(tcw) + 8 * first, 2 * nu,
                           _p(fcw), 16, _p(out) + 64 * (a << levels), 0,
                           (W << levels) * 16)
    want = chacha_cuda.expand_tail_plain(
        to_carrier(np.ascontiguousarray(sub[:, :, : b - a])),
        to_carrier(np.ascontiguousarray(scw[:, first:])),
        to_carrier(np.ascontiguousarray(tcw[:, first:])), to_carrier(fcw),
    )
    np.testing.assert_array_equal(out[:, a << levels : b << levels], from_carrier(want))
    assert not out[:, : a << levels].any() and not out[:, b << levels :].any()


@pytest.mark.parametrize("K,qp,nu", [(1, 1, 0), (3, 2, 1), (2, 3, 3)])
def test_compat_walk_column_matches_plain(host_lib, K, qp, nu):
    # Random words everywhere (not only lane masks and one-hot selects): the
    # kernel and the plain version compute the same function of any words.
    rng = np.random.default_rng(100 + 10 * K + nu)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    ops = [words(128, K), words(K), words(nu, 128, K), words(nu, K), words(nu, K),
           words(128, K), words(nu, K, qp), words(128, K, qp)]
    out = np.zeros((K, qp), np.uint32)
    host_lib.host_walk_bm(*(_p(a) for a in ops), _p(out), K, qp, nu)
    want = aes_cuda.eval_points_walk_planes_plain(*(to_carrier(a) for a in ops), nu)
    np.testing.assert_array_equal(out, from_carrier(want))


def _walk_operands(rng, Q, K, log_n, grouped):
    """Random walk operands: meta (t 0/1, key_level, lowmask), seeds, CWs
    and 64-bit query halves."""
    nu = max(log_n - 9, 0)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    if grouped:
        key_level = rng.integers(0, log_n, size=K, dtype=np.uint32)
        lowmask = words(K) & np.uint32(511)
    else:
        key_level = np.full(K, log_n, np.uint32)
        lowmask = np.full(K, 511, np.uint32)
    meta = np.stack([rng.integers(0, 2, size=K, dtype=np.uint32), key_level, lowmask])
    seeds, scw, fcw = words(4, K), words(4 * nu, K), words(16, K)
    seeds[0] &= ~np.uint32(1)
    scw[0::4] &= ~np.uint32(1)
    tcw = rng.integers(0, 2, size=(2 * nu, K), dtype=np.uint32)
    xs = rng.integers(0, 1 << log_n, size=(Q, K), dtype=np.uint64)
    lo = (xs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (xs >> np.uint64(32)).astype(np.uint32)
    return [meta, seeds, scw, tcw, fcw, lo, hi], nu


@pytest.mark.parametrize("log_n,Q,K,grouped", [(9, 3, 2, False), (14, 5, 3, False),
                                               (34, 4, 3, False), (16, 3, 5, True)])
def test_chacha_walk_lane_matches_plain(chacha_lib, log_n, Q, K, grouped):
    ops, nu = _walk_operands(np.random.default_rng(log_n + Q), Q, K, log_n, grouped)
    out = np.zeros((Q, K), np.uint32)
    chacha_lib.host_chacha_walk(*(_p(a) for a in ops), _p(out), Q, K, log_n, nu)
    want = chacha_cuda.walk_plain(*(to_carrier(a) for a in ops), log_n, nu)
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("log_n,Q,K", [(5, 3, 2), (13, 5, 3), (34, 4, 3)])
def test_chacha_walk_dcf_lane_matches_plain(chacha_lib, log_n, Q, K):
    rng = np.random.default_rng(200 + log_n)
    ops, nu = _walk_operands(rng, Q, K, log_n, grouped=False)
    vcw = rng.integers(0, 2, size=(max(nu, 1), K), dtype=np.uint32)
    ops = ops[:4] + [vcw] + ops[4:]
    out = np.zeros((Q, K), np.uint32)
    chacha_lib.host_chacha_walk_dcf(*(_p(a) for a in ops), _p(out), Q, K, log_n, nu)
    want = chacha_cuda.walk_dcf_plain(*(to_carrier(a) for a in ops), log_n, nu)
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("log_n", [5, 13, 34])
def test_chacha_walk_dcf_lane_matches_dcf_oracle(chacha_lib, log_n):
    # Real DCF keys: the kernel's lanes equal eval_points_np, and both
    # parties' lanes reconstruct xs < alpha.
    rng = np.random.default_rng(300 + log_n)
    K, Q = 3, 7
    alphas = rng.integers(0, 1 << log_n, size=K, dtype=np.uint64)
    xs = rng.integers(0, 1 << log_n, size=(K, Q), dtype=np.uint64)
    xs[:, 0] = alphas
    xs[:, 1] = np.maximum(alphas, np.uint64(1)) - np.uint64(1)
    shares = []
    for kb in dcf.gen_lt_batch(alphas, log_n, rng):
        *ops, xs_hi, log_n_, nu = chacha_cuda.dcf_walk_args(kb, xs)
        ops = [from_carrier(a) for a in ops + [ops[-1] if xs_hi is None else xs_hi]]
        out = np.zeros((Q, K), np.uint32)
        chacha_lib.host_chacha_walk_dcf(*(_p(a) for a in ops), _p(out), Q, K, log_n_, nu)
        np.testing.assert_array_equal(out.T, dcf.eval_points_np(kb, xs))
        shares.append(out.T)
    np.testing.assert_array_equal(shares[0] ^ shares[1], xs < alphas[:, None])
