"""The CUDA kernels' arithmetic, compiled as host C++.

``dpf_tpu_torch/ops/csrc/aes_mmo.cu`` keeps its per-column functions
(S-box wiring, ShiftRows/MixColumns, round-key masks, MMO feed-forward,
canonical output order) compilable as plain C++: a shim defines ``__host__``,
``__device__`` and ``__constant__`` as empty, and the ``__global__`` kernels
sit under ``__CUDACC__``.  This test builds those functions with g++ and holds
them, bit for bit, against the plain PyTorch versions on random
int32[128, 64] planes.  ``csrc/chacha_expand.cu`` is built the same way: its
per-thread work (ChaCha12 core, level step, depth-first subtree walk, leaf
convert, ascending store) runs for every thread index of a launch and is held
against the plain versions of ``ops/chacha_cuda.py``.  It runs without a GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu_torch.ops import aes_cuda, build, chacha_cuda  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import from_carrier, to_carrier  # noqa: E402

SHIM = """\
#define __host__
#define __device__
#define __constant__
#define __forceinline__ inline
"""

HOST_ENTRY = """\
#include "aes_mmo.cu"

extern "C" void host_prg(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  for (long long j = 0; j < B; ++j) {
    mmo_column<false>(S, L, B, j, 0);
    mmo_column<false>(S, R, B, j, 1);
  }
}

extern "C" void host_mmo_canon(const uint32_t* S, uint32_t* O, long long B) {
  for (long long j = 0; j < B; ++j) mmo_column<true>(S, O, B, j, 0);
}
"""


CHACHA_HOST_ENTRY = """\
#include "chacha_expand.cu"

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


@pytest.fixture(scope="module")
def chacha_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "chacha_host", CHACHA_HOST_ENTRY)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_expand.argtypes = [ctypes.c_int, vp, ll, ll, ll, ll, ctypes.c_int,
                                vp, ll, vp, ll, vp, ll, vp, ll, ll]
    lib.host_expand.restype = None
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
