"""The CUDA kernels' arithmetic, compiled as host C++.

``dpf_tpu_torch/ops/csrc/aes_mmo.cu`` keeps its per-column functions
(S-box wiring, ShiftRows/MixColumns, round-key masks, MMO feed-forward,
canonical output order) compilable as plain C++: a shim defines ``__host__``,
``__device__`` and ``__constant__`` as empty, and the ``__global__`` kernels
sit under ``__CUDACC__``.  This test builds those functions with g++ and holds
them, bit for bit, against the plain PyTorch versions on random
int32[128, 64] planes.  It runs without a GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu_torch.ops import aes_cuda, build  # noqa: E402
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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("aes_mmo_host")
    (d / "shim.h").write_text(SHIM)
    (d / "host_entry.cpp").write_text(HOST_ENTRY)
    so = d / "libaes_mmo_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-include", str(d / "shim.h"),
         "-I", str(build.CSRC), "-o", str(so), str(d / "host_entry.cpp")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    lib = ctypes.CDLL(str(so))
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
