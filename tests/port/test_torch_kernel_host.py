"""The CUDA kernels' arithmetic, compiled as host C++.

``dpf_tpu_torch/ops/csrc/aes_mmo.cu`` keeps its per-column functions
(the folded cipher of ``aes_bm.cuh``: S-box and MixColumns as generated
LOP3 lists, round keys moved to the S-box outputs, the MMO feed-forward,
canonical input order; the leaf kernels' epilogue: the final CW, the 32x32
bit transposes, the per-key word stores at a leaf offset) compilable as
plain C++: a shim defines ``__host__``, ``__device__`` and ``__constant__``
as empty, and the ``__global__`` kernels sit under ``__CUDACC__``.  This
test builds those functions with g++ and holds them, bit for bit, against
the plain PyTorch versions on random words: the PRG's cipher per column and
every (block, thread) of one launch of ``prg_bm_kernel``,
``prg_canon_kernel`` and ``prg_bm_il_kernel`` at widths that leave warps
and blocks part empty; the leaf convert per column and every (block,
thread) of one launch of ``leaf_words_bm_kernel`` and
``leaf_words_canon_kernel`` in both input layouts and at a leaf offset
(against ``convert_leaves_bm_plain`` / ``convert_leaves_canon_plain``); the
cipher against ``op_count``'s traced circuit for both keys; the generated
LOP3 instructions against the cover ``op_count`` counts.
``csrc/aes_fused.cu`` builds into the same library: every (entry column,
path prefix) thread of a fused launch runs in turn and is held against
``fused_levels_planes_plain`` for g = 1 to 4.  ``csrc/chacha_expand.cu`` is built the same way: its
per-thread work (ChaCha12 core, level step, depth-first subtree walk, leaf
convert, ascending store) runs for every thread index of a launch and is held
against the plain versions of ``ops/chacha_cuda.py``.  The pointwise walks
(``csrc/aes_walk.cu``, ``csrc/chacha_walk.cu``) build into the same two
libraries: every block of a compat walk launch runs its phases in the
kernel's barrier order, every lane of a ChaCha walk in turn, held against
``eval_points_walk_planes_plain`` and ``walk_plain`` (walk order, plane
orders, the 64-bit index split, the level-grouping masks); the DCF lane of
``csrc/chacha_walk.cu`` against ``walk_dcf_plain`` on random words and against
the numpy oracle ``models.dcf.eval_points_np`` on real keys (the value word's
index, the parent's t).  The dealer's tower (``csrc/chacha_gen.cu``) builds
into the ChaCha library too: every key of a launch in turn, held against
``gen_tower_plain`` for the fast and the DCF tower at nu 0, 1 and 23.  It
runs without a GPU.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from dpf_tpu_torch.models import dcf  # noqa: E402
from dpf_tpu_torch.ops import aes_cuda, build, chacha_cuda, op_count  # noqa: E402
from dpf_tpu_torch.ops.aes_bitslice import (  # noqa: E402
    RK_MASKS_L,
    RK_MASKS_R,
    from_carrier,
    to_carrier,
)

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

// Every block (key k, tile of 32 query words) of one walk launch, in turn,
// each in the kernel's barrier order: the set-up (left warp); per level,
// phase 1 of both warps, then phase 2 (the right warp's combine, the left
// warp's staging of the next CWs); then the leaf (left warp).  s holds each thread's registers across the barriers.
extern "C" void host_walk_bm(const uint32_t* seeds, const uint32_t* t,
                             const uint32_t* scw, const uint32_t* tl,
                             const uint32_t* tr, const uint32_t* fcw,
                             const uint32_t* pw, const uint32_t* sel, uint32_t* out,
                             long long K, long long qp, int nu) {
  const WalkArgs a{seeds, t, scw, tl, tr, fcw, pw, sel, out, K, qp, nu};
  WalkShared sh;
  static uint32_t s[2][32][128];
  uint32_t go[2][32], tc[2][32];
  WalkThread x[2][32];
  copy_rk_sbox(sh.rk, 0, 1);
  for (long long k = 0; k < K; ++k)
    for (long long tile = 0; tile < (qp + 31) / 32; ++tile) {
      for (int key = 0; key < 2; ++key)
        for (int lane = 0; lane < 32; ++lane) {
          const size_t j = tile * 32 + lane;
          x[key][lane] = {key, lane, static_cast<size_t>(k), j,
                          j < static_cast<size_t>(qp) ? j : qp - 1};
        }
      for (int lane = 0; lane < 32; ++lane) walk_init(a, x[0][lane], sh);
      for (int i = 0; i < nu; ++i) {
        for (int key = 0; key < 2; ++key)
          for (int lane = 0; lane < 32; ++lane) {
            folded_rounds(s[key][lane], walk_load(s[key][lane], sh, x[key][lane]));
            tc[key][lane] = walk_child(a, i, x[key][lane], s[key][lane], sh, go[key][lane]);
          }
        for (int lane = 0; lane < 32; ++lane) {
          walk_combine(x[1][lane], s[1][lane], go[1][lane], tc[1][lane], sh);
          walk_stage(a, i + 1, x[0][lane], sh);
        }
      }
      for (int lane = 0; lane < 32; ++lane) {
        walk_stage_select(a, x[0][lane], sh);
        folded_rounds(s[0][lane], walk_load(s[0][lane], sh, x[0][lane]));
        walk_leaf(a, x[0][lane], s[0][lane], sh);
      }
    }
}

// The PRG kernels' per-column cipher (aes_bm.cuh's mmo_column_folded) for
// keys L and R on every column, bit-major in and out.
extern "C" void host_prg(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  for (long long j = 0; j < B; ++j) {
    mmo_column_folded<false>(S, L, B, j, &RK_SBOX[0][0][0]);
    mmo_column_folded<false>(S, R, B, j, &RK_SBOX[1][0][0]);
  }
}

// Every thread of every block of one leaf_words_bm_kernel launch
// (leaf_words_canon_kernel's with kCanon), in turn, as the kernel runs it:
// the block's shared copy of key L's RK_SBOX and of its tile's final CW
// planes, then one column a thread (leaf_column, leaf_load, folded_rounds,
// leaf_store), its input rows in its column of the block's shared copy.
template <bool kCanon>
static void leaf_launch_columns(const LeafArgs& a) {
  static LeafShared sh;
  copy_rk_sbox(sh.rk, 0, 1, kRkWords / 2);
  for (long long b = 0; b < leaf_blocks(a); ++b) {
    const LeafTile tile = leaf_tile(a, b);
    stage_fcw(a, tile, sh.fcw, 0, 1);
    for (int t = 0; t < kLeafThreads; ++t) {
      if (!leaf_column(a, tile, t, sh.slot[t])) continue;
      uint32_t s[128];
      leaf_load<kCanon>(a, sh.slot[t].c, sh.rk, sh.S + t, s);
      folded_rounds(s, sh.rk);
      leaf_store<kCanon>(a, sh.slot[t], sh.fcw, sh.S + t, s);
    }
  }
}

// The canonical-order PRG (prg_canon_kernel's per-column cipher).
extern "C" void host_prg_canon(const uint32_t* S, uint32_t* L, uint32_t* R,
                               long long B) {
  for (long long j = 0; j < B; ++j) {
    mmo_column_folded<true>(S, L, B, j, &RK_SBOX[0][0][0]);
    mmo_column_folded<true>(S, R, B, j, &RK_SBOX[1][0][0]);
  }
}

// One leaf launch (leaf_words_canon_kernel's with canon) in either layout,
// words into leaves leaf_off .. of out's rows of `leaves`.
extern "C" void host_leaf_launch(int canon, const uint32_t* S, const uint32_t* T,
                                 const uint32_t* fcw, uint32_t* out, long long W,
                                 long long Kp, int node_minor, long long leaves,
                                 long long leaf_off) {
  const LeafArgs a{S, T, fcw, out, W, Kp, leaves, leaf_off, node_minor};
  if (canon)
    leaf_launch_columns<true>(a);
  else
    leaf_launch_columns<false>(a);
}

// Every thread of every block of one prg_bm_kernel launch (prg_canon_kernel
// with canon), in turn, the block's shared copy of the masks being RK_SBOX.
extern "C" void host_prg_launch(int canon, const uint32_t* S, uint32_t* L, uint32_t* R,
                                long long B) {
  const long long blocks = (B + kThreads / 2 - 1) / (kThreads / 2);
  for (long long b = 0; b < blocks; ++b)
    for (int t = 0; t < kThreads; ++t) {
      if (canon)
        prg_thread<true>(S, L, R, B, b, t, &RK_SBOX[0][0][0]);
      else
        prg_thread<false>(S, L, R, B, b, t, &RK_SBOX[0][0][0]);
    }
}

// The PRG kernels' cipher with key `key` on canonical planes, every column.
extern "C" void host_mmo_folded(int key, const uint32_t* S, uint32_t* O, long long B) {
  for (long long j = 0; j < B; ++j) mmo_column_folded<true>(S, O, B, j, &RK_SBOX[key][0][0]);
}

// Every thread of every block of one prg_bm_il_kernel launch (prg_block<false>,
// as prg_bm_kernel), in turn, with the block's shared copy of RK_SBOX.
extern "C" void host_prg_il(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  static uint32_t rk[kRkWords];
  copy_rk_sbox(rk, 0, 1);
  const long long blocks = (B + kThreads / 2 - 1) / (kThreads / 2);
  for (long long b = 0; b < blocks; ++b)
    for (int t = 0; t < kThreads; ++t) prg_thread<false>(S, L, R, B, b, t, rk);
}

// Every thread of every block (kFusedThreads entry columns, path prefix q)
// of one fused launch, in turn, as the kernel runs it: the block's shared
// copy of RK_SBOX, each thread's walked node at its slot of the block's st.
extern "C" void host_fused(const uint32_t* S, const uint32_t* T, const uint32_t* scw,
                           const uint32_t* tl, const uint32_t* tr, uint32_t* So,
                           uint32_t* To, long long Kp, long long W, int g) {
  const FusedArgs a{S, T, scw, tl, tr, So, To, Kp * W, W, Kp, g};
  static FusedShared sh;
  copy_rk_sbox(sh.rk, 0, 1);
  const size_t N = Kp * W, blocks = (N + kFusedThreads - 1) / kFusedThreads;
  for (size_t b = 0; b < blocks; ++b)
    for (unsigned q = 0; q < (1u << (g - 1)); ++q)
      for (int t = 0; t < kFusedThreads; ++t) {
        const size_t j = b * kFusedThreads + t;
        if (j >= N) continue;
        uint32_t tj = T[j];
        for (int step = 0; step <= g; ++step) {
          uint32_t s[128];
          folded_rounds(s, fused_load<kFusedThreads>(a, j, q, step, sh.st + t, sh.rk, s));
          fused_store<kFusedThreads>(a, j, q, step, sh.st + t, &tj, s);
        }
      }
}
"""


CHACHA_HOST_ENTRY = """\
#include "chacha_expand.cu"
#include "chacha_walk.cu"
#include "chacha_gen.cu"

// Every key of one dealer launch, in turn.
extern "C" void host_chacha_gen(const uint32_t* s0, const uint32_t* s1,
                                const uint32_t* t0, const uint32_t* t1,
                                const uint32_t* bits, uint32_t* scw, uint32_t* tl,
                                uint32_t* tr, uint32_t* fcw, uint32_t* vcw, long long K,
                                int nu, int dcf) {
  const ChachaGenArgs a{s0, s1, t0, t1, bits, scw, tl, tr, fcw, vcw, K, nu};
  for (long long k = 0; k < K; ++k) {
    if (dcf) gen_lane<true>(a, k); else gen_lane<false>(a, k);
  }
}

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

// Every thread index of one launch, in turn, as the kernels run them: the
// launch's split d from the kernels' rule (split < 0) or as given.
extern "C" void host_expand(int leaf, const uint32_t* st, long long st_row,
                            long long st_key, long long K, long long W, int levels,
                            const uint32_t* scw, long long scw_key,
                            const uint32_t* tcw, long long tcw_key,
                            const uint32_t* fcw, long long fcw_key, uint32_t* out,
                            long long out_row, long long out_key, int split) {
  ExpandArgs a = with_split(ExpandArgs{st, st_row, st_key, K, W, levels, scw, scw_key,
                                       tcw, tcw_key, fcw, fcw_key, out, out_row,
                                       out_key, 0}, leaf != 0);
  if (split >= 0) a.split = split;
  for (long long i = 0; i < (K * W) << a.split; ++i) {
    if (leaf) expand_split<true>(a, i); else expand_split<false>(a, i);
  }
}

// The kernels' rule for d.
extern "C" int host_split_levels(long long nodes, int levels, int leaf) {
  return split_levels(nodes, levels, leaf != 0);
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
    ll = ctypes.c_longlong
    lib.host_prg.argtypes = [vp, vp, vp, ll]
    lib.host_prg.restype = None
    lib.host_leaf_launch.argtypes = [ctypes.c_int] + [vp] * 4 + [ll, ll, ctypes.c_int, ll, ll]
    lib.host_leaf_launch.restype = None
    lib.host_walk_bm.argtypes = [vp] * 9 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.host_walk_bm.restype = None
    for fn in (lib.host_prg_canon, lib.host_prg_il):
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong]
        fn.restype = None
    lib.host_fused.argtypes = [vp] * 7 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.host_fused.restype = None
    lib.host_prg_launch.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_longlong]
    lib.host_prg_launch.restype = None
    lib.host_mmo_folded.argtypes = [ctypes.c_int, vp, vp, ctypes.c_longlong]
    lib.host_mmo_folded.restype = None
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


def _leaf_operands(seed, W, Kp, node_minor=False):
    """Random leaf planes, control bits and final CW planes (random words,
    not only lane masks: the kernel and the plain version compute the same
    function of any words)."""
    rng = np.random.default_rng(seed)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    cols = (Kp, W) if node_minor else (W, Kp)
    return words(128, *cols), words(*cols), words(128, 1, Kp)


_LEAF_PLAIN = {"bm": aes_cuda.convert_leaves_bm_plain,
               "canon": aes_cuda.convert_leaves_canon_plain}


def _check_leaf_columns(host_lib, canon, seed, W=5, Kp=32):
    S, T, fcw = _leaf_operands(seed, W, Kp)
    out = np.zeros((32 * Kp, W, 4), np.uint32)
    host_lib.host_leaf_launch(int(canon), _p(S), _p(T), _p(fcw), _p(out), W, Kp, 0, W, 0)
    want = _LEAF_PLAIN["canon" if canon else "bm"](*(to_carrier(a) for a in (S, T, fcw)))
    np.testing.assert_array_equal(out, from_carrier(want))


def test_mmo_canon_column_matches_plain(host_lib):
    # leaf_words_bm_kernel's per-column function over a launch at 32 key
    # words (tiles of 16 key words by 4 leaves, the second part empty at
    # W 5): the leaf MMO from bit-major planes, the final CW under t, the
    # per-key words.
    _check_leaf_columns(host_lib, False, seed=2)


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


@pytest.mark.parametrize("kind", ["bm", "canon"])
@pytest.mark.parametrize("B", [1, 33, 64, 97, 4097])
def test_prg_launch_matches_plain(host_lib, kind, B):
    # Every (block, thread) of one launch of prg_bm_kernel / prg_canon_kernel:
    # a warp pair half empty (33, 97), a block's second pair empty (1, 33,
    # 97, 4097), whole blocks (64).  Zeros where no thread writes would show.
    S = _planes(seed=40 + B, B=B)
    L, R = np.zeros_like(S), np.zeros_like(S)
    host_lib.host_prg_launch(int(kind == "canon"), S.ctypes.data, L.ctypes.data,
                             R.ctypes.data, B)
    plain = aes_cuda.prg_planes_canon_plain if kind == "canon" else aes_cuda.prg_planes_bm_plain
    pL, pR = plain(to_carrier(S))
    np.testing.assert_array_equal(L, from_carrier(pL))
    np.testing.assert_array_equal(R, from_carrier(pR))


@pytest.mark.parametrize("key", [0, 1])
def test_folded_cipher_is_the_counted_circuit(host_lib, key):
    # The PRG kernels' cipher (masks on the S-box outputs, the generated LOP3
    # instructions) computes the circuit that op_count traces and bounds them by.
    S = _planes(seed=50 + key, B=16)
    O = np.zeros_like(S)
    host_lib.host_mmo_folded(key, S.ctypes.data, O.ctypes.data, S.shape[1])
    dag, outs = op_count.trace_mmo(((RK_MASKS_L, RK_MASKS_R)[key],))
    np.testing.assert_array_equal(O, op_count.evaluate(dag, outs, S))


def _run_lop3_program(dag, program, inputs):
    val = {n: inputs[key[1]] for n, key in enumerate(dag.nodes) if key[0] == "in"}
    for dst, (a, b, c), imm in program:
        out = np.zeros_like(inputs[0])
        for i in range(8):
            if (imm >> i) & 1:
                out |= ((val[a] if i & 4 else ~val[a]) & (val[b] if i & 2 else ~val[b])
                        & (val[c] if i & 1 else ~val[c]))
        val[dst] = out
    return val


@pytest.mark.parametrize("name,count", [("masked_sbox_circuit", 90), ("mix_column_circuit", 75)])
def test_lop3_program_is_the_cover(name, count):
    # The instructions the PRG kernels run (generated into sbox_bp113.cuh)
    # are the cover op_count counts, and compute its circuit.
    dag, outs = getattr(op_count, name)()
    program = op_count.lop3_program(dag, outs)
    copies = sum((a, b, c, imm) == (a, a, a, 0xF0) for _, (a, b, c), imm in program)
    assert len(program) - copies == op_count.lop3_cover(dag, outs) == count
    n_in = sum(key[0] == "in" for key in dag.nodes)
    inputs = list(_planes(seed=60, B=8)[:n_in])
    val = _run_lop3_program(dag, program, inputs)
    np.testing.assert_array_equal(np.stack([val[o.n] for o in outs]),
                                  op_count.evaluate(dag, outs, np.stack(inputs)))


def test_mmo_canon_canon_column_matches_plain(host_lib):
    # leaf_words_canon_kernel's, from canonical planes.
    _check_leaf_columns(host_lib, True, seed=4)


@pytest.mark.parametrize("order", ["bm", "canon"])
@pytest.mark.parametrize("layout", ["level_major", "node_minor"])
@pytest.mark.parametrize("Kp", [1, 3])
@pytest.mark.parametrize("W", [1, 5, 33])
def test_leaf_launch_matches_plain(host_lib, order, layout, Kp, W):
    # Every (block, thread) of one leaf launch, in both plane orders and
    # both input layouts: tiles of 1 and 2 key words (Kp 1, 3) by 64 and 32
    # leaves, part empty at every W here (zeros where no thread writes would
    # show).
    node_minor = layout == "node_minor"
    S, T, fcw = _leaf_operands(1000 + 10 * W + Kp, W, Kp, node_minor)
    out = np.zeros((32 * Kp, W, 4), np.uint32)
    host_lib.host_leaf_launch(int(order == "canon"), _p(S), _p(T), _p(fcw), _p(out), W, Kp,
                              int(node_minor), W, 0)
    want = _LEAF_PLAIN[order](*(to_carrier(a) for a in (S, T, fcw)), node_minor=node_minor)
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("order", ["bm", "canon"])
@pytest.mark.parametrize("layout", ["level_major", "node_minor"])
def test_leaf_launch_ragged_key_tile(host_lib, order, layout):
    # 70 key words: in the level-major layout five tiles of 16 key words a
    # block, the last one 6 wide (its other threads store nothing).
    W, Kp = 2, 70
    node_minor = layout == "node_minor"
    S, T, fcw = _leaf_operands(1200, W, Kp, node_minor)
    out = np.zeros((32 * Kp, W, 4), np.uint32)
    host_lib.host_leaf_launch(int(order == "canon"), _p(S), _p(T), _p(fcw), _p(out), W, Kp,
                              int(node_minor), W, 0)
    want = _LEAF_PLAIN[order](*(to_carrier(a) for a in (S, T, fcw)), node_minor=node_minor)
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("order", ["bm", "canon"])
@pytest.mark.parametrize("layout", ["level_major", "node_minor"])
def test_leaf_launch_writes_at_its_leaf_offset(host_lib, order, layout):
    # The chunked route: two subtrees' leaf levels of W leaves each written
    # into one output of 2 W + 3 leaves a key, at leaf offsets 0 and W; the
    # last 3 leaves stay untouched.
    W, Kp = 45, 3
    node_minor = layout == "node_minor"
    out = np.zeros((32 * Kp, 2 * W + 3, 4), np.uint32)
    want = torch.zeros(out.shape, dtype=torch.int32)
    for half in range(2):
        S, T, fcw = _leaf_operands(1100 + half, W, Kp, node_minor)
        host_lib.host_leaf_launch(int(order == "canon"), _p(S), _p(T), _p(fcw), _p(out), W,
                                  Kp, int(node_minor), out.shape[1], half * W)
        _LEAF_PLAIN[order](*(to_carrier(a) for a in (S, T, fcw)), node_minor=node_minor,
                           out=want, leaf_offset=half * W)
    np.testing.assert_array_equal(out, from_carrier(want))
    assert not out[:, 2 * W :].any()


def _check_fused(host_lib, g, Kp, W, seed):
    rng = np.random.default_rng(seed)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    ops = [words(128, Kp, W), words(Kp, W), words(g, 128, Kp), words(g, Kp), words(g, Kp)]
    So = np.zeros((128, Kp, W << g), np.uint32)
    To = np.zeros((Kp, W << g), np.uint32)
    host_lib.host_fused(*(_p(a) for a in ops), _p(So), _p(To), Kp, W, g)
    pS, pT = aes_cuda.fused_levels_planes_plain(*(to_carrier(a) for a in ops))
    np.testing.assert_array_equal(So, from_carrier(pS))
    np.testing.assert_array_equal(To, from_carrier(pT))


@pytest.mark.parametrize("g,Kp,W", [(1, 2, 3), (2, 1, 4), (3, 2, 1), (4, 1, 2)])
def test_fused_column_matches_plain(host_lib, g, Kp, W):
    # Random words everywhere, plane 0 of the CWs included: the kernel and
    # the plain version compute the same function of any words.
    _check_fused(host_lib, g, Kp, W, seed=400 + 10 * g + W)


@pytest.mark.parametrize("g,Kp,W", [(4, 2, 3), (4, 1, 17), (2, 1, 65), (3, 3, 25)])
def test_fused_launch_matches_plain(host_lib, g, Kp, W):
    # Whole launches at odd widths: four levels from W odd, and Kp * W past
    # one block of 64 entry columns and not a multiple of it (the second
    # block's threads beyond N store nothing).
    _check_fused(host_lib, g, Kp, W, seed=500 + 10 * g + W)


@pytest.fixture(scope="module")
def chacha_lib(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "chacha_host", CHACHA_HOST_ENTRY)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_expand.argtypes = [ctypes.c_int, vp, ll, ll, ll, ll, ctypes.c_int,
                                vp, ll, vp, ll, vp, ll, vp, ll, ll, ctypes.c_int]
    lib.host_expand.restype = None
    lib.host_split_levels.argtypes = [ll, ctypes.c_int, ctypes.c_int]
    lib.host_split_levels.restype = ctypes.c_int
    lib.host_chacha_walk.argtypes = [vp] * 8 + [ll, ll, ctypes.c_int, ctypes.c_int]
    lib.host_chacha_walk.restype = None
    lib.host_chacha_walk_dcf.argtypes = [vp] * 9 + [ll, ll, ctypes.c_int, ctypes.c_int]
    lib.host_chacha_walk_dcf.restype = None
    lib.host_chacha_gen.argtypes = [vp] * 10 + [ll, ctypes.c_int, ctypes.c_int]
    lib.host_chacha_gen.restype = None
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


def _check_chacha_tail(lib, K, W, levels, split):
    """One tail launch (every thread index in turn) at split d (-1: the
    rule's) against the plain version."""
    st, scw, tcw, fcw = _state_and_cws(K, W, levels, seed=K + W + levels)
    out = np.zeros((K, W << levels, 16), np.uint32)
    lib.host_expand(1, _p(st), K * W, W, K, W, levels, _p(scw), 4 * levels, _p(tcw),
                    2 * levels, _p(fcw), 16, _p(out), 0, (W << levels) * 16, split)
    want = chacha_cuda.expand_tail_plain(to_carrier(st), to_carrier(scw),
                                         to_carrier(tcw), to_carrier(fcw))
    np.testing.assert_array_equal(out, from_carrier(want))


def _check_chacha_fused(lib, K, W, levels, split):
    """One fused-levels launch at split d (-1: the rule's) against the plain
    version."""
    st, scw, tcw, _ = _state_and_cws(K, W, levels, seed=10 * K + W + levels)
    out = np.zeros((5, K, W << levels), np.uint32)
    lib.host_expand(0, _p(st), K * W, W, K, W, levels, _p(scw), 4 * levels, _p(tcw),
                    2 * levels, None, 0, _p(out), K * (W << levels), W << levels, split)
    want = chacha_cuda.fused_levels_plain(to_carrier(st), to_carrier(scw), to_carrier(tcw))
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("K,W,levels", [(1, 1, 0), (1, 1, 6), (3, 5, 2), (9, 16, 4), (2, 3, 5)])
def test_chacha_tail_matches_plain(chacha_lib, K, W, levels):
    _check_chacha_tail(chacha_lib, K, W, levels, -1)


@pytest.mark.parametrize("K,W,levels", [(1, 1, 5), (4, 3, 2), (2, 8, 0)])
def test_chacha_fused_matches_plain(chacha_lib, K, W, levels):
    _check_chacha_fused(chacha_lib, K, W, levels, -1)


# (levels, split d) for every thread body of a launch: each L = 0..6 with
# each d from max(0, L - 2) (two levels below the path, M = 2) to L (one
# node a thread).  K * W = 15 or 6: not powers of two.
SPLITS = [(L, d) for L in range(7) for d in range(max(0, L - 2), L + 1)]


@pytest.mark.parametrize("levels,split", SPLITS)
def test_chacha_tail_split_matches_plain(chacha_lib, levels, split):
    _check_chacha_tail(chacha_lib, 3, 5, levels, split)


@pytest.mark.parametrize("levels,split", SPLITS)
def test_chacha_fused_split_matches_plain(chacha_lib, levels, split):
    _check_chacha_fused(chacha_lib, 2, 3, levels, split)


@pytest.mark.parametrize("leaf,nodes,levels,d", [
    (1, 1 << 17, 4, 2),  # config 2's tail: 1,024 keys x 128 entry nodes
    (1, 1 << 15, 5, 3),  # the subtree route's tail at n=20 (32 nodes a key)
    (1, 1 << 10, 6, 4),  # the whole-tree route's deepest tail, 1,024 keys
    (1, 1, 6, 5), (1, 1 << 20, 1, 0), (1, 7, 0, 0),
    (0, 1 << 10, 5, 4),  # config 2's first fused group, from the root
    (0, 1 << 15, 2, 1),  # its second, from 32 nodes a key
    (0, 1 << 15, 5, 3), (0, 1 << 20, 3, 1), (0, 5, 1, 0),
])
def test_chacha_split_rule(chacha_lib, leaf, nodes, levels, d):
    # The rule the launches take (chosen by timing d on the card): two
    # levels below each thread's path where the launch has threads enough
    # (2^14 for the tail, 2^16 for the fused levels), else one.
    assert chacha_lib.host_split_levels(nodes, levels, leaf) == d


@pytest.mark.parametrize("K,W,levels", [(1, 1, 6), (4, 3, 2), (1024, 1, 5), (33, 32, 2)])
def test_chacha_launch_split_follows_the_rule(chacha_lib, K, W, levels):
    # Whole launches at the rule's d, at a 1,024-key root and a ragged K.
    assert max(0, levels - 2) <= chacha_lib.host_split_levels(K * W, levels, 1) <= levels - 1
    _check_chacha_tail(chacha_lib, K, W, levels, -1)
    _check_chacha_fused(chacha_lib, K, W, levels, -1)


def _check_chacha_tail_strided(lib, split):
    """The chunked route's operands: a node range of a wider state, the CWs
    of the last levels of a deeper key, and a node range of a wider
    output, at split d (-1: the rule's)."""
    K, W, nu, first = 3, 8, 6, 4
    st, scw, tcw, fcw = _state_and_cws(K, W, nu, seed=7)
    levels = nu - first
    out = np.zeros((K, W << levels, 16), np.uint32)
    a, b = 2, 6
    sub = st[:, :, a:]
    lib.host_expand(1, _p(st) + 4 * a, K * W, W, K, b - a, levels, _p(scw) + 16 * first,
                    4 * nu, _p(tcw) + 8 * first, 2 * nu, _p(fcw), 16,
                    _p(out) + 64 * (a << levels), 0, (W << levels) * 16, split)
    want = chacha_cuda.expand_tail_plain(
        to_carrier(np.ascontiguousarray(sub[:, :, : b - a])),
        to_carrier(np.ascontiguousarray(scw[:, first:])),
        to_carrier(np.ascontiguousarray(tcw[:, first:])), to_carrier(fcw),
    )
    np.testing.assert_array_equal(out[:, a << levels : b << levels], from_carrier(want))
    assert not out[:, : a << levels].any() and not out[:, b << levels :].any()


def test_chacha_tail_strided_views_match_plain(chacha_lib):
    _check_chacha_tail_strided(chacha_lib, -1)


@pytest.mark.parametrize("split", [0, 1, 2])
def test_chacha_tail_strided_views_split_match_plain(chacha_lib, split):
    _check_chacha_tail_strided(chacha_lib, split)


@pytest.mark.parametrize("split", [-1, 1, 3])
def test_chacha_fused_strided_views_match_plain(chacha_lib, split):
    # The subtree route's operands: one node (W = 1) of a wider state and
    # the CWs of middle levels of a deeper key.
    K, W, nu, first, levels = 3, 8, 9, 2, 3
    st, scw, tcw, _ = _state_and_cws(K, W, nu, seed=8)
    out = np.zeros((5, K, 1 << levels), np.uint32)
    chacha_lib.host_expand(0, _p(st) + 4 * 5, K * W, W, K, 1, levels,
                           _p(scw) + 16 * first, 4 * nu, _p(tcw) + 8 * first, 2 * nu,
                           None, 0, _p(out), K << levels, 1 << levels, split)
    want = chacha_cuda.fused_levels_plain(
        to_carrier(np.ascontiguousarray(st[:, :, 5:6])),
        to_carrier(np.ascontiguousarray(scw[:, first : first + levels])),
        to_carrier(np.ascontiguousarray(tcw[:, first : first + levels])),
    )
    np.testing.assert_array_equal(out, from_carrier(want))


def _one_hot_select(rng, K, qp):
    """sel [128, K, qp]: each query's leaf bit one random canonical plane
    (random words would OR to ~0 whatever the walk computed)."""
    pick = rng.integers(0, 128, size=(32, K, qp))
    sel = np.zeros((128, K, qp), np.uint32)
    k, j = np.indices((K, qp))
    for lane in range(32):
        sel[pick[lane], k, j] |= np.uint32(1 << lane)
    return sel


def _check_walk(host_lib, K, qp, nu, seed):
    rng = np.random.default_rng(seed)
    words = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)  # noqa: E731
    ops = [words(128, K), words(K), words(nu, 128, K), words(nu, K), words(nu, K),
           words(128, K), words(nu, K, qp), _one_hot_select(rng, K, qp)]
    out = np.zeros((K, qp), np.uint32)
    host_lib.host_walk_bm(*(_p(a) for a in ops), _p(out), K, qp, nu)
    want = aes_cuda.eval_points_walk_planes_plain(*(to_carrier(a) for a in ops), nu)
    np.testing.assert_array_equal(out, from_carrier(want))


@pytest.mark.parametrize("K,qp,nu", [(1, 1, 0), (3, 2, 1), (2, 3, 3)])
def test_compat_walk_column_matches_plain(host_lib, K, qp, nu):
    # Random words everywhere but the one-hot select (not only lane masks):
    # the kernel and the plain version compute the same function of any words.
    _check_walk(host_lib, K, qp, nu, seed=100 + 10 * K + nu)


@pytest.mark.parametrize("K,qp,nu", [(3, 33, 2), (1, 45, 0), (5, 32, 1), (2, 70, 1)])
def test_compat_walk_launch_matches_plain(host_lib, K, qp, nu):
    # Whole launches in barrier order: qp not a multiple of 32 (a tile's
    # columns beyond qp reach every barrier and store nothing), nu = 0 (the
    # leaf alone), K odd, three tiles of one key.
    _check_walk(host_lib, K, qp, nu, seed=600 + 10 * K + qp + nu)


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
    for kb in dcf.gen_lt_batch(alphas, log_n, rng, device="cpu"):
        *ops, xs_hi, log_n_, nu = chacha_cuda.dcf_walk_args(kb, xs, device="cpu")
        ops = [from_carrier(a) for a in ops + [ops[-1] if xs_hi is None else xs_hi]]
        out = np.zeros((Q, K), np.uint32)
        chacha_lib.host_chacha_walk_dcf(*(_p(a) for a in ops), _p(out), Q, K, log_n_, nu)
        np.testing.assert_array_equal(out.T, dcf.eval_points_np(kb, xs))
        shares.append(out.T)
    np.testing.assert_array_equal(shares[0] ^ shares[1], xs < alphas[:, None])


@pytest.mark.parametrize("dcf_tower", [False, True], ids=["fast", "dcf"])
@pytest.mark.parametrize("nu", [0, 1, 23])
def test_chacha_gen_tower_matches_plain(chacha_lib, dcf_tower, nu):
    # Every key of one gen_tower_cc_kernel launch against gen_tower_plain on
    # random roots and path bits (K = 5: the bounds check is the launch's).
    rng = np.random.default_rng(40 + nu + 100 * dcf_tower)
    K = 5
    s0 = rng.integers(0, 1 << 32, size=(K, 4), dtype=np.uint32)
    s1 = rng.integers(0, 1 << 32, size=(K, 4), dtype=np.uint32)
    s0[:, 0] &= ~np.uint32(1)
    s1[:, 0] &= ~np.uint32(1)
    t0 = rng.integers(0, 2, size=K, dtype=np.uint32)
    t1 = t0 ^ np.uint32(1)
    bits = rng.integers(0, 2, size=(nu, K), dtype=np.uint32)
    outs = [np.zeros((nu, K, 4), np.uint32), np.zeros((nu, K), np.uint32),
            np.zeros((nu, K), np.uint32), np.zeros((K, 16), np.uint32)]
    vcw = np.zeros((nu, K), np.uint32)
    chacha_lib.host_chacha_gen(*(_p(a) for a in (s0, s1, t0, t1, bits, *outs)),
                               _p(vcw) if dcf_tower else None, K, nu, int(dcf_tower))
    want = chacha_cuda.gen_tower_plain(*(to_carrier(a) for a in (s0, s1, t0, t1, bits)),
                                       dcf_tower)
    got = outs + ([vcw] if dcf_tower else [])
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, from_carrier(w))
