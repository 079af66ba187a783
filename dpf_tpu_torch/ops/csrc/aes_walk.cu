// Compat-profile pointwise evaluation: the whole root-to-leaf walk of one
// key's queries, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel:
//   walk_bm_kernel  dpf_tpu/ops/aes_pallas.py::_walk_kernel_bm (wrapper
//                   eval_points_walk_planes): nu levels of the double MMO,
//                   the control-bit plane extracted and cleared, the seed CW
//                   XORed in under t, each query's child chosen by its path
//                   bit; then the leaf MMO, canonical plane order, the final
//                   CW under t, and the leaf bit picked by a one-hot select.
//
// Operands (int32 carriers of uint32 words on the PyTorch side, contiguous),
// every key word a lane mask (0 or ~0):
//   seeds  [128, K]      root seed planes, bit-major
//   t      [K]           root control bit
//   scw    [nu, 128, K]  seed CW planes, bit-major
//   tl, tr [nu, K]       the t CWs
//   fcw    [128, K]      final CW planes, canonical order
//   pw     [nu, K, qp]   bit l of pw[i, k, j]: level i's path bit of query
//                        32 j + l of key k (1 = right)
//   sel    [128, K, qp]  bit l of sel[p, k, j]: 1 where that query's leaf
//                        bit is canonical plane p
//   out    [K, qp]       the output bits, packed the same way
//
// Decomposition: a column (key k, query word j) holds 32 queries of one key
// as the 32 blocks of a bitsliced state, so the per-key masks broadcast over
// a warp.  A block is one pair of warps on the 32 columns of one tile of
// key k (keys on blockIdx.x, tiles of 32 query words on blockIdx.y); warp
// `key` runs that key's MMO at every level, one MMO a thread, so the key is
// uniform across each warp and one copy of the round code serves both.  The
// pair's parent S lives in shared memory, word-major (st[p][lane],
// conflict-free), and both warps read it for the cipher's input and its
// feed-forward.  A level has two phases, split by two block barriers:
//   1. both warps encrypt S; the left warp writes its child under ~go (go
//      the level's path word) into nx and its t into tl; the right warp
//      keeps its child in registers (walk_child);
//   2. the right warp writes S = (child & go) | nx and the new T
//      (walk_combine), while the left warp stages the next level's CWs of
//      key k in shared memory (walk_stage: 130 words a level, read by both
//      warps as broadcasts, where each thread would load them from L1);
// then the next level reads S, T and the CWs.  The leaf MMO (key L) runs on
// the left warp after the last level, and the right warp ends there
// (walk_leaf).  The leaf is 1 / (2 nu + 1) of the work.  Any K >= 1 and
// qp >= 1 run: a column beyond qp computes its tile's last column, reaches
// every barrier and stores nothing; nu = 0 (log_n <= 7) runs the leaf
// alone, after the one barrier that follows the block's set-up.
//
// Registers.  The folded cipher (aes_bm.cuh: folded_load, folded_rounds)
// keeps its 128-word state in registers, 255 a thread at most, so an SM
// holds four pairs (eight warps), with the round keys
// of both keys moved to the S-box outputs (RK_SBOX) in the block's shared
// memory and the S-box and MixColumns as the generated LOP3 lists.  The
// rounds leave no register to spare: a thread keeps its place (key, lane,
// column) and its level in a slot of shared memory and reads them back by
// volatile loads after the round loop (walk_thread), since every value held
// across the loop spilled (a re-read of the special registers was merged
// with the read before the loop); the leaf's one-hot selects are staged
// in nx before its cipher rather than loaded after it; and global rows are
// copied 32 at a time (walk_copy_column), as a loop that stores each row
// before loading the next waits out every load.  Shared memory: 11 KB of
// masks, 16 KB for S, 16 KB for nx, 0.8 KB for T, tl and the CWs, 2.5 KB of
// slots, 46.3 KB a block.  Both MMOs of a level and the leaf's go through
// one call site of the cipher, so the kernel holds one copy of the round code.
//
// What bounds it: the ciphers, as in aes_mmo.cu.  A column does nu PRGs and
// one leaf MMO (ops/op_count.py::walk_lop3_per_column) against about
// (2 nu + 130) words of traffic of its own.
//
// The phases compile as host C++ too (define __host__, __device__,
// __constant__ empty and __forceinline__ as inline):
// tests/port/test_torch_kernel_host.py runs every phase of a launch there, in
// the kernel's barrier order.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

// One launch's operands (a kernel parameter, so at namespace scope).
struct WalkArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* scw;
  const uint32_t* tl;
  const uint32_t* tr;
  const uint32_t* fcw;
  const uint32_t* pw;
  const uint32_t* sel;
  uint32_t* out;
  long long K, qp;
  int nu;
};

namespace {

// Threads of a walk block: one pair of warps, warp `key` for key L or R.
constexpr int kWalkThreads = 64;

// A thread's place in a walk launch: its warp's key, its lane, its column
// (key k, query word j), and jc, the column its loads read (j, or the last
// query word of the tile's key where j >= qp).
struct WalkThread {
  int key, lane;
  size_t k, j, jc;
};

// A walk block's shared memory.
struct WalkShared {
  alignas(16) uint32_t rk[kRkWords];  // RK_SBOX, both keys
  uint32_t st[128 * 32];              // the pair's parent S, plane p at p * 32
  uint32_t nx[128 * 32];              // the left children under ~go; the leaf's selects
  uint32_t T[32];                     // the parents' t
  uint32_t tl[32];                    // the left children's t
  uint32_t cw[128];                   // the level's seed CW of key k (the leaf's: its final CW)
  uint32_t tcw[2];                    // the level's t CWs of key k, L and R
  struct {
    WalkThread x;  // the thread's place
    int level;     // and its level
  } slot[kWalkThreads];
};

// Level i's correction words of key k into the block's cw and tcw (the
// left warp, four words a lane): the seed CW and the t CWs, or at i = nu
// the leaf's final CW.  At the set-up for level 0, and for level i + 1 in
// phase 2 of level i, after phase 1 of level i has read them.
__host__ __device__ inline void walk_stage(const WalkArgs& a, int i, const WalkThread& x,
                                           WalkShared& sh) {
  const size_t K = static_cast<size_t>(a.K);
  const uint32_t* cw = i < a.nu ? a.scw + static_cast<size_t>(i) * 128 * K : a.fcw;
#pragma unroll
  for (int m = 0; m < 4; ++m) sh.cw[32 * m + x.lane] = cw[(32 * m + x.lane) * K + x.k];
  if (i < a.nu && x.lane < 2) sh.tcw[x.lane] = (x.lane ? a.tr : a.tl)[i * K + x.k];
}

// Rows 0-127 of one column (src[p * stride]) into this lane's column of a
// 32-column plane-major buffer (dst[p * 32]), 32 rows loaded before any is
// stored: the compiler must take the two to alias, so a loop that loads and
// stores row by row waits out each load's latency.
__host__ __device__ inline void walk_copy_column(uint32_t* dst, const uint32_t* src,
                                                 size_t stride) {
#pragma unroll 1
  for (int p0 = 0; p0 < 128; p0 += 32) {
    uint32_t v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = src[(p0 + i) * stride];
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[(p0 + i) * 32] = v[i];
  }
}

// Set-up (the left warp, before the block's first barrier): key k's root
// seed and t into the pair's S and T, and level 0's CWs.
__host__ __device__ inline void walk_init(const WalkArgs& a, const WalkThread& x,
                                          WalkShared& sh) {
  walk_copy_column(sh.st + x.lane, a.seeds + x.k, static_cast<size_t>(a.K));
  sh.T[x.lane] = a.t[x.k];
  walk_stage(a, 0, x, sh);
}

// The cipher's input and its masks: the parent of column x.lane with round
// 0's key of x.key into s; returns that key's masks for folded_rounds.
__host__ __device__ __forceinline__ const uint32_t* walk_load(uint32_t s[128],
                                                              const WalkShared& sh,
                                                              const WalkThread& x) {
  const uint32_t* rk = sh.rk + x.key * (kRkWords / 2);
  folded_load<false>(s, sh.st + x.lane, 32, 0, rk);
  return rk;
}

// Phase 1 of level i, after the cipher (both warps): the child of key x.key
// is the MMO output s ^ S, plane 0 (the control-bit plane) cleared, the seed
// CW XORed in under the parent's t.  The left warp writes it under ~go into
// nx and its t into tl; the right warp keeps it in s.  Returns the child's
// t; go is set to the level's path word of column x.jc.
__host__ __device__ inline uint32_t walk_child(const WalkArgs& a, int i, const WalkThread& x,
                                               uint32_t s[128], WalkShared& sh,
                                               uint32_t& go) {
  const size_t K = static_cast<size_t>(a.K), qp = static_cast<size_t>(a.qp);
  const uint32_t T = sh.T[x.lane];
  const uint32_t* st = sh.st + x.lane;
  go = a.pw[(i * K + x.k) * qp + x.jc];
  const uint32_t tc = s[0] ^ st[0] ^ (sh.tcw[x.key] & T);
  if (x.key) {
#pragma unroll
    for (int p = 0; p < 128; ++p) s[p] = (p ? s[p] ^ st[p * 32] : 0u) ^ (sh.cw[p] & T);
  } else {
    const uint32_t keep = ~go;
#pragma unroll
    for (int p = 0; p < 128; ++p)
      sh.nx[p * 32 + x.lane] = ((p ? s[p] ^ st[p * 32] : 0u) ^ (sh.cw[p] & T)) & keep;
    sh.tl[x.lane] = tc;
  }
  return tc;
}

// Phase 2 of a level (the right warp, between the level's two barriers):
// the child on each query's path into S, and its t into T.
__host__ __device__ inline void walk_combine(const WalkThread& x, const uint32_t s[128],
                                             uint32_t go, uint32_t tr, WalkShared& sh) {
#pragma unroll
  for (int p = 0; p < 128; ++p)
    sh.st[p * 32 + x.lane] = (s[p] & go) | sh.nx[p * 32 + x.lane];
  sh.T[x.lane] = (tr & go) | (sh.tl[x.lane] & ~go);
}

// The leaf's one-hot selects of column x.jc into nx (the left warp, before
// the leaf's cipher; nx is free after the last level's barriers): loads
// coalesced across the warp, none of them held across the cipher.
__host__ __device__ inline void walk_stage_select(const WalkArgs& a, const WalkThread& x,
                                                  WalkShared& sh) {
  const size_t K = static_cast<size_t>(a.K), qp = static_cast<size_t>(a.qp);
  walk_copy_column(sh.nx + x.lane, a.sel + x.k * qp + x.jc, K * qp);
}

// The leaf (the left warp), s the key-L cipher of the leaf's S: canonical
// plane p = 8 * byte + bit is bit-major register 16 * bit + byte; the
// feed-forward, the final CW under t, and the one-hot bit select of column
// j (stored only if j < qp).
__host__ __device__ inline void walk_leaf(const WalkArgs& a, const WalkThread& x,
                                          const uint32_t s[128], const WalkShared& sh) {
  const size_t qp = static_cast<size_t>(a.qp);
  const uint32_t T = sh.T[x.lane];
  uint32_t o = 0;
#pragma unroll
  for (int p = 0; p < 128; ++p) {
    const int q = 16 * (p & 7) + (p >> 3);
    const uint32_t c = s[q] ^ sh.st[q * 32 + x.lane] ^ (sh.cw[p] & T);
    o |= c & sh.nx[p * 32 + x.lane];
  }
  if (x.j < qp) a.out[x.k * qp + x.j] = o;
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

// This thread's place and level, as the kernel stored them in its slot of
// the block's shared memory, by volatile loads: no stage of the compiler may
// merge them with the loads before the round loop and keep the values live
// across it, in registers the rounds need (a re-read of the special
// registers was merged so and spilled, as were the level counter and a
// second slot address).
__device__ __forceinline__ WalkThread walk_thread(const WalkShared& sh) {
  const volatile WalkThread& v = sh.slot[threadIdx.x].x;
  return {v.key, v.lane, v.k, v.j, v.jc};
}

__device__ __forceinline__ int walk_level(const WalkShared& sh) {
  return *static_cast<const volatile int*>(&sh.slot[threadIdx.x].level);
}

extern "C" __global__ void __launch_bounds__(kWalkThreads, 4)
    walk_bm_kernel(const WalkArgs a) {
  __shared__ WalkShared sh;
  copy_rk_sbox(sh.rk, threadIdx.x, kWalkThreads);
  {
    const size_t qp = static_cast<size_t>(a.qp);
    const size_t j = static_cast<size_t>(blockIdx.y) * 32 + (threadIdx.x & 31);
    const WalkThread x{static_cast<int>(threadIdx.x >> 5), static_cast<int>(threadIdx.x & 31),
                       blockIdx.x, j, j < qp ? j : qp - 1};
    sh.slot[threadIdx.x].x = x;
    sh.slot[threadIdx.x].level = 0;
    if (x.key == 0) walk_init(a, x, sh);
  }
  __syncthreads();
#pragma unroll 1
  for (;;) {
    uint32_t s[128];
    const uint32_t* rk;
    {
      const WalkThread x = walk_thread(sh);
      if (walk_level(sh) == a.nu) {  // the leaf
        if (x.key) return;           // the right warp: no barrier follows
        walk_stage_select(a, x, sh);
      }
      rk = walk_load(s, sh, x);
    }
    folded_rounds(s, rk);
    const WalkThread x = walk_thread(sh);
    const int i = walk_level(sh);
    if (i == a.nu) {
      walk_leaf(a, x, s, sh);
      return;
    }
    uint32_t go;
    const uint32_t tc = walk_child(a, i, x, s, sh, go);
    __syncthreads();
    if (x.key)
      walk_combine(x, s, go, tc, sh);
    else
      walk_stage(a, i + 1, x, sh);
    sh.slot[threadIdx.x].level = i + 1;
    __syncthreads();
  }
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_walk_bm(const void* seeds, const void* t, const void* scw,
                           const void* tl, const void* tr, const void* fcw,
                           const void* pw, const void* sel, void* out,
                           long long K, long long qp, int nu, void* stream) {
  const long long tiles = (qp + 31) / 32;
  if (K < 1 || qp < 1 || nu < 0 || K > 0x7FFFFFFFLL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WalkArgs a{static_cast<const uint32_t*>(seeds), static_cast<const uint32_t*>(t),
                   static_cast<const uint32_t*>(scw), static_cast<const uint32_t*>(tl),
                   static_cast<const uint32_t*>(tr), static_cast<const uint32_t*>(fcw),
                   static_cast<const uint32_t*>(pw), static_cast<const uint32_t*>(sel),
                   static_cast<uint32_t*>(out), K, qp, nu};
  walk_bm_kernel<<<dim3(static_cast<unsigned>(K), static_cast<unsigned>(tiles)),
                   kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_walk_bm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
