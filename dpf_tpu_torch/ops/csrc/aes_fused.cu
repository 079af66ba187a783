// The compat profile's level-fused GGM expansion: g consecutive levels of the
// DPF tree in one launch, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel:
//   fused_levels_bm_kernel  dpf_tpu/ops/aes_pallas.py::_fused_levels_kernel_bm
//                           (wrapper fused_levels_planes, then
//                           fused_deinterleave): per level, the PRG on each
//                           node, plane 0 extracted as the child's t and then
//                           cleared, the seed CW XORed in under the parent's
//                           t, the t CWs likewise.
//
// Operands (int32 carriers of uint32 words on the PyTorch side, contiguous),
// in the reference's node-minor layout:
//   S      [128, Kp, W]       entry seeds, bit-major planes; column word
//                             j = k * W + w is node w of key word k
//   T      [Kp, W]            entry control bits
//   scw    [g, 128, Kp]       the g levels' seed CW planes, bit-major
//   tl, tr [g, Kp]            their t CWs
//   So     [128, Kp, W << g]  the children g levels down, ascending
//   To     [Kp, W << g]
// Node w's descendant along the path bits b_0 .. b_{g-1} (b_0 the first
// level's, 1 = right) is node (w << g) | b_0 .. b_{g-1}, so column j's
// descendants are columns (j << g) | path of the flattened [128, Kp * W << g]
// output.  The store index carries the ascending order: nothing reorders the
// children afterwards (the TPU kernel emits them in block order and
// fused_deinterleave gathers them back).
//
// Decomposition: one thread per (entry column j, path prefix q of the first
// g - 1 levels); q is the low g - 1 bits of blockIdx.x, so a block's threads
// share their path and the key of every step is uniform across the block,
// and the 2^(g-1) blocks of one column range run side by side: their
// children interleave in the output's sectors, which then reach L2 together
// (with q on blockIdx.y they met there two waves apart).  The thread walks
// its path down to the last level's parent, one MMO a level with the path's
// key, then runs the last level's two MMOs, one after the other, and stores
// the two children.  The intermediate levels never leave the SM: the walked
// node lives in shared memory, word-major (st[p][thread], conflict-free),
// 512 B a thread, and each step reads it, encrypts in registers, and writes
// the child back in place.  One step loop holds the one call site of the
// cipher, which keeps one copy of the round code in the instruction cache.
//
// Registers.  The cipher is aes_bm.cuh's folded form (folded_load,
// folded_rounds), as in aes_mmo.cu's PRG kernels: the state in 255 registers
// at most (four blocks of 64 threads an SM), the round keys of both keys
// moved to the S-box outputs (RK_SBOX) in the block's shared memory (11 KB
// beside the 32 KB of walked nodes), the S-box and MixColumns as the
// generated LOP3 lists, one round's code in a loop that is not unrolled.  A
// thread keeps its column, prefix, step and t in a slot of shared memory and
// reads them back by volatile loads after the round loop, since any value
// held across the loop spills.  The feed-forward loads the parent and the CW
// 16 planes at a time before storing the children: in place, in and out
// alias, so plane by plane each store waited for its load.  The last
// level's two MMOs stay in one thread: split over a pair of warps, as in the
// PRG kernels, each warp would need the walked parent, which one of them
// would compute for both (the other idle) or both would compute (the upper
// levels twice over).
//
// What bounds it: the ciphers, as in aes_mmo.cu.  The tree's g levels need
// 2 (2^g - 1) MMOs per entry column; this walk spends (g + 1) 2^(g - 1),
// recomputing the shared upper levels in each path's block instead of
// passing them through memory: 1x at g = 1 and 2, 8/7 at g = 3, 4/3 at
// g = 4.  The wrapper (ops/aes_cuda.py::fused_levels_planes) caps a launch at
// kFusedMaxG = 4 levels and splits a longer group into launches of at most 4,
// which leaves the bytes unchanged.
//
// The step's phases (fused_load, fused_store) compile as host C++ too
// (define __host__, __device__, __constant__ empty and __forceinline__ as
// inline): tests/port/test_torch_kernel_host.py runs every thread of a
// launch there.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

// One launch's operands (a kernel parameter, so at namespace scope).
struct FusedArgs {
  const uint32_t* S;
  const uint32_t* T;
  const uint32_t* scw;
  const uint32_t* tl;
  const uint32_t* tr;
  uint32_t* So;
  uint32_t* To;
  long long N, W, Kp;  // N = Kp * W entry columns
  int g;
};

constexpr int kFusedMaxG = 4;

namespace {

constexpr int kFusedThreads = 64;

// Thread (entry column j, path prefix q), step `step`: step i < g - 1 takes
// level i's child on path bit (q >> (g - 2 - i)) & 1 into st; steps g - 1
// and g are the last level's left and right children, stored to So and To.
// st is the thread's 128-word buffer (plane p at index p * kStride), T its
// walked node's t.  Each step is fused_load, folded_rounds, fused_store.
__host__ __device__ __forceinline__ int fused_key(const FusedArgs& a, unsigned q, int step) {
  return step >= a.g - 1 ? step - (a.g - 1) : (q >> (a.g - 2 - step)) & 1;
}

// The cipher's input: the parent (the entry column at level 0, else the
// walked node) with round 0's key of the step's key into s; returns that
// key's masks (rk: the block's copy of RK_SBOX) for folded_rounds.
template <int kStride>
__host__ __device__ __forceinline__ const uint32_t* fused_load(const FusedArgs& a, size_t j,
                                                               unsigned q, int step,
                                                               const uint32_t* st,
                                                               const uint32_t* rk,
                                                               uint32_t s[128]) {
  const uint32_t* rkk = rk + fused_key(a, q, step) * (kRkWords / 2);
  if (step && a.g > 1)
    folded_load<false>(s, st, kStride, 0, rkk);
  else
    folded_load<false>(s, a.S, static_cast<size_t>(a.N), j, rkk);
  return rkk;
}

// After the cipher: the child, plane 0 cleared and the CW XORed in under the
// parent's t, into st in place (upper levels) or So and To at the ascending
// index (j << g) | (q << 1) | key (the last level).  The parent and the CW
// are loaded kChunk planes at a time before their children are stored: the
// compiler must take in and out to alias (in place, they do), so a loop
// that loads and stores plane by plane waits out each load's latency.
template <int kStride>
__host__ __device__ inline void fused_store(const FusedArgs& a, size_t j, unsigned q,
                                            int step, uint32_t* st, uint32_t* T,
                                            const uint32_t s[128]) {
  constexpr int kChunk = 16;
  const size_t N = static_cast<size_t>(a.N), Kp = static_cast<size_t>(a.Kp);
  const int g = a.g;
  const bool last = step >= g - 1;
  const int lvl = last ? g - 1 : step, key = fused_key(a, q, step);
  const size_t k = j / static_cast<size_t>(a.W);
  const uint32_t* in = lvl ? st : a.S + j;
  const size_t is = lvl ? kStride : N;
  const uint32_t* cw = a.scw + static_cast<size_t>(lvl) * 128 * Kp + k;
  const uint32_t t = *T;
  const uint32_t tc = s[0] ^ in[0] ^ ((key ? a.tr : a.tl)[lvl * Kp + k] & t);
  const size_t idx = (j << g) | (static_cast<size_t>(q) << 1) | key;
  uint32_t* out = last ? a.So + idx : st;
  const size_t os = last ? N << g : kStride;
#pragma unroll
  for (int p0 = 0; p0 < 128; p0 += kChunk) {
    uint32_t x[kChunk], c[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      x[i] = in[(p0 + i) * is];
      c[i] = cw[(p0 + i) * Kp];
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int p = p0 + i;
      out[p * os] = (p ? s[p] ^ x[i] : 0u) ^ (c[i] & t);
    }
  }
  if (last)
    a.To[idx] = tc;
  else
    *T = tc;
}

// A thread's slot of the block's shared memory: its entry column, path
// prefix, index in the block and step, and its walked node's t.
struct FusedSlot {
  size_t j;
  unsigned q;
  int t, step;
  uint32_t T;
};

// A fused block's shared memory.
struct FusedShared {
  alignas(16) uint32_t rk[kRkWords];  // RK_SBOX, both keys
  uint32_t st[128 * kFusedThreads];   // the walked nodes, st[p][thread]
  FusedSlot slot[kFusedThreads];
};

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

// This thread's slot, by volatile loads: no stage of the compiler may merge
// them with the loads before the round loop and keep the values live across
// it, in registers the rounds need (which spills).
__device__ __forceinline__ FusedSlot fused_slot(const FusedShared& sh) {
  const volatile FusedSlot& v = sh.slot[threadIdx.x];
  return {v.j, v.q, v.t, v.step, v.T};
}

// Block b = blockIdx.x >> (g - 1) takes entry columns b * kFusedThreads +
// thread along path prefix q, the low g - 1 bits of blockIdx.x: the blocks
// of one column range run side by side, so their children, which share the
// output's sectors, reach L2 together.
extern "C" __global__ void __launch_bounds__(kFusedThreads, 4)
    fused_levels_bm_kernel(const FusedArgs a) {
  __shared__ FusedShared sh;
  copy_rk_sbox(sh.rk, threadIdx.x, kFusedThreads);
  __syncthreads();
  const size_t j = static_cast<size_t>(blockIdx.x >> (a.g - 1)) * kFusedThreads + threadIdx.x;
  if (j >= static_cast<size_t>(a.N)) return;
  sh.slot[threadIdx.x] = {j, blockIdx.x & ((1u << (a.g - 1)) - 1),
                          static_cast<int>(threadIdx.x), 0, a.T[j]};
#pragma unroll 1
  for (;;) {
    uint32_t s[128];
    const uint32_t* rk;
    {
      const FusedSlot x = fused_slot(sh);
      if (x.step > a.g) return;
      rk = fused_load<kFusedThreads>(a, x.j, x.q, x.step, sh.st + x.t, sh.rk, s);
    }
    folded_rounds(s, rk);
    const FusedSlot x = fused_slot(sh);
    fused_store<kFusedThreads>(a, x.j, x.q, x.step, sh.st + x.t, &sh.slot[x.t].T, s);
    sh.slot[x.t].step = x.step + 1;
  }
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_fused_bm(const void* S, const void* T, const void* scw,
                            const void* tl, const void* tr, void* So, void* To,
                            long long Kp, long long W, int g, void* stream) {
  const long long N = Kp * W;
  if (Kp < 1 || W < 1 || g < 1 || g > kFusedMaxG)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (N + kFusedThreads - 1) / kFusedThreads << (g - 1);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{static_cast<const uint32_t*>(S), static_cast<const uint32_t*>(T),
                    static_cast<const uint32_t*>(scw), static_cast<const uint32_t*>(tl),
                    static_cast<const uint32_t*>(tr), static_cast<uint32_t*>(So),
                    static_cast<uint32_t*>(To), N, W, Kp, g};
  fused_levels_bm_kernel<<<static_cast<unsigned>(blocks), kFusedThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
