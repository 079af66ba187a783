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
// g - 1 levels); q is blockIdx.y, so a block's threads share their path and
// the key of every step is uniform across the block.  The thread walks its
// path down to the last level's parent, one MMO a level with the path's key,
// then runs both MMOs of the last level and stores the two children.  The
// intermediate levels never leave the SM: the walked node lives in shared
// memory, word-major (st[p][lane], conflict-free), 512 B a thread, and each
// step reads it, encrypts in registers, and writes the child back in place.
// One step loop holds the one call site of the cipher, which keeps one copy
// of the unrolled round in the instruction cache.
//
// What bounds it: the ciphers, as in aes_mmo.cu.  The tree's g levels need
// 2 (2^g - 1) MMOs per entry column; this walk spends (g + 1) 2^(g - 1),
// recomputing the shared upper levels in each path's block instead of
// passing them through memory: 1x at g = 1 and 2, 8/7 at g = 3, 4/3 at
// g = 4.  The wrapper (ops/aes_cuda.py::fused_levels_planes) caps a launch at
// kFusedMaxG = 4 levels and splits a longer group into launches of at most 4,
// which leaves the bytes unchanged.
//
// The per-thread function compiles as host C++ too (define __host__,
// __device__, __constant__ empty and __forceinline__ as inline):
// tests/port/test_torch_kernel_host.py.

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

// Entry column j along path prefix q.  Step i < g - 1 takes level i's child
// on path bit (q >> (g - 2 - i)) & 1 into st; steps g - 1 and g are the last
// level's left and right children, stored to So and To.  st is the thread's
// 128-word buffer, plane p at index p * kStride.
template <int kStride>
__host__ __device__ inline void fused_column(const FusedArgs& a, long long j,
                                             unsigned q, uint32_t* st) {
  const size_t N = static_cast<size_t>(a.N), Kp = static_cast<size_t>(a.Kp);
  const size_t k = static_cast<size_t>(j) / static_cast<size_t>(a.W);
  const int g = a.g;
  uint32_t s[128];
  uint32_t T = a.T[j];
#pragma unroll 1
  for (int step = 0; step <= g; ++step) {
    const bool last = step >= g - 1;
    const int lvl = last ? g - 1 : step;
    const int key = last ? step - (g - 1) : (q >> (g - 2 - step)) & 1;
    // The parent: the entry column at level 0, else the walked node.
    const uint32_t* in = lvl ? st : a.S + j;
    const size_t is = lvl ? kStride : N;
#pragma unroll
    for (int p = 0; p < 128; ++p) s[p] = in[p * is];
    aes128_encrypt_bm(s, key);
    const uint32_t* cw = a.scw + static_cast<size_t>(lvl) * 128 * Kp + k;
    const uint32_t tc = s[0] ^ in[0] ^ ((key ? a.tr : a.tl)[lvl * Kp + k] & T);
    const size_t idx = (static_cast<size_t>(j) << g) | (static_cast<size_t>(q) << 1) | key;
    uint32_t* out = last ? a.So + idx : st;
    const size_t os = last ? N << g : kStride;
    // Plane 0 cleared, then the CW under the parent's t; in place for st.
#pragma unroll
    for (int p = 0; p < 128; ++p)
      out[p * os] = (p ? s[p] ^ in[p * is] : 0u) ^ (cw[p * Kp] & T);
    if (last)
      a.To[idx] = tc;
    else
      T = tc;
  }
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kFusedThreads = 64;

extern "C" __global__ void __launch_bounds__(kFusedThreads)
    fused_levels_bm_kernel(const FusedArgs a) {
  __shared__ uint32_t st[128 * kFusedThreads];
  const long long j = static_cast<long long>(blockIdx.x) * kFusedThreads + threadIdx.x;
  if (j >= a.N) return;
  fused_column<kFusedThreads>(a, j, blockIdx.y, st + threadIdx.x);
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_fused_bm(const void* S, const void* T, const void* scw,
                            const void* tl, const void* tr, void* So, void* To,
                            long long Kp, long long W, int g, void* stream) {
  const long long N = Kp * W;
  const long long blocks = (N + kFusedThreads - 1) / kFusedThreads;
  if (Kp < 1 || W < 1 || g < 1 || g > kFusedMaxG || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{static_cast<const uint32_t*>(S), static_cast<const uint32_t*>(T),
                    static_cast<const uint32_t*>(scw), static_cast<const uint32_t*>(tl),
                    static_cast<const uint32_t*>(tr), static_cast<uint32_t*>(So),
                    static_cast<uint32_t*>(To), N, W, Kp, g};
  fused_levels_bm_kernel<<<dim3(static_cast<unsigned>(blocks), 1u << (g - 1)),
                           kFusedThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
