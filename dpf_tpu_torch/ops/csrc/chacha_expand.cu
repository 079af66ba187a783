// ChaCha12 GGM expansion for the fast profile, written by hand for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernels (both wrap one level body,
// dpf_tpu/ops/chacha_pallas.py::_expand_levels_body):
//   expand_tail_kernel    dpf_tpu/ops/chacha_pallas.py::_expand_kernel
//                         (wrapper _expand_raw): L GGM levels, then the
//                         512-bit leaf convert (DS_LEAF) and the final CW.
//   fused_levels_kernel   dpf_tpu/ops/chacha_pallas.py::_fused_levels_kernel
//                         (wrapper fused_levels_raw): G GGM levels, no leaf
//                         convert; 4 seed words plus t out.
//
// Layout (int32 carriers on the PyTorch side, any strides given here):
//   state  [5, K, W]   rows 0..3 the seed words, row 4 the control bit (0/1)
//   scw    [K, L, 4]   the seed CWs of the levels this launch runs
//   tcw    [K, L, 2]   (tLCW, tRCW) of those levels, 0/1
//   fcw    [K, 16]     the final CW (tail only)
//   tail out   [K, W << L, 16]   leaf words, ascending leaf order
//   fused out  [5, K, W << G]    child state, ascending node order
// The Pallas kernels emit children in block order [all-L | all-R] and a gather
// restores the order afterwards; here each thread writes its subtree's nodes
// straight to their ascending positions, so no gather follows.
//
// Decomposition: one thread per (key, entry node).  It walks the node's
// subtree depth first, keeping the right children it has still to visit on a
// stack of at most kMaxLevels (seed, t) entries, so every GGM expansion of the
// subtree runs exactly once (2^L - 1 of them, plus 2^L leaf converts).  Any K
// and any W >= 1 take the same kernel: the grid covers K * W threads with a
// bounds check; the root (W = 1) and small trees (W < 128) need no padding.
//
// What bounds it on this card: integer issue, not memory.  One ChaCha12 block
// is 6 double rounds of 8 quarter rounds, each 4 adds, 4 xors (LOP3) and 4
// rotates (SHF, __funnelshift_l), plus the feed-forward and the CW work,
// less the operations on the zero counter words, which fold: 595
// instructions per expansion and 601 per leaf convert (ops/op_count.py).
// A leaf convert writes 64 bytes, some 9 instructions per byte, against the
// H100's issue rate over its memory rate of about 5.  LOP3 and SHF share the
// integer ALU pipe; the adds can issue as IMAD on the FMA pipe (the compiler
// does so), so the ALU pipe's 394-396 instructions per block set the bound.
// The CWs of a key are read by every thread of that key (L1 hot); the state is
// read once and the output written once.
//
// The arithmetic compiles as host C++ too (define __host__, __device__ empty
// and __forceinline__ as inline), which is how
// tests/port/test_torch_kernel_host.py checks it without a GPU.

#include <cstddef>
#include <cstdint>

#include "chacha12.cuh"

namespace {

// The deepest subtree one thread walks: the whole-tree route's nu <= 12
// (ops/chacha_cuda.py::_EXP_SMALL_MAX_NU).
constexpr int kMaxLevels = 12;

// Leaf convert plus the final CW under t (_convert_leaves_cc), stored as one
// 64-byte row.
__host__ __device__ __forceinline__ void leaf_store(const uint32_t s[4],
                                                    uint32_t t,
                                                    const uint32_t* fcw,
                                                    uint32_t* dst) {
  uint32_t o[16];
  chacha12<16>(s, CC_DS_LEAF, o);
  const uint32_t msk = 0u - t;
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] ^= fcw[j] & msk;
#ifdef __CUDA_ARCH__
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d4[q] = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
#else
  for (int j = 0; j < 16; ++j) dst[j] = o[j];
#endif
}

__host__ __device__ __forceinline__ int trailing_ones(unsigned j) {
#ifdef __CUDA_ARCH__
  return __ffs(~j) - 1;
#else
  return __builtin_ctz(~j);
#endif
}

}  // namespace

// One launch's operands (a kernel parameter, so at namespace scope).
struct ExpandArgs {
  const uint32_t* st;  // state [5, K, W]
  long long st_row, st_key;
  long long K, W;
  int levels;
  const uint32_t* scw;  // [K, levels, 4], key stride scw_key, inner contiguous
  long long scw_key;
  const uint32_t* tcw;  // [K, levels, 2]
  long long tcw_key;
  const uint32_t* fcw;  // [K, 16] (LEAF only)
  long long fcw_key;
  uint32_t* out;  // LEAF: [K, W << levels, 16]; else [5, K, W << levels]
  long long out_row, out_key;
};

namespace {

// The work of thread i: entry node i % W of key i / W, its whole subtree.
template <bool LEAF>
__host__ __device__ inline void expand_node(const ExpandArgs& a, long long i) {
  const long long k = i / a.W, w = i - k * a.W;
  const uint32_t* sp = a.st + k * a.st_key + w;
  uint32_t s[4], t = sp[4 * a.st_row];
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = sp[q * a.st_row];
  const uint32_t* scw = a.scw + k * a.scw_key;
  const uint32_t* tcw = a.tcw + k * a.tcw_key;
  const uint32_t* fcw = LEAF ? a.fcw + k * a.fcw_key : nullptr;
  uint32_t* out = a.out + k * a.out_key + (w << a.levels) * (LEAF ? 16 : 1);

  uint32_t stk_s[kMaxLevels][4], stk_t[kMaxLevels];  // right children to visit
  const int levels = a.levels;
  const unsigned n = 1u << levels;
  int depth = 0;
  for (unsigned j = 0; j < n; ++j) {
    while (depth < levels) {  // descend left, keeping each right child
      uint32_t l[4], r[4], tl, tr;
      level_step(s, t, scw + 4 * depth, tcw[2 * depth], tcw[2 * depth + 1], l,
                 tl, r, tr);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        stk_s[depth][q] = r[q];
        s[q] = l[q];
      }
      stk_t[depth] = tr;
      t = tl;
      ++depth;
    }
    if (LEAF) {
      leaf_store(s, t, fcw, out + 16 * static_cast<size_t>(j));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q * a.out_row + j] = s[q];
      out[4 * a.out_row + j] = t;
    }
    if (j + 1 < n) {
      // Leaf j's path bits, MSB first, are its left/right choices: back up
      // to the deepest left turn and take the right child kept there.
      depth = levels - 1 - trailing_ones(j);
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = stk_s[depth][q];
      t = stk_t[depth];
      ++depth;
    }
  }
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kChachaThreads = 128;

extern "C" __global__ void __launch_bounds__(kChachaThreads)
    expand_tail_kernel(const ExpandArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kChachaThreads + threadIdx.x;
  if (i < a.K * a.W) expand_node<true>(a, i);
}

extern "C" __global__ void __launch_bounds__(kChachaThreads)
    fused_levels_kernel(const ExpandArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kChachaThreads + threadIdx.x;
  if (i < a.K * a.W) expand_node<false>(a, i);
}

static int launch(bool leaf, const ExpandArgs& a, void* stream) {
  if (a.levels < 0 || a.levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = a.K * a.W;
  const unsigned blocks = static_cast<unsigned>((n + kChachaThreads - 1) / kChachaThreads);
  auto s = static_cast<cudaStream_t>(stream);
  if (leaf)
    expand_tail_kernel<<<blocks, kChachaThreads, 0, s>>>(a);
  else
    fused_levels_kernel<<<blocks, kChachaThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_chacha_tail(const void* st, long long st_row, long long st_key,
                               long long K, long long W, int levels,
                               const void* scw, long long scw_key,
                               const void* tcw, long long tcw_key,
                               const void* fcw, long long fcw_key, void* out,
                               long long out_key, void* stream) {
  const ExpandArgs a{static_cast<const uint32_t*>(st), st_row, st_key, K, W, levels,
                     static_cast<const uint32_t*>(scw), scw_key,
                     static_cast<const uint32_t*>(tcw), tcw_key,
                     static_cast<const uint32_t*>(fcw), fcw_key,
                     static_cast<uint32_t*>(out), 0, out_key};
  return launch(true, a, stream);
}

extern "C" int dpf_chacha_fused(const void* st, long long st_row, long long st_key,
                                long long K, long long W, int levels,
                                const void* scw, long long scw_key,
                                const void* tcw, long long tcw_key, void* out,
                                long long out_row, long long out_key,
                                void* stream) {
  const ExpandArgs a{static_cast<const uint32_t*>(st), st_row, st_key, K, W, levels,
                     static_cast<const uint32_t*>(scw), scw_key,
                     static_cast<const uint32_t*>(tcw), tcw_key, nullptr, 0,
                     static_cast<uint32_t*>(out), out_row, out_key};
  return launch(false, a, stream);
}

extern "C" const char* dpf_chacha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
