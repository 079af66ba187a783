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
// Decomposition: each entry node's subtree of L levels is split over 2^d
// threads, d = split_levels(K * W, L, leaf), a fixed rule on the launch's
// shape.  Thread i is path p = i % 2^d of entry node i / 2^d (key node / W,
// node node % W): the path is the fastest index, so neighbouring lanes own
// neighbouring output ranges.  A thread walks the d levels of its own path
// (one expansion a level, keeping the child its bit names), then the last
// M = L - d levels of its subtree depth first, keeping the right children it
// has still to visit on a stack of M (seed, t) entries: d + 2^M - 1
// expansions and 2^M leaf converts (or node stores) a thread.  M is a
// template parameter (the launch switches on it), so every stack index is a
// constant and the stack lives in registers: no local memory.
//
// Why split: one thread per entry node leaves the top of the tree to a few
// warps an SM (config 2's first fused group: 1,024 threads, each 31
// expansions in a row) and the tail to 31 warps an SM running 31 blocks of
// ChaCha each, too few to cover the rounds' dependent adds, xors and
// rotates.  The split buys 2^d times the threads and a critical path of
// d + 2^M - 1 expansions for the path levels that sibling threads recompute
// (at config 2's tail, d = 2: 36 blocks a subtree instead of 31).  The rule
// keeps M = 2 where the launch has threads enough and M = 1 where it has
// not, as timed on the card (scripts/time_chacha_split.py); M = 0 is a
// launch of no levels (the leaf convert alone).  Any K and any W >= 1 take
// the same kernel: the grid covers (K * W) << d threads with a bounds check.
//
// What bounds it on this card: integer issue, not memory.  The bound counts
// the function's work, 2^L - 1 expansions and 2^L leaf converts an entry
// node, not the split's recomputation.  One ChaCha12 block is 6 double
// rounds of 8 quarter rounds, each 4 adds, 4 xors (LOP3) and 4 rotates (SHF,
// __funnelshift_l), plus the feed-forward and the CW work, less the
// operations on the zero counter words, which fold: 595 instructions per
// expansion and 601 per leaf convert (ops/op_count.py).  A leaf convert
// writes 64 bytes, some 9 instructions per byte, against the H100's issue
// rate over its memory rate of about 5.  LOP3 and SHF share the integer ALU
// pipe; the adds issue as IMAD on the FMA pipe (the built SASS has an IADD3
// for every 20-odd IMAD; chip_smoke.py prints the counts), so the ALU pipe's
// 394-396 instructions per block set the bound.
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

// The most levels one launch runs: the whole-tree route's tail (nu <= 6);
// every other tail and every fused group runs at most 5.
constexpr int kMaxLevels = 6;
// The most levels a thread runs below its path (M = L - d); the rule keeps
// d >= L - kMaxDepthFirst.
constexpr int kMaxDepthFirst = 2;
// The rule's targets: the fewest threads a launch should have before it
// shortens the threads' depth-first part, for the tail and the fused levels.
constexpr long long kTailThreads = 1LL << 14, kFusedThreads = 1LL << 16;

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

// The rule for d, the levels each thread walks on its own path: M =
// kMaxDepthFirst levels below it where the launch has threads enough, else
// fewer, down to one (a thread's last level always stores both children).
__host__ __device__ inline int split_levels(long long nodes, int levels, bool leaf) {
  int d = levels > kMaxDepthFirst ? levels - kMaxDepthFirst : 0;
  const long long want = leaf ? kTailThreads : kFusedThreads;
  while (d < levels - 1 && (nodes << d) < want) ++d;
  return d;
}

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
  int split;  // d = split_levels(K * W, levels, LEAF)
};

namespace {

// The work of thread i of a launch split d = a.split ways: path i % 2^d of
// entry node i / 2^d, its d path levels, then its M = a.levels - d levels
// depth first.
template <bool LEAF, int M>
__host__ __device__ inline void expand_thread(const ExpandArgs& a, long long i) {
  const int d = a.split;
  const long long node = i >> d;
  const unsigned p = static_cast<unsigned>(i) & ((1u << d) - 1u);
  const long long k = node / a.W, w = node - k * a.W;
  const uint32_t* sp = a.st + k * a.st_key + w;
  uint32_t s[4], t = sp[4 * a.st_row];
#pragma unroll
  for (int q = 0; q < 4; ++q) s[q] = sp[q * a.st_row];
  const uint32_t* scw = a.scw + k * a.scw_key;
  const uint32_t* tcw = a.tcw + k * a.tcw_key;

  // The path: one expansion a level, keeping the child bit d - 1 - lev of p
  // names (MSB first, as the leaf order is).
#pragma unroll 1
  for (int lev = 0; lev < d; ++lev) {
    uint32_t l[4], r[4], tl, tr;
    level_step(s, t, scw + 4 * lev, tcw[2 * lev], tcw[2 * lev + 1], l, tl, r, tr);
    const bool right = (p >> (d - 1 - lev)) & 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = right ? r[q] : l[q];
    t = right ? tr : tl;
  }
  scw += 4 * d;
  tcw += 2 * d;

  // This thread's first output node, in ascending order within the key.
  const long long first = ((w << d) + p) << M;
  const uint32_t* fcw = LEAF ? a.fcw + k * a.fcw_key : nullptr;
  uint32_t* out = a.out + k * a.out_key + first * (LEAF ? 16 : 1);

  // The last M levels depth first; stk holds the right children still to
  // visit, and every index into it is a constant once the e loops unroll.
  uint32_t stk_s[M > 0 ? M : 1][4], stk_t[M > 0 ? M : 1];
  int depth = 0;
#pragma unroll 1
  for (unsigned j = 0; j < (1u << M); ++j) {
#pragma unroll 1
    for (; depth < M; ++depth) {  // descend left, keeping each right child
      uint32_t l[4], r[4], tl, tr;
      level_step(s, t, scw + 4 * depth, tcw[2 * depth], tcw[2 * depth + 1], l, tl,
                 r, tr);
#pragma unroll
      for (int e = 0; e < M; ++e) {
        if (e == depth) {
#pragma unroll
          for (int q = 0; q < 4; ++q) stk_s[e][q] = r[q];
          stk_t[e] = tr;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] = l[q];
      t = tl;
    }
    if (LEAF) {
      leaf_store(s, t, fcw, out + 16 * static_cast<size_t>(j));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q * a.out_row + j] = s[q];
      out[4 * a.out_row + j] = t;
    }
    if (j + 1 < (1u << M)) {
      // Node j's path bits, MSB first, are its left/right choices: back up
      // to the deepest left turn and take the right child kept there.
      depth = M - 1 - trailing_ones(j);
#pragma unroll
      for (int e = 0; e < M; ++e) {
        if (e == depth) {
#pragma unroll
          for (int q = 0; q < 4; ++q) s[q] = stk_s[e][q];
          t = stk_t[e];
        }
      }
      ++depth;
    }
  }
}

// Thread i of a launch: its body for M = a.levels - a.split.
template <bool LEAF>
__host__ __device__ inline void expand_split(const ExpandArgs& a, long long i) {
  switch (a.levels - a.split) {
    case 0: expand_thread<LEAF, 0>(a, i); break;
    case 1: expand_thread<LEAF, 1>(a, i); break;
    case 2: expand_thread<LEAF, 2>(a, i); break;
    default: break;  // split_levels keeps M <= kMaxDepthFirst
  }
}

// The launch's operands with its split: a.split from the rule.
__host__ __device__ inline ExpandArgs with_split(ExpandArgs a, bool leaf) {
  a.split = split_levels(a.K * a.W, a.levels, leaf);
  return a;
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kChachaThreads = 128;
// Blocks an SM the tail's launch bound asks room for: up to 85 registers a
// thread.  ptxas then schedules the rounds with more registers (71, 7 blocks
// an SM) than at its own choice (64, 8 blocks an SM), and config 2's tail
// runs faster; the fused levels run faster at ptxas's own choice
// (scripts/time_chacha_split.py times both builds).
constexpr int kChachaMinBlocks = 6;

extern "C" __global__ void __launch_bounds__(kChachaThreads, kChachaMinBlocks)
    expand_tail_kernel(const ExpandArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kChachaThreads + threadIdx.x;
  if (i < (a.K * a.W) << a.split) expand_split<true>(a, i);
}

extern "C" __global__ void __launch_bounds__(kChachaThreads)
    fused_levels_kernel(const ExpandArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kChachaThreads + threadIdx.x;
  if (i < (a.K * a.W) << a.split) expand_split<false>(a, i);
}

static int launch(bool leaf, const ExpandArgs& a, void* stream) {
  if (a.levels < 0 || a.levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (a.K * a.W) << a.split;
  const long long blocks = (n + kChachaThreads - 1) / kChachaThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto s = static_cast<cudaStream_t>(stream);
  if (leaf)
    expand_tail_kernel<<<static_cast<unsigned>(blocks), kChachaThreads, 0, s>>>(a);
  else
    fused_levels_kernel<<<static_cast<unsigned>(blocks), kChachaThreads, 0, s>>>(a);
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
                     static_cast<uint32_t*>(out), 0, out_key, 0};
  return launch(true, with_split(a, true), stream);
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
                     static_cast<uint32_t*>(out), out_row, out_key, 0};
  return launch(false, with_split(a, false), stream);
}

// The kernels' rule for d, for a launch over `nodes` = K * W entry nodes
// (leaf: the tail's, else the fused levels').
extern "C" int dpf_chacha_split(long long nodes, int levels, int leaf) {
  return split_levels(nodes, levels, leaf != 0);
}

extern "C" const char* dpf_chacha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
