// Fast-profile pointwise evaluation: the ChaCha12 root-to-leaf walk of one
// (query, key) pair per thread, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel dpf_tpu/ops/chacha_pallas.py::
// _walk_kernel in its two modes:
//   walk_kernel      dcf=False (wrapper _walk_raw): nu GGM level steps along
//                    the query's path, then the 512-bit leaf convert, the
//                    final CW under t, and the query's bit of the leaf.
//   walk_dcf_kernel  dcf=True (wrapper _walk_call_dcf): the DCF comparison
//                    share (models/dcf.py).  Each level's expansion also
//                    feeds forward word 8, the node's value word v; while the
//                    query descends left, acc ^= (v ^ (vcw[i] & t)) & 1 with
//                    t the PARENT's control bit.  The output is acc XOR the
//                    leaf bit (the final CW is then the DCF's FVCW).
//
// Operands (int32 carriers of uint32 words on the PyTorch side, contiguous,
// key-minor so that neighbouring threads read neighbouring words):
//   meta   [3, K]    rows: root t (0/1), key_level, lowmask
//   seeds  [4, K]    root seed words
//   scw    [4 nu, K] row 4 i + w: word w of level i's seed CW
//   tcw    [2 nu, K] rows 2 i, 2 i + 1: level i's (tLCW, tRCW), 0/1
//   fcw    [16, K]   final CW words (the DCF's FVCW)
//   xs_lo  [Q, K]    bits 0..31 of each query index
//   xs_hi  [Q, K]    bits 32..63 (read only when log_n > 32)
//   out    [Q, K]    the output bits, 0/1
//   vcw    [nu, K]   DCF only: row i is level i's value CW bit, 0/1
// key_level and lowmask carry the FSS level grouping (core/chacha_np.py::
// grouped_masks): level i's path bit counts only while key_level >= i, and
// the in-leaf index is ANDed with lowmask.  A plain batch, and every DCF
// batch, has key_level = log_n and lowmask = 511.
//
// Decomposition: thread i is query i / K of key i % K; a 1-D grid covers
// Q * K threads with a bounds check, so any Q and K run (no query tile, no
// 128-key quantum).  Each thread holds its 4 seed words, t and the DCF
// accumulator in registers and runs nu expansions and one leaf convert (the
// ChaCha12 block of chacha12.cuh); the descent bit of level i is bit
// log_n - 1 - i of the 64-bit index.  nu = 0 (log_n <= 9) runs the leaf
// convert alone.
//
// What bounds it: integer issue, as in chacha_expand.cu: nu expansions and
// one leaf convert per thread (ops/op_count.py::walk_chacha_ops,
// walk_dcf_ops) against 8 + 6 nu + 16 words of traffic (7 nu for the DCF).
//
// The per-thread walk compiles as host C++ too (define __host__, __device__
// empty and __forceinline__ as inline): tests/port/test_torch_kernel_host.py.

#include <cstddef>
#include <cstdint>

#include "chacha12.cuh"

// One launch's operands (a kernel parameter, so at namespace scope).  vcw
// comes last, so the fields walk_kernel reads keep their offsets.
struct ChachaWalkArgs {
  const uint32_t* meta;
  const uint32_t* seeds;
  const uint32_t* scw;
  const uint32_t* tcw;
  const uint32_t* fcw;
  const uint32_t* xs_lo;
  const uint32_t* xs_hi;
  uint32_t* out;
  long long Q, K;
  int log_n, nu;
  const uint32_t* vcw;
};

namespace {

// The walk of thread i: query i / K of key i % K.  kDcf: the DCF share.
template <bool kDcf>
__host__ __device__ inline void walk_lane(const ChachaWalkArgs& a, long long i) {
  const size_t K = static_cast<size_t>(a.K);
  const size_t k = static_cast<size_t>(i) % K;
  uint32_t t = a.meta[k];
  const uint32_t key_level = a.meta[K + k], lowmask = a.meta[2 * K + k];
  const uint32_t lo = a.xs_lo[i];
  const uint32_t hi = a.log_n > 32 ? a.xs_hi[i] : 0u;
  uint32_t s[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) s[w] = a.seeds[w * K + k];
  uint32_t acc = 0;
#pragma unroll 1
  for (int lv = 0; lv < a.nu; ++lv) {
    uint32_t cw[4], l[4], r[4], tl, tr, v = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) cw[w] = a.scw[(4 * lv + w) * K + k];
    const uint32_t tlcw = a.tcw[2 * lv * K + k], trcw = a.tcw[(2 * lv + 1) * K + k];
    if constexpr (kDcf)
      level_step_v(s, t, cw, tlcw, trcw, l, tl, r, tr, v);
    else
      level_step(s, t, cw, tlcw, trcw, l, tl, r, tr);
    const int bu = a.log_n - 1 - lv;  // the descent bit, MSB first
    uint32_t pbit = (bu >= 32 ? hi >> (bu - 32) : lo >> bu) & 1u;
    pbit &= key_level >= static_cast<uint32_t>(lv) ? 1u : 0u;
    if constexpr (kDcf)  // t is still the parent's
      acc ^= (v ^ (a.vcw[lv * K + k] & t)) & 1u & (1u - pbit);
#pragma unroll
    for (int w = 0; w < 4; ++w) s[w] = pbit ? r[w] : l[w];
    t = pbit ? tr : tl;
  }
  uint32_t o[16];
  chacha12<16>(s, CC_DS_LEAF, o);
  const uint32_t low = lo & 511u & lowmask;
  const uint32_t widx = (low >> 5) & 15u;
  uint32_t word = 0;
#pragma unroll
  for (int w = 0; w < 16; ++w)
    if (widx == static_cast<uint32_t>(w)) word = o[w] ^ (a.fcw[w * K + k] & (0u - t));
  a.out[i] = acc ^ ((word >> (low & 31u)) & 1u);
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kChachaWalkThreads = 128;

extern "C" __global__ void __launch_bounds__(kChachaWalkThreads)
    walk_kernel(const ChachaWalkArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kChachaWalkThreads + threadIdx.x;
  if (i < a.Q * a.K) walk_lane<false>(a, i);
}

extern "C" __global__ void __launch_bounds__(kChachaWalkThreads)
    walk_dcf_kernel(const ChachaWalkArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kChachaWalkThreads + threadIdx.x;
  if (i < a.Q * a.K) walk_lane<true>(a, i);
}

namespace {

// Launch `kernel` over a's Q * K lanes on `stream`; return its error.
int launch_walk(void (*kernel)(ChachaWalkArgs), const ChachaWalkArgs& a,
                void* stream) {
  const long long blocks = (a.Q * a.K + kChachaWalkThreads - 1) / kChachaWalkThreads;
  if (a.Q < 1 || a.K < 1 || a.nu < 0 || a.log_n < 1 || a.log_n > 64 ||
      blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kChachaWalkThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ChachaWalkArgs walk_args(const void* meta, const void* seeds, const void* scw,
                         const void* tcw, const void* fcw, const void* xs_lo,
                         const void* xs_hi, void* out, long long Q, long long K,
                         int log_n, int nu, const void* vcw) {
  return ChachaWalkArgs{static_cast<const uint32_t*>(meta),
                        static_cast<const uint32_t*>(seeds),
                        static_cast<const uint32_t*>(scw),
                        static_cast<const uint32_t*>(tcw),
                        static_cast<const uint32_t*>(fcw),
                        static_cast<const uint32_t*>(xs_lo),
                        static_cast<const uint32_t*>(xs_hi),
                        static_cast<uint32_t*>(out), Q, K, log_n, nu,
                        static_cast<const uint32_t*>(vcw)};
}

}  // namespace

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_chacha_walk(const void* meta, const void* seeds, const void* scw,
                               const void* tcw, const void* fcw, const void* xs_lo,
                               const void* xs_hi, void* out, long long Q, long long K,
                               int log_n, int nu, void* stream) {
  return launch_walk(walk_kernel, walk_args(meta, seeds, scw, tcw, fcw, xs_lo, xs_hi,
                                            out, Q, K, log_n, nu, nullptr),
                     stream);
}

extern "C" int dpf_chacha_walk_dcf(const void* meta, const void* seeds,
                                   const void* scw, const void* tcw, const void* vcw,
                                   const void* fcw, const void* xs_lo,
                                   const void* xs_hi, void* out, long long Q,
                                   long long K, int log_n, int nu, void* stream) {
  return launch_walk(walk_dcf_kernel, walk_args(meta, seeds, scw, tcw, fcw, xs_lo,
                                                xs_hi, out, Q, K, log_n, nu, vcw),
                     stream);
}

extern "C" const char* dpf_chacha_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
