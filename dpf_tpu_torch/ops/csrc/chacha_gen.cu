// The fast-profile and DCF dealer: the whole correction-word tower of one key
// per thread, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It stands for the JAX package's XLA body
// dpf_tpu/models/keys_gen.py::_gen_cc_body (:171) and its level step
// _level_gen_cc (:128-168), which the JAX package runs outside Pallas.  Run
// eagerly in PyTorch, that body is some 2,000 small launches a level (two
// parties' ChaCha12 expansions on [K] lanes, then the CW selects), and the DCF
// at n=32 has 23 levels of it.
//
//   gen_tower_cc_kernel<false>  the fast profile's tower (keys_chacha.gen_batch)
//   gen_tower_cc_kernel<true>   the DCF tower (dcf.gen_lt_batch): each level's
//                               expansion also feeds forward word 8, the value
//                               word v, and the level publishes its value CW
//
// Operands (int32 carriers of uint32 words on the PyTorch side, contiguous):
//   s0, s1  [K, 4]      both parties' root seeds (bit 0 of word 0 cleared)
//   t0, t1  [K]         their root control bits, 0/1
//   bits    [nu, K]     alpha's path bit at each level, MSB first, 0/1
//   scw     [nu, K, 4]  out: each level's seed CW (the LOSE child's XOR)
//   tl, tr  [nu, K]     out: each level's tLCW and tRCW, 0/1
//   fcw     [K, 16]     out: convert(s0) ^ convert(s1) of the parties' leaves
//   vcw     [nu, K]     out, DCF only: (v0 ^ v1 ^ bit) & 1
// These are the JAX body's inputs and outputs; the host marshals them into
// key batches (models/keys_gen.py).
//
// Decomposition: thread k deals key k.  Its two parties' seeds and control
// bits stay in registers across the whole tower: per level two expansions,
// the LOSE side's CWs by mask arithmetic on the secret path bit (msk = 0 -
// bit: no branch and no secret index), then the KEEP child of each party with
// the CW XORed in under its parent's t; after nu levels both leaf converts.
// A 1-D grid covers K threads with a bounds check, so any K runs.
//
// What bounds it: integer issue.  A key costs 2 nu + 2 ChaCha12 blocks
// (ops/op_count.py::gen_tower_ops) against 40 + (24 or 28) nu bytes of
// traffic.  The levels are a serial chain, so a small batch (a few hundred
// warps) cannot fill the card; a batch is the unit of parallelism.
//
// The per-thread tower compiles as host C++ too (define __host__, __device__
// empty and __forceinline__ as inline): tests/port/test_torch_kernel_host.py.

#include <cstddef>
#include <cstdint>

#include "chacha12.cuh"

// One launch's operands (a kernel parameter, so at namespace scope).
struct ChachaGenArgs {
  const uint32_t* s0;
  const uint32_t* s1;
  const uint32_t* t0;
  const uint32_t* t1;
  const uint32_t* bits;
  uint32_t* scw;
  uint32_t* tl;
  uint32_t* tr;
  uint32_t* fcw;
  uint32_t* vcw;  // DCF only
  long long K;
  int nu;
};

namespace {

// The tower of key k.  kDcf: the DCF tower (value CWs).
template <bool kDcf>
__host__ __device__ inline void gen_lane(const ChachaGenArgs& a, long long kk) {
  constexpr int kOut = kDcf ? 9 : 8;
  const size_t K = static_cast<size_t>(a.K);
  const size_t k = static_cast<size_t>(kk);
  uint32_t s0[4], s1[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    s0[w] = a.s0[4 * k + w];
    s1[w] = a.s1[4 * k + w];
  }
  uint32_t t0 = a.t0[k], t1 = a.t1[k];
#pragma unroll 1
  for (int lv = 0; lv < a.nu; ++lv) {
    const size_t at = static_cast<size_t>(lv) * K + k;
    uint32_t o0[kOut], o1[kOut];
    chacha12<kOut>(s0, CC_DS_EXPAND, o0);
    chacha12<kOut>(s1, CC_DS_EXPAND, o1);
    const uint32_t bit = a.bits[at];
    const uint32_t t0l = o0[0] & 1u, t0r = o0[4] & 1u;
    const uint32_t t1l = o1[0] & 1u, t1r = o1[4] & 1u;
    o0[0] &= ~1u;
    o0[4] &= ~1u;
    o1[0] &= ~1u;
    o1[4] &= ~1u;
    const uint32_t msk = 0u - bit;  // all ones where alpha descends right
    const uint32_t tlcw = t0l ^ t1l ^ bit ^ 1u, trcw = t0r ^ t1r ^ bit;
    const uint32_t ktcw = (trcw & msk) | (tlcw & ~msk);
    const uint32_t tm0 = 0u - t0, tm1 = 0u - t1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // LOSE child = the one alpha does NOT descend into.
      const uint32_t scw = ((o0[w] ^ o1[w]) & msk) | ((o0[4 + w] ^ o1[4 + w]) & ~msk);
      a.scw[4 * at + w] = scw;
      s0[w] = ((o0[4 + w] & msk) | (o0[w] & ~msk)) ^ (scw & tm0);
      s1[w] = ((o1[4 + w] & msk) | (o1[w] & ~msk)) ^ (scw & tm1);
    }
    a.tl[at] = tlcw;
    a.tr[at] = trcw;
    if constexpr (kDcf) a.vcw[at] = (o0[8] ^ o1[8] ^ bit) & 1u;
    t0 = ((t0r & msk) | (t0l & ~msk)) ^ (t0 & ktcw);
    t1 = ((t1r & msk) | (t1l & ~msk)) ^ (t1 & ktcw);
  }
  uint32_t c0[16], c1[16];
  chacha12<16>(s0, CC_DS_LEAF, c0);
  chacha12<16>(s1, CC_DS_LEAF, c1);
#pragma unroll
  for (int j = 0; j < 16; ++j) a.fcw[16 * k + j] = c0[j] ^ c1[j];
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kChachaGenThreads = 128;

template <bool kDcf>
__global__ void __launch_bounds__(kChachaGenThreads)
    gen_tower_cc_kernel(const ChachaGenArgs a) {
  const long long k =
      static_cast<long long>(blockIdx.x) * kChachaGenThreads + threadIdx.x;
  if (k < a.K) gen_lane<kDcf>(a, k);
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_chacha_gen(const void* s0, const void* s1, const void* t0,
                              const void* t1, const void* bits, void* scw, void* tl,
                              void* tr, void* fcw, void* vcw, long long K, int nu,
                              int dcf, void* stream) {
  const long long blocks = (K + kChachaGenThreads - 1) / kChachaGenThreads;
  if (K < 1 || nu < 0 || blocks > 0x7FFFFFFFLL || (dcf && nu && vcw == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChachaGenArgs a{static_cast<const uint32_t*>(s0), static_cast<const uint32_t*>(s1),
                        static_cast<const uint32_t*>(t0), static_cast<const uint32_t*>(t1),
                        static_cast<const uint32_t*>(bits), static_cast<uint32_t*>(scw),
                        static_cast<uint32_t*>(tl), static_cast<uint32_t*>(tr),
                        static_cast<uint32_t*>(fcw), static_cast<uint32_t*>(vcw), K, nu};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dcf)
    gen_tower_cc_kernel<true><<<static_cast<unsigned>(blocks), kChachaGenThreads, 0, st>>>(a);
  else
    gen_tower_cc_kernel<false><<<static_cast<unsigned>(blocks), kChachaGenThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_chacha_gen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
