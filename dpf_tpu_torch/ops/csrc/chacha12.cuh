// ChaCha12 for the fast profile, per thread: the block function with the
// fast-profile state layout and one GGM level step of one node.  Shared by
// chacha_expand.cu (the expansion kernels) and chacha_walk.cu (the pointwise
// walk; the DCF walk's node also takes word 8).
//
// Compiles as host C++ too (define __host__, __device__ empty and
// __forceinline__ as inline): tests/port/test_torch_kernel_host.py.
#pragma once

#include <cstdint>

namespace {

#define CC_DS_EXPAND 0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au
#define CC_DS_LEAF 0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u

__host__ __device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

__host__ __device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b,
                                                 uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// ChaCha12 on the fast-profile state (constants | seed | domain words | 0),
// RFC 8439 feed-forward on the first N_OUT words.
template <int N_OUT>
__host__ __device__ __forceinline__ void chacha12(
    const uint32_t s[4], uint32_t d0, uint32_t d1, uint32_t d2, uint32_t d3,
    uint32_t out[N_OUT]) {
  const uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                             s[0], s[1], s[2], s[3], d0, d1, d2, d3,
                             0u, 0u, 0u, 0u};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < N_OUT; ++i) out[i] = x[i] + init[i];
}

// One GGM level of one node (models/dpf_chacha.py::_level_step_cc): expand,
// take the children's control bits from bit 0 of word 0 and clear them, then
// XOR the seed CW and the t CWs in under the parent's t.  The expansion feeds
// forward N_OUT >= 8 words, all left in o.
template <int N_OUT>
__host__ __device__ __forceinline__ void level_step_words(
    const uint32_t s[4], uint32_t t, const uint32_t* scw, uint32_t tlcw,
    uint32_t trcw, uint32_t l[4], uint32_t& tl, uint32_t r[4], uint32_t& tr,
    uint32_t o[N_OUT]) {
  chacha12<N_OUT>(s, CC_DS_EXPAND, o);
  tl = o[0] & 1u;
  tr = o[4] & 1u;
  o[0] &= ~1u;
  o[4] &= ~1u;
  const uint32_t msk = 0u - t;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    l[w] = o[w] ^ (scw[w] & msk);
    r[w] = o[4 + w] ^ (scw[w] & msk);
  }
  tl ^= tlcw & t;
  tr ^= trcw & t;
}

__host__ __device__ __forceinline__ void level_step(
    const uint32_t s[4], uint32_t t, const uint32_t* scw, uint32_t tlcw,
    uint32_t trcw, uint32_t l[4], uint32_t& tl, uint32_t r[4], uint32_t& tr) {
  uint32_t o[8];
  level_step_words<8>(s, t, scw, tlcw, trcw, l, tl, r, tr, o);
}

// The DCF node (models/dcf.py): the same level step, whose expansion also
// feeds forward word 8, the node's value word v (chacha_np.prg_expand_v).
__host__ __device__ __forceinline__ void level_step_v(
    const uint32_t s[4], uint32_t t, const uint32_t* scw, uint32_t tlcw,
    uint32_t trcw, uint32_t l[4], uint32_t& tl, uint32_t r[4], uint32_t& tr,
    uint32_t& v) {
  uint32_t o[9];
  level_step_words<9>(s, t, scw, tlcw, trcw, l, tl, r, tr, o);
  v = o[8];
}

}  // namespace
