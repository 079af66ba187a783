// Fixed-key AES-128-MMO on bit-major planes: the compat profile's DPF PRG and
// leaf convert, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels:
//   prg_bm_kernel        dpf_tpu/ops/aes_pallas.py::_prg_kernel_bm
//                        (wrapper prg_planes_pallas_bm): L = AES_kL(S) ^ S,
//                        R = AES_kR(S) ^ S, bit-major in and out.
//   mmo_bm_canon_kernel  dpf_tpu/ops/aes_pallas.py::_mmo_canon_kernel_bm
//                        (wrapper mmo_planes_pallas_bm_canon): AES_kL(S) ^ S,
//                        bit-major in, canonical plane order out.
//
// Layout: uint32[128, B] (int32 carriers on the PyTorch side), plane-major and
// contiguous.  Word S[p * B + j] holds plane p of the 32 blocks packed in
// column word j.  Bit-major plane order is p' = 16 * bit + byte; canonical is
// p = 8 * byte + bit.  Any B >= 1 is taken; the grid covers B with a bounds
// check, so the root levels (B = 32 at 1024 keys) run here too.
//
// What bounds it on this card: logic-instruction issue, not memory.  One
// AES-128-MMO on a column word (32 blocks) is 22,992 two-input gates with the
// cheapest circuits at hand (Boyar-Peralta S-box, MixColumns through the
// column XOR), which a cover by three-input LOP3 instructions brings to 16,236
// (ops/op_count.py counts both; NOTs and the constant round-key masks fold
// into LOP3 for free).  A PRG column does two MMOs, 32,094 LOP3 (the first
// S-box layer is shared), against 1.5 KB of traffic (512 B in, 1 KB out):
// some 21 instructions per byte, where the H100's issue rate over its memory
// rate (132 SMs x 64 per clock x ~1.98 GHz over 3.35 TB/s) is about 5.
//
// What the design does about that: it spends no instruction on data movement
// inside the cipher.  One thread owns one column word and keeps its 128-word
// state in registers for the whole cipher; ShiftRows, MixColumns' byte
// rotation and the bit-major plane order are compile-time register renaming;
// the S-box is the straight-line generated circuit; AddRoundKey XORs
// constant-bank masks.  Global loads and stores coalesce (neighbouring threads
// own neighbouring column words).  The PRG writes L, then re-reads S (L1/L2
// hot) for R instead of holding a second 128-word state, and the round loop
// is not unrolled, which keeps the code small.  MixColumns is the direct
// five-term wiring of each output bit, not the cheaper form the count uses.
//
// The per-column functions compile as host C++ too (define __host__,
// __device__, __constant__ empty and __forceinline__ as inline), which is how
// tests/port/test_torch_kernel_host.py checks this file's arithmetic without a GPU.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

namespace {

// MMO of column word j: O[:, j] = AES_key(S[:, j]) ^ S[:, j].  With
// kCanonOut the output rows are in canonical order: canonical row
// p = 8 * byte + bit is bit-major row 16 * bit + byte (_FROM_BM).  S is
// re-read for the final XOR; it carries no __restrict__, so the compiler
// cannot forward the first loads and keep a second 128-word copy live.
template <bool kCanonOut>
__host__ __device__ __forceinline__ void mmo_column(const uint32_t* S,
                                                    uint32_t* O, size_t B,
                                                    size_t j, int key) {
  uint32_t s[128];
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = S[p * B + j];
  aes128_encrypt_bm(s, key);
#pragma unroll
  for (int p = 0; p < 128; ++p) {
    const int q = kCanonOut ? 16 * (p & 7) + (p >> 3) : p;
    O[p * B + j] = s[q] ^ S[q * B + j];
  }
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kThreads = 128;

extern "C" __global__ void __launch_bounds__(kThreads)
    prg_bm_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  const size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= static_cast<size_t>(B)) return;
#pragma unroll 1
  for (int key = 0; key < 2; ++key) mmo_column<false>(S, key ? R : L, B, j, key);
}

extern "C" __global__ void __launch_bounds__(kThreads)
    mmo_bm_canon_kernel(const uint32_t* S, uint32_t* O, long long B) {
  const size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= static_cast<size_t>(B)) return;
  mmo_column<true>(S, O, B, j, 0);
}

static unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_prg_bm(const void* S, void* L, void* R, long long B,
                          void* stream) {
  prg_bm_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(L),
      static_cast<uint32_t*>(R), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_mmo_bm_canon(const void* S, void* O, long long B,
                                void* stream) {
  mmo_bm_canon_kernel<<<blocks_for(B), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(O), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
