// Fixed-key AES-128-MMO on bitsliced planes: the compat profile's DPF PRG and
// leaf convert, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels:
//   prg_bm_kernel        dpf_tpu/ops/aes_pallas.py::_prg_kernel_bm
//                        (wrapper prg_planes_pallas_bm): L = AES_kL(S) ^ S,
//                        R = AES_kR(S) ^ S, bit-major in and out.
//   mmo_bm_canon_kernel  dpf_tpu/ops/aes_pallas.py::_mmo_canon_kernel_bm
//                        (wrapper mmo_planes_pallas_bm_canon): AES_kL(S) ^ S,
//                        bit-major in, canonical plane order out.
//   prg_canon_kernel     dpf_tpu/ops/aes_pallas.py::_prg_kernel (wrapper
//                        prg_planes_pallas): the PRG, canonical in and out.
//   mmo_canon_kernel     dpf_tpu/ops/aes_pallas.py::_mmo_kernel (wrapper
//                        mmo_planes_pallas): the leaf MMO (key L), canonical
//                        in and out.
//   prg_bm_il_kernel     dpf_tpu/ops/aes_pallas.py::_prg_kernel_bm_il
//                        (wrapper prg_planes_pallas_bm_il): prg_bm_kernel's
//                        function with both encryptions advancing together.
//
// Layout: uint32[128, B] (int32 carriers on the PyTorch side), plane-major and
// contiguous.  Word S[p * B + j] holds plane p of the 32 blocks packed in
// column word j.  Bit-major plane order is p' = 16 * bit + byte; canonical is
// p = 8 * byte + bit.  The cipher always runs on bit-major registers: a
// canonical kernel loads canonical row 8 * byte + bit into register
// 16 * bit + byte and stores it back the same way, which is compile-time
// register renaming, so the canonical kernels execute the bit-major ones'
// instructions.  Any B >= 1 is taken; the grid covers B with a bounds check,
// so the root levels (B = 32 at 1024 keys) run here too.
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
// rotation and the plane orders are compile-time register renaming; the
// S-box is the straight-line generated circuit.  Global loads and stores
// coalesce (neighbouring threads own neighbouring column words).  An MMO
// writes its output, re-reading S (L1/L2 hot) for the final XOR instead of
// holding a second 128-word state.
//
// The two PRG kernels (prg_bm_kernel, prg_canon_kernel) run one MMO a
// thread, in two warps of one block over the same 32 column words (warp
// 2 w + key encrypts with `key`): a warp's second reader of each line finds
// it in L1, and one copy of the round code serves both keys, the key a
// run-time value uniform across each warp.  Their cipher is aes_bm.cuh's
// mmo_column_folded, which runs the LOP3 instructions of ops/op_count.py's
// cover (generated into sbox_bp113.cuh): MixColumns through the column XOR,
// and each round key moved to the S-box outputs, where the cover takes it as
// an input of the output instructions (90 LOP3 a byte against 85; 1,741 a
// round).  The block copies those masks (RK_SBOX, both keys, 11 KB) into
// shared memory once; a warp's lanes read the same words (a broadcast), 32
// LDS.128 a round, with no constant-bank load.  The round loop is not
// unrolled: one round's code (~30 KB) stays in the instruction cache, and
// the compiler keeps the state in 255 registers (two blocks of 128 threads
// an SM) with no spill.  The loads go byte by byte, so the first S-box waits
// for 8 rows, not 128.  What was measured against (PERF.md, PR 8): ten
// unrolled rounds with constant masks (a template key) spill and overrun the
// instruction cache; a copy of the code per key, or the key in blockIdx
// (each warp then reads S from L2 or DRAM alone), is slower.
//
// The leaf MMO kernels (mmo_bm_canon_kernel, mmo_canon_kernel) run the round
// loop of aes128_encrypt_bm, not unrolled, with AddRoundKey XORing
// constant-bank masks and MixColumns as the direct five-term wiring of each
// output bit.
//
// The interleaved PRG maps its threads as the PRG kernels do and runs
// aes128_encrypt_bm with constant-bank masks: the key is uniform across
// each warp, so the round-key loads never diverge, and each warp's loads and
// stores are whole 128-byte lines.
//
// The per-column functions compile as host C++ too (define __host__,
// __device__, __constant__ empty and __forceinline__ as inline), which is how
// tests/port/test_torch_kernel_host.py checks this file's arithmetic without a GPU.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

namespace {

// MMO of column word j: O[:, j] = AES_key(S[:, j]) ^ S[:, j].  With kCanonIn
// the input rows are in canonical order, with kCanonOut the output rows:
// output row p holds register 16 * (p & 7) + (p >> 3) (_FROM_BM).  S is
// re-read for the final XOR; it carries no __restrict__, so the compiler
// cannot forward the first loads and keep a second 128-word copy live.
template <bool kCanonOut, bool kCanonIn = false>
__host__ __device__ __forceinline__ void mmo_column(const uint32_t* S,
                                                    uint32_t* O, size_t B,
                                                    size_t j, int key) {
  uint32_t s[128];
#pragma unroll
  for (int q = 0; q < 128; ++q) s[q] = S[row_of<kCanonIn>(q) * B + j];
  aes128_encrypt_bm(s, key);
#pragma unroll
  for (int p = 0; p < 128; ++p) {
    const int q = kCanonOut ? 16 * (p & 7) + (p >> 3) : p;
    O[p * B + j] = s[q] ^ S[row_of<kCanonIn>(q) * B + j];
  }
}

constexpr int kThreads = 128;

// Thread `thread` of block `block` of prg_bm_il_kernel: the block is
// kThreads / 64 pairs of warps, and warp 2 w + key runs `key` on the 32
// column words of pair w.
__host__ __device__ __forceinline__ void prg_il_thread(const uint32_t* S,
                                                       uint32_t* L, uint32_t* R,
                                                       size_t B, size_t block,
                                                       int thread) {
  const int warp = thread >> 5, key = warp & 1;
  const size_t j = block * (kThreads / 2) + 32 * (warp >> 1) + (thread & 31);
  if (j < B) mmo_column<false>(S, key ? R : L, B, j, key);
}

// Words of RK_SBOX, both keys: the PRG kernels' shared-memory copy.
constexpr int kRkWords = 2 * 11 * 128;

// Thread `thread` of block `block` of prg_bm_kernel (prg_canon_kernel with
// kCanon): the block is kThreads / 64 pairs of warps, and warp 2 w + key
// runs key `key` on the 32 column words of pair w, with rk the block's copy
// of RK_SBOX.
template <bool kCanon>
__host__ __device__ __forceinline__ void prg_thread(const uint32_t* S, uint32_t* L,
                                                    uint32_t* R, size_t B, size_t block,
                                                    int thread, const uint32_t* rk) {
  const int warp = thread >> 5, key = warp & 1;
  const size_t j = block * (kThreads / 2) + 32 * (warp >> 1) + (thread & 31);
  if (j < B) mmo_column_folded<kCanon>(S, key ? R : L, B, j, rk + key * (kRkWords / 2));
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The PRG kernels: RK_SBOX into shared memory, where every lane of a warp
// reads the same mask (a broadcast), then one MMO a thread.
template <bool kCanon>
__device__ __forceinline__ void prg_block(const uint32_t* S, uint32_t* L, uint32_t* R,
                                          long long B) {
  __shared__ __align__(16) uint32_t rk[kRkWords];
  for (int i = threadIdx.x; i < kRkWords; i += kThreads) rk[i] = (&RK_SBOX[0][0][0])[i];
  __syncthreads();
  prg_thread<kCanon>(S, L, R, B, blockIdx.x, threadIdx.x, rk);
}

extern "C" __global__ void __launch_bounds__(kThreads, 2)
    prg_bm_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_block<false>(S, L, R, B);
}

extern "C" __global__ void __launch_bounds__(kThreads)
    mmo_bm_canon_kernel(const uint32_t* S, uint32_t* O, long long B) {
  const size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= static_cast<size_t>(B)) return;
  mmo_column<true>(S, O, B, j, 0);
}

extern "C" __global__ void __launch_bounds__(kThreads, 2)
    prg_canon_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_block<true>(S, L, R, B);
}

extern "C" __global__ void __launch_bounds__(kThreads)
    mmo_canon_kernel(const uint32_t* S, uint32_t* O, long long B) {
  const size_t j = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= static_cast<size_t>(B)) return;
  mmo_column<true, true>(S, O, B, j, 0);
}

extern "C" __global__ void __launch_bounds__(kThreads)
    prg_bm_il_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_il_thread(S, L, R, B, blockIdx.x, threadIdx.x);
}

static unsigned blocks_for(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

// The two-key kernels' grid: a block per 64 column words, a pair of warps
// for each 32 of them.
static unsigned pair_blocks(long long B) {
  return static_cast<unsigned>((B + kThreads / 2 - 1) / (kThreads / 2));
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_prg_bm(const void* S, void* L, void* R, long long B,
                          void* stream) {
  prg_bm_kernel<<<pair_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int dpf_prg_canon(const void* S, void* L, void* R, long long B,
                             void* stream) {
  prg_canon_kernel<<<pair_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(L),
      static_cast<uint32_t*>(R), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_mmo_canon(const void* S, void* O, long long B, void* stream) {
  mmo_canon_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(O), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_prg_bm_il(const void* S, void* L, void* R, long long B,
                             void* stream) {
  prg_bm_il_kernel<<<pair_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(L),
      static_cast<uint32_t*>(R), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
