// Fixed-key AES-128 on one column word's bit-major planes: the per-column
// cipher shared by the compat profile's kernels (aes_mmo.cu: the PRG and the
// leaf convert in both plane orders; aes_fused.cu: the level-fused
// expansion; aes_walk.cu: the pointwise walk).
//
// A column word's state is uint32_t s[128]: plane p' = 16 * bit + byte of the
// 32 blocks packed in the word (bit-major order; canonical is 8 * byte + bit).
// ShiftRows, MixColumns' byte rotation and the plane order are compile-time
// register renaming.
//
// The cipher (folded_load, folded_rounds, mmo_column_folded) runs the LOP3
// instructions of ops/op_count.py's cover: MixColumns goes through the
// column XOR, and each round key is moved to the S-box outputs (RK_SBOX,
// which a kernel copies into shared memory with copy_rk_sbox), where the
// cover takes it as an input of the output instructions (5 LOP3 more a byte
// than the S-box alone).  The key is a run-time pointer, so one copy of the
// round code serves both keys.
//
// Compiles as host C++ too (define __host__, __device__, __constant__ empty
// and __forceinline__ as inline): tests/port/test_torch_kernel_host.py.
#pragma once

#include <cstddef>
#include <cstdint>

#include "sbox_bp113.cuh"

namespace {

// Bit-major plane index of (bit, byte).
__host__ __device__ constexpr int pl(int bit, int byte) { return 16 * bit + byte; }

// State bytes are column-major (byte 4c + r is row r of column c); row r
// rotates left by r: out byte 4c + r = in byte 4((c + r) % 4) + r.
__host__ __device__ __forceinline__ void shift_rows_bm(uint32_t s[128]) {
  uint32_t t[128];
#pragma unroll
  for (int bit = 0; bit < 8; ++bit)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        t[pl(bit, 4 * c + r)] = s[pl(bit, 4 * ((c + r) & 3) + r)];
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = t[p];
}

// MixColumns in the form ops/op_count.py counts (out_r = a_r ^ t ^
// xtime(a_r ^ a_{r+1}), t the XOR of the column's four bytes), as the
// generated LOP3 instructions of its cover, a column at a time.
__host__ __device__ __forceinline__ void mix_columns_cover(uint32_t s[128]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[32], o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = s[pl(i & 7, 4 * c + (i >> 3))];
    mix_column_lop3(a, o);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[pl(i & 7, 4 * c + (i >> 3))] = o[i];
  }
}

// SubBytes with the round's masks (RK_SBOX[key][rnd], canonical order
// 8 * byte + bit) XORed into the S-box outputs, as the generated LOP3
// instructions of the cover of sbox_bp113 with masked outputs (90 a byte,
// against 85 without the masks).
__host__ __device__ __forceinline__ void sub_bytes_masked(uint32_t s[128],
                                                          const uint32_t* mk) {
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    uint32_t x[8], m[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // circuit is MSB-first
      x[i] = s[pl(7 - i, b)];
      m[i] = mk[8 * b + 7 - i];
    }
    sbox_bp113_masked(x, m, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[pl(7 - i, b)] = y[i];
  }
}

// Source row of bit-major register q (16 * bit + byte): itself, or with
// kCanon the canonical row 8 * byte + bit (_TO_BM).
template <bool kCanon>
__host__ __device__ constexpr int row_of(int q) {
  return kCanon ? 8 * (q & 15) + (q >> 4) : q;
}

// x, as a value the compiler cannot see through.  After a long loop, the
// addresses (and values) of the loads before it would otherwise be kept
// live across it, in spilled registers, rather than computed anew.
__host__ __device__ __forceinline__ size_t opaque(size_t x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(x));
#endif
  return x;
}

// Words of RK_SBOX, both keys: the kernels' shared-memory copy; key `key`'s
// eleven rounds start at rk + key * kRkWords / 2.
constexpr int kRkWords = 2 * 11 * 128;

// Thread `thread` of `threads` copies its share of the first `words` words
// of RK_SBOX into rk (the block's shared copy: both keys, or with
// kRkWords / 2 key L alone; a barrier follows before any thread reads it).
__host__ __device__ __forceinline__ void copy_rk_sbox(uint32_t* rk, int thread, int threads,
                                                      int words = kRkWords) {
  for (int i = thread; i < words; i += threads) rk[i] = (&RK_SBOX[0][0][0])[i];
}

// The folded cipher's input: row row_of<kCanon>(q) of column word j of S
// (plane-major, B words a plane) into register q, with round 0's key (rk,
// one key's RK_SBOX[key]) XORed in.  Byte by byte: the first S-box waits for
// 8 rows, not 128.
template <bool kCanon>
__host__ __device__ __forceinline__ void folded_load(uint32_t s[128], const uint32_t* S,
                                                     size_t B, size_t j,
                                                     const uint32_t* rk) {
#pragma unroll
  for (int b = 0; b < 16; ++b)
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const int q = pl(bit, b);
      s[q] = S[row_of<kCanon>(q) * B + j] ^ rk[row_of<true>(q)];
    }
}

// Rounds 1-10 of the folded cipher on the state folded_load gave, with the
// key whose S-box-output masks are rk[11][128].  One round per turn of a
// loop that is not unrolled, so the code is one round's and the key a
// run-time value; MixColumns through the column XOR.
__host__ __device__ __forceinline__ void folded_rounds(uint32_t s[128],
                                                       const uint32_t* rk) {
#pragma unroll 1
  for (int rnd = 1; rnd <= 10; ++rnd) {
    sub_bytes_masked(s, rk + 128 * rnd);
    shift_rows_bm(s);
    if (rnd < 10) mix_columns_cover(s);
  }
}

// MMO of column word j, in and out in one plane order (canonical with
// kCanon: register q is row row_of(q)): O = AES(S) ^ S with the key whose
// S-box-output masks are rk[11][128] (RK_SBOX[key]).  S is re-read for the
// final XOR rather than held.
template <bool kCanon>
__host__ __device__ __forceinline__ void mmo_column_folded(const uint32_t* S,
                                                           uint32_t* O, size_t B,
                                                           size_t j,
                                                           const uint32_t* rk) {
  uint32_t s[128];
  folded_load<kCanon>(s, S, B, j, rk);
  folded_rounds(s, rk);
  j = opaque(j);
#pragma unroll
  for (int q = 0; q < 128; ++q) {
    const size_t i = row_of<kCanon>(q) * B + j;
    O[i] = s[q] ^ S[i];
  }
}

}  // namespace
