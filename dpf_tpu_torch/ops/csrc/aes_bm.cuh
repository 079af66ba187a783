// Fixed-key AES-128 on one column word's bit-major planes: the per-column
// cipher shared by the compat profile's kernels (aes_mmo.cu: the PRG and the
// leaf convert in both plane orders; aes_fused.cu: the level-fused
// expansion; aes_walk.cu: the pointwise walk).
//
// A column word's state is uint32_t s[128]: plane p' = 16 * bit + byte of the
// 32 blocks packed in the word (bit-major order; canonical is 8 * byte + bit).
// ShiftRows, MixColumns' byte rotation and the plane order are compile-time
// register renaming, the S-box is the generated straight-line circuit, and
// AddRoundKey XORs the constant-bank masks RK_BM (both fixed keys).
//
// mmo_column_folded is the same cipher as the LOP3 instructions of
// ops/op_count.py's cover, for the PRG kernels of aes_mmo.cu: MixColumns
// goes through the column XOR, and each round key is moved to the S-box
// outputs (RK_SBOX), where the cover takes it as an input of the output
// instructions (5 LOP3 more a byte than the S-box alone).
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

__host__ __device__ __forceinline__ void sub_bytes_bm(uint32_t s[128]) {
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    uint32_t x[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = s[pl(7 - i, b)];  // circuit is MSB-first
    sbox_bp113(x, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[pl(7 - i, b)] = y[i];
  }
}

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

// Bit k of xtime(byte): doubling in GF(2^8), reduction polynomial 0x11B.
__host__ __device__ __forceinline__ uint32_t xtime_bit(const uint32_t s[128],
                                                       int byte, int k) {
  const uint32_t a7 = s[pl(7, byte)];
  switch (k) {
    case 0: return a7;
    case 1: return s[pl(0, byte)] ^ a7;
    case 3: return s[pl(2, byte)] ^ a7;
    case 4: return s[pl(3, byte)] ^ a7;
    default: return s[pl(k - 1, byte)];
  }
}

// out_r = 2 a_r + 3 a_{r+1} + a_{r+2} + a_{r+3} in each column.
__host__ __device__ __forceinline__ void mix_columns_bm(uint32_t s[128]) {
  uint32_t t[128];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b0 = 4 * c + r;
      const int b1 = 4 * c + ((r + 1) & 3);
      const int b2 = 4 * c + ((r + 2) & 3);
      const int b3 = 4 * c + ((r + 3) & 3);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        t[pl(k, b0)] = xtime_bit(s, b0, k) ^ xtime_bit(s, b1, k) ^
                       s[pl(k, b1)] ^ s[pl(k, b2)] ^ s[pl(k, b3)];
    }
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] = t[p];
}

__host__ __device__ __forceinline__ void add_round_key(uint32_t s[128], int key,
                                                       int rnd) {
#pragma unroll
  for (int p = 0; p < 128; ++p) s[p] ^= RK_BM[key][rnd][p];
}

// AES-128 encryption of one column word's state with PRF key `key` (0 = L,
// 1 = R).  The final round skips MixColumns inside the same loop body.
__host__ __device__ __forceinline__ void aes128_encrypt_bm(uint32_t s[128],
                                                           int key) {
  add_round_key(s, key, 0);
#pragma unroll 1
  for (int rnd = 1; rnd <= 10; ++rnd) {
    sub_bytes_bm(s);
    shift_rows_bm(s);
    if (rnd < 10) mix_columns_bm(s);
    add_round_key(s, key, rnd);
  }
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

// MMO of column word j, in and out in one plane order (canonical with
// kCanon: register q is row row_of(q)): O = AES(S) ^ S with the key whose
// S-box-output masks are rk[11][128] (RK_SBOX[key]).  One round per turn
// of a loop that is not unrolled, so the code is one round's and the key a
// run-time value; MixColumns through the column XOR.  S is re-read for the
// final XOR rather than held.
template <bool kCanon>
__host__ __device__ __forceinline__ void mmo_column_folded(const uint32_t* S,
                                                           uint32_t* O, size_t B,
                                                           size_t j,
                                                           const uint32_t* rk) {
  uint32_t s[128];
#pragma unroll
  for (int b = 0; b < 16; ++b)  // byte by byte: the first S-box waits for 8 rows
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const int q = pl(bit, b);
      s[q] = S[row_of<kCanon>(q) * B + j] ^ rk[row_of<true>(q)];
    }
#pragma unroll 1
  for (int rnd = 1; rnd <= 10; ++rnd) {
    sub_bytes_masked(s, rk + 128 * rnd);
    shift_rows_bm(s);
    if (rnd < 10) mix_columns_cover(s);
  }
  j = opaque(j);
#pragma unroll
  for (int q = 0; q < 128; ++q) {
    const size_t i = row_of<kCanon>(q) * B + j;
    O[i] = s[q] ^ S[i];
  }
}

}  // namespace
