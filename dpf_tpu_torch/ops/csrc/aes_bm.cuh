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

}  // namespace
