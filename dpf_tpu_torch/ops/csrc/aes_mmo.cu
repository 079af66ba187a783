// Fixed-key AES-128-MMO on bitsliced planes: the compat profile's DPF PRG and
// leaf convert, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernels:
//   prg_bm_kernel            dpf_tpu/ops/aes_pallas.py::_prg_kernel_bm
//                            (wrapper prg_planes_pallas_bm): L = AES_kL(S) ^ S,
//                            R = AES_kR(S) ^ S, bit-major in and out.
//   leaf_words_bm_kernel     dpf_tpu/ops/aes_pallas.py::_mmo_canon_kernel_bm
//                            (wrapper mmo_planes_pallas_bm_canon) and the two
//                            steps that follow it on every route
//                            (dpf_tpu/models/dpf.py::_convert_leaves,
//                            _convert_leaves_fused): AES_kL(S) ^ S from
//                            bit-major planes, the final CW under t, and
//                            unpack_planes' per-key words.
//   prg_canon_kernel         dpf_tpu/ops/aes_pallas.py::_prg_kernel (wrapper
//                            prg_planes_pallas): the PRG, canonical in and out.
//   leaf_words_canon_kernel  dpf_tpu/ops/aes_pallas.py::_mmo_kernel (wrapper
//                            mmo_planes_pallas) and the same two steps: the
//                            leaf convert from canonical planes.
//   prg_bm_il_kernel         dpf_tpu/ops/aes_pallas.py::_prg_kernel_bm_il
//                            (wrapper prg_planes_pallas_bm_il): prg_bm_kernel's
//                            function, which the TPU kernel computed with both
//                            encryptions advancing together.
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
// S-box is the straight-line generated circuit.  Global loads coalesce
// (neighbouring threads own neighbouring column words).  An MMO re-reads S
// (L1/L2 hot) for the final XOR instead of holding a second 128-word state.
//
// Every kernel here runs one MMO a thread on aes_bm.cuh's folded cipher
// (folded_load, folded_rounds): the LOP3 instructions of ops/op_count.py's
// cover (generated into sbox_bp113.cuh), MixColumns through the column XOR,
// and each round key moved to the S-box outputs, where the cover takes it as
// an input of the output instructions (90 LOP3 a byte against 85; 1,741 a
// round).  The block copies those masks (RK_SBOX) into shared memory once; a
// warp's lanes read the same words (a broadcast), with no constant-bank
// load.  The round loop is not unrolled: one round's code (~30 KB) stays in
// the instruction cache, and the compiler keeps the state in 255 registers
// (two blocks of 128 threads an SM) with no spill.  The loads go byte by
// byte, so the first S-box waits for 8 rows, not 128.  What was measured
// against (PERF.md, PR 8): ten unrolled rounds with constant masks (a
// template key) spill and overrun the instruction cache; a copy of the code
// per key, or the key in blockIdx (each warp then reads S from L2 or DRAM
// alone), is slower.
//
// The PRG kernels (prg_bm_kernel, prg_canon_kernel, prg_bm_il_kernel) run
// two warps of one block over the same 32 column words (warp 2 w + key
// encrypts with `key`): a warp's second reader of each line finds it in L1,
// and one copy of the round code serves both keys, the key a run-time value
// uniform across each warp.  The interleaved PRG computes prg_bm_kernel's
// function, so it launches the same block (prg_block<false>) from its own
// __global__: on this card the TPU kernel's interleaving of the two
// encryptions is what the warp pair already does, one key a warp.
//
// The leaf kernels (leaf_words_bm_kernel, leaf_words_canon_kernel) run key L
// on one column word (w, kp), 32 keys at one leaf, a thread, and end in the
// two steps that the JAX package ran as separate XLA passes over the whole
// leaf tensor (leaf_store): per canonical plane p, x = AES(S) ^ S ^
// (fcw[p, kp] & T[w, kp]), one LOP3 beside the MMO's; then, per word q, a
// 32x32 bit transpose of planes 32 q .. 32 q + 31 in registers gives word q
// of each of the column's 32 keys (unpack_planes' function: its _FROM_BM
// permute disappears into the transpose's row order); then each key's four
// words go out as one 16 B store to out[32 kp + j, leaf_off + w].  So the
// leaf tensor crosses device memory once, planes in and words out.  The
// transpose runs its 16- and 8-bit stages as byte permutes (PRMT, two a
// pair of rows) and its 4-, 2- and 1-bit stages as two shifts and two LOP3
// a pair: 256 instructions a transpose, 1,152 with the CW a column
// (ops/op_count.py::LEAF_EPILOGUE), 7 % beside the cipher's 16,236.  The
// input is the level-major [128, W, Kp] state (column c = w * Kp + kp) or
// the fused route's node-minor [128, Kp, W] (c = kp * W + w), T [W, Kp] or
// [Kp, W] indexed by c in both; the output's leaf offset and row length let
// the chunked route write each subtree straight into its columns of the
// whole output.
//
// The stores decide the design as much as the cipher (PERF.md, PR 10).  A
// block is a tile of key words by leaves, the key word fastest
// (leaf_tile): at 1024 keys a warp takes 16 key words at 2 leaves, so its
// loads still cover 4 sectors an instruction and each key's two 16 B stores
// fill one 32 B sector; in the node-minor layout a warp takes 32 leaves of
// one key word, 512 B a key.  Threads on consecutive key words with 4 B
// stores one output row apart ran the level-major layout at twice the
// node-minor one's time.  Registers: with 255 taken by the rounds, a value
// held across the round loop spills (PR 9), and so did the epilogue's 64-bit
// addresses.  So a thread finds its place (leaf_column: divisions included)
// and its t before the rounds and keeps them in a shared-memory slot; the
// block stages its key words' final CW planes (at most 16 key words, 8.5 KB)
// and its columns' input rows (32 KB) in shared memory, where the epilogue
// reads both at immediate offsets from one base; and the slot and the input
// are read back by volatile loads.  47.5 KB of shared memory a block, four
// blocks of 64 threads an SM, 0 B spilled.
//
// The per-column functions compile as host C++ too (define __host__,
// __device__, __constant__ empty and __forceinline__ as inline), which is how
// tests/port/test_torch_kernel_host.py checks this file's arithmetic without a GPU.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

// One leaf-convert launch's operands (a kernel parameter, so at namespace
// scope).  Column c of the input is leaf w of key word kp: c = w * Kp + kp
// (level-major S [128, W, Kp], T [W, Kp]) or, with node_minor, c = kp * W + w
// (S [128, Kp, W], T [Kp, W]).  Word q of key k at leaf l of the output is
// out[(k * leaves + l) * 4 + q]; the column's leaf w is l = leaf_off + w.
struct LeafArgs {
  const uint32_t* S;    // [128, W * Kp] leaf planes (bit-major, or canonical)
  const uint32_t* T;    // [W * Kp] the leaves' control bits
  const uint32_t* fcw;  // [128, Kp] final CW planes, canonical order
  uint32_t* out;        // [32 Kp, leaves, 4] per-key words
  long long W, Kp, leaves, leaf_off;
  int node_minor;
};

namespace {

constexpr int kThreads = 128;

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

// PRMT: byte i of the result is byte (sel >> 4 i) & 7 of the pair, a's
// bytes being 0-3 and b's 4-7.
__host__ __device__ __forceinline__ uint32_t byte_perm(uint32_t a, uint32_t b,
                                                       uint32_t sel) {
#ifdef __CUDA_ARCH__
  return __byte_perm(a, b, sel);
#else
  const uint64_t x = static_cast<uint64_t>(b) << 32 | a;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>(x >> 8 * ((sel >> 4 * i) & 7) & 0xFF) << 8 * i;
  return r;
#endif
}

// One stage of transpose32: rows r and r + kJ (r & kJ clear) trade the
// kJ-bit blocks where the mask m is clear in row r and set in row r + kJ.
template <int kJ>
__host__ __device__ __forceinline__ void transpose_stage(uint32_t x[32], uint32_t m) {
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (!(r & kJ)) {
      const uint32_t a = x[r], b = x[r + kJ];
      x[r] = lop3<0xE4>(a, b << kJ, m);       // m ? a : b << kJ
      x[r + kJ] = lop3<0xE4>(a >> kJ, b, m);  // m ? a >> kJ : b
    }
}

// 32x32 bit transpose in place: afterwards bit i of x[j] is what bit j of
// x[i] was (LSB-first).  Five stages of block swaps (Hacker's Delight 7-3);
// the 16- and 8-bit ones are byte permutes.
__host__ __device__ __forceinline__ void transpose32(uint32_t x[32]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const uint32_t a = x[r], b = x[r + 16];
    x[r] = byte_perm(a, b, 0x5410);
    x[r + 16] = byte_perm(a, b, 0x7632);
  }
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (!(r & 8)) {
      const uint32_t a = x[r], b = x[r + 8];
      x[r] = byte_perm(a, b, 0x6240);
      x[r + 8] = byte_perm(a, b, 0x7351);
    }
  transpose_stage<4>(x, 0x0F0F0F0Fu);
  transpose_stage<2>(x, 0x33333333u);
  transpose_stage<1>(x, 0x55555555u);
}

// Threads of a leaf block, one column each.  A block is a tile of kt key
// words by kLeafThreads / kt leaves, the key word fastest: kt is 1 in the
// node-minor layout (a warp on 32 consecutive leaves of one key word) and,
// in the level-major one, the largest power of 2 up to kLeafKeyWords and
// Kp (at 1024 keys a warp on 16 key words at 2 leaves, so each key's stores
// fill a 32 B sector).  The block stages its key words' final CW planes in
// shared memory at a row stride of kFcwStride words (odd: the staging
// threads, one plane each, hit distinct banks).
constexpr int kLeafThreads = 64;
constexpr int kLeafKeyWords = 16;
constexpr int kFcwStride = kLeafKeyWords + 1;

// Key words a leaf block spans.
__host__ __device__ inline int leaf_tile_keys(const LeafArgs& a) {
  int kt = 1;
  while (!a.node_minor && 2 * kt <= kLeafKeyWords && 2 * kt <= a.Kp) kt *= 2;
  return kt;
}

__host__ __device__ inline long long leaf_blocks(const LeafArgs& a) {
  const long long kt = leaf_tile_keys(a), wt = kLeafThreads / kt;
  return (a.Kp + kt - 1) / kt * ((a.W + wt - 1) / wt);
}

// A leaf block's tile: key words kp0 .. kp0 + kt - 1 (those below Kp) by
// leaves w0 .. w0 + kLeafThreads / kt - 1 (those below W).
struct LeafTile {
  size_t kp0, w0;
  int kt;
};

__host__ __device__ inline LeafTile leaf_tile(const LeafArgs& a, size_t block) {
  const int kt = leaf_tile_keys(a);
  const size_t nk = (static_cast<size_t>(a.Kp) + kt - 1) / kt;
  return {block % nk * kt, block / nk * (kLeafThreads / kt), kt};
}

// Thread `thread` of `threads` copies its planes of the tile's final CW into
// fcs[p * kFcwStride + i] for key word kp0 + i (a barrier follows before any
// thread reads it).
__host__ __device__ inline void stage_fcw(const LeafArgs& a, const LeafTile& tile,
                                          uint32_t* fcs, int thread, int threads) {
  const size_t Kp = static_cast<size_t>(a.Kp);
  for (int p = thread; p < 128; p += threads)
    for (size_t i = 0; i < static_cast<size_t>(tile.kt) && tile.kp0 + i < Kp; ++i)
      fcs[p * kFcwStride + i] = a.fcw[p * Kp + tile.kp0 + i];
}

// A leaf column's place, found before the cipher: its index c in the
// input's flattening, its words' offset in out (key 32 kp, leaf
// leaf_off + w), its key word's index in the tile, its control word t.
struct LeafColumn {
  size_t c, out;
  uint32_t i, t;
};

// Thread `thread`'s column of the tile into x; false if it has none.
__host__ __device__ __forceinline__ bool leaf_column(const LeafArgs& a, const LeafTile& tile,
                                                     int thread, LeafColumn& x) {
  const size_t W = static_cast<size_t>(a.W), Kp = static_cast<size_t>(a.Kp);
  const size_t i = thread % tile.kt, kp = tile.kp0 + i, w = tile.w0 + thread / tile.kt;
  if (kp >= Kp || w >= W) return false;
  const size_t c = a.node_minor ? kp * W + w : w * Kp + kp;
  x = {c, (32 * kp * static_cast<size_t>(a.leaves) + static_cast<size_t>(a.leaf_off) + w) * 4,
       static_cast<uint32_t>(i), a.T[c]};
  return true;
}

// The leaf kernels' cipher input: folded_load's, for column x.c, with each
// row also kept in the thread's column of the block's shared copy of the
// input (col[row * kLeafThreads]), where the feed-forward re-reads it.
template <bool kCanon>
__host__ __device__ __forceinline__ void leaf_load(const LeafArgs& a, size_t c,
                                                   const uint32_t* rk, uint32_t* col,
                                                   uint32_t s[128]) {
  const size_t N = static_cast<size_t>(a.W) * static_cast<size_t>(a.Kp);
#pragma unroll
  for (int b = 0; b < 16; ++b)
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const int q = pl(bit, b), row = row_of<kCanon>(q);
      const uint32_t v = a.S[row * N + c];
      col[row * kLeafThreads] = v;
      s[q] = v ^ rk[row_of<true>(q)];
    }
}

// p[0..3] = a, b, c, d: one 16 B store on the card.
__host__ __device__ __forceinline__ void store4(uint32_t* p, uint32_t a, uint32_t b,
                                                uint32_t c, uint32_t d) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  p[0] = a;
  p[1] = b;
  p[2] = c;
  p[3] = d;
#endif
}

// The leaf kernels' epilogue for column x, s the cipher's state after
// folded_rounds (kCanon: the input is in canonical plane order), fcs the
// block's staged final CW, col the thread's column of the shared copy of
// the input.  Per word q: canonical planes 32 q .. 32 q + 31, each AES(S) ^
// S ^ (fcw[p, kp] & t), then their 32x32 transpose, word q of the column's
// 32 keys.  Then each key's four words as one 16 B store.  The input is
// re-read by volatile loads: the compiler may not forward leaf_load's
// stores to them and keep 128 values live across the rounds.
template <bool kCanon>
__host__ __device__ __forceinline__ void leaf_store(const LeafArgs& a, const LeafColumn& x,
                                                    const uint32_t* fcs,
                                                    const volatile uint32_t* col,
                                                    const uint32_t s[128]) {
  const uint32_t* f = fcs + x.i;
  uint32_t o[128];  // o[32 q + j]: word q of key 32 kp + j
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t* y = o + 32 * q;  // y[i]: canonical plane 32 q + i, until transposed
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int bit = kCanon ? k & 7 : k >> 2, byte = 4 * q + (kCanon ? k >> 3 : k & 3);
      const int i = 8 * (byte & 3) + bit, r = pl(bit, byte);
      y[i] = s[r] ^ col[row_of<kCanon>(r) * kLeafThreads] ^ (f[(32 * q + i) * kFcwStride] & x.t);
    }
    transpose32(y);
  }
  const size_t row = static_cast<size_t>(a.leaves) * 4;  // words a key
  uint32_t* out = a.out + x.out;
#pragma unroll
  for (int j = 0; j < 32; ++j) store4(out + j * row, o[j], o[32 + j], o[64 + j], o[96 + j]);
}

// A leaf block's shared memory: 47.5 KB, four blocks an SM.
struct LeafShared {
  alignas(16) uint32_t rk[kRkWords / 2];  // key L's RK_SBOX
  uint32_t fcw[128 * kFcwStride];         // the tile's final CW planes
  LeafColumn slot[kLeafThreads];
  uint32_t S[128 * kLeafThreads];         // the columns' input rows, S[row][thread]
};

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The PRG kernels: RK_SBOX into shared memory, where every lane of a warp
// reads the same mask (a broadcast), then one MMO a thread.
template <bool kCanon>
__device__ __forceinline__ void prg_block(const uint32_t* S, uint32_t* L, uint32_t* R,
                                          long long B) {
  __shared__ __align__(16) uint32_t rk[kRkWords];
  copy_rk_sbox(rk, threadIdx.x, kThreads);
  __syncthreads();
  prg_thread<kCanon>(S, L, R, B, blockIdx.x, threadIdx.x, rk);
}

extern "C" __global__ void __launch_bounds__(kThreads, 2)
    prg_bm_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_block<false>(S, L, R, B);
}

extern "C" __global__ void __launch_bounds__(kThreads, 2)
    prg_canon_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_block<true>(S, L, R, B);
}

extern "C" __global__ void __launch_bounds__(kThreads, 2)
    prg_bm_il_kernel(const uint32_t* S, uint32_t* L, uint32_t* R, long long B) {
  prg_block<false>(S, L, R, B);
}

// The leaf kernels: key L's RK_SBOX and the tile's final CW into shared
// memory, then one column a thread, its place (leaf_column) found before
// the rounds and kept in its slot across them.
template <bool kCanon>
__device__ __forceinline__ void leaf_block(const LeafArgs& a) {
  __shared__ LeafShared sh;
  const LeafTile tile = leaf_tile(a, blockIdx.x);
  copy_rk_sbox(sh.rk, threadIdx.x, kLeafThreads, kRkWords / 2);
  stage_fcw(a, tile, sh.fcw, threadIdx.x, kLeafThreads);
  __syncthreads();
  if (!leaf_column(a, tile, threadIdx.x, sh.slot[threadIdx.x])) return;
  uint32_t s[128];
  leaf_load<kCanon>(a, sh.slot[threadIdx.x].c, sh.rk, sh.S + threadIdx.x, s);
  folded_rounds(s, sh.rk);
  const volatile LeafColumn& v = sh.slot[threadIdx.x];
  leaf_store<kCanon>(a, {v.c, v.out, v.i, v.t}, sh.fcw, sh.S + threadIdx.x, s);
}

extern "C" __global__ void __launch_bounds__(kLeafThreads, 4)
    leaf_words_bm_kernel(const LeafArgs a) {
  leaf_block<false>(a);
}

extern "C" __global__ void __launch_bounds__(kLeafThreads, 4)
    leaf_words_canon_kernel(const LeafArgs a) {
  leaf_block<true>(a);
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

extern "C" int dpf_prg_canon(const void* S, void* L, void* R, long long B,
                             void* stream) {
  prg_canon_kernel<<<pair_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(L),
      static_cast<uint32_t*>(R), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_prg_bm_il(const void* S, void* L, void* R, long long B,
                             void* stream) {
  prg_bm_il_kernel<<<pair_blocks(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(S), static_cast<uint32_t*>(L),
      static_cast<uint32_t*>(R), B);
  return static_cast<int>(cudaGetLastError());
}

// The leaf convert: S, T, fcw, out as LeafArgs says; W, Kp >= 1,
// 0 <= leaf_off, leaf_off + W <= leaves and out 16 B aligned (the wrapper
// checks the shapes).
static int leaf_launch(bool canon, const void* S, const void* T, const void* fcw, void* out,
                       long long W, long long Kp, int node_minor, long long leaves,
                       long long leaf_off, void* stream) {
  if (W < 1 || Kp < 1 || leaf_off < 0 || leaf_off + W > leaves)
    return static_cast<int>(cudaErrorInvalidValue);
  const LeafArgs a{static_cast<const uint32_t*>(S), static_cast<const uint32_t*>(T),
                   static_cast<const uint32_t*>(fcw), static_cast<uint32_t*>(out),
                   W, Kp, leaves, leaf_off, node_minor};
  const long long blocks = leaf_blocks(a);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = canon ? leaf_words_canon_kernel : leaf_words_bm_kernel;
  kernel<<<static_cast<unsigned>(blocks), kLeafThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpf_leaf_words_bm(const void* S, const void* T, const void* fcw, void* out,
                                 long long W, long long Kp, int node_minor, long long leaves,
                                 long long leaf_off, void* stream) {
  return leaf_launch(false, S, T, fcw, out, W, Kp, node_minor, leaves, leaf_off, stream);
}

extern "C" int dpf_leaf_words_canon(const void* S, const void* T, const void* fcw,
                                    void* out, long long W, long long Kp, int node_minor,
                                    long long leaves, long long leaf_off, void* stream) {
  return leaf_launch(true, S, T, fcw, out, W, Kp, node_minor, leaves, leaf_off, stream);
}

extern "C" const char* dpf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
