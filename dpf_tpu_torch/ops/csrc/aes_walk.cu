// Compat-profile pointwise evaluation: the whole root-to-leaf walk of one
// key's queries, written by hand for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel:
//   walk_bm_kernel  dpf_tpu/ops/aes_pallas.py::_walk_kernel_bm (wrapper
//                   eval_points_walk_planes): nu levels of the double MMO,
//                   the control-bit plane extracted and cleared, the seed CW
//                   XORed in under t, each query's child chosen by its path
//                   bit; then the leaf MMO, canonical plane order, the final
//                   CW under t, and the leaf bit picked by a one-hot select.
//
// Operands (int32 carriers of uint32 words on the PyTorch side, contiguous),
// every key word a lane mask (0 or ~0):
//   seeds  [128, K]      root seed planes, bit-major
//   t      [K]           root control bit
//   scw    [nu, 128, K]  seed CW planes, bit-major
//   tl, tr [nu, K]       the t CWs
//   fcw    [128, K]      final CW planes, canonical order
//   pw     [nu, K, qp]   bit l of pw[i, k, j]: level i's path bit of query
//                        32 j + l of key k (1 = right)
//   sel    [128, K, qp]  bit l of sel[p, k, j]: 1 where that query's leaf
//                        bit is canonical plane p
//   out    [K, qp]       the output bits, packed the same way
//
// Decomposition: one thread per column (key k, query word j): the column's
// 32 queries are the 32 blocks of a bitsliced state, all of the same key, so
// the per-key masks broadcast over the block's threads (keys on blockIdx.x,
// query words on blockIdx.y * kWalkThreads + threadIdx.x, bounds-checked).
// Any K >= 1 and qp >= 1 run; nu = 0 (log_n <= 7) skips the level loop.
//
// Registers.  The cipher keeps its 128-word state in registers (255 of them
// in prg_bm_kernel); a level needs the parent S for both MMOs and their
// feed-forward, and the left child until the right one is known.  Both live
// in shared memory instead, word-major (st[p][lane], conflict-free): 1 KB per
// thread, 32 KB for the block of one warp.  A level reads S, runs the left
// MMO, stores the left child under ~path into nx, reruns from S for the right
// MMO and overwrites S with (right & path) | nx.  Both MMOs and the leaf's go
// through one call site of the cipher, which keeps the kernel's code to one
// copy of the unrolled round (the instruction cache holds it).
//
// What bounds it: the ciphers, as in aes_mmo.cu.  A column does nu PRGs and
// one leaf MMO (ops/op_count.py::walk_lop3_per_column) against about
// (2 nu + 130) words of traffic of its own.
//
// The per-column walk compiles as host C++ too (define __host__, __device__,
// __constant__ empty and __forceinline__ as inline):
// tests/port/test_torch_kernel_host.py.

#include <cstddef>
#include <cstdint>

#include "aes_bm.cuh"

// One launch's operands (a kernel parameter, so at namespace scope).
struct WalkArgs {
  const uint32_t* seeds;
  const uint32_t* t;
  const uint32_t* scw;
  const uint32_t* tl;
  const uint32_t* tr;
  const uint32_t* fcw;
  const uint32_t* pw;
  const uint32_t* sel;
  uint32_t* out;
  long long K, qp;
  int nu;
};

namespace {

// One child of a level, plane p: the MMO output s[p] ^ S[p], plane 0 (the
// control-bit plane) cleared, the seed CW XORed in under the parent's t.
__host__ __device__ __forceinline__ uint32_t child_plane(const uint32_t s[128],
                                                         uint32_t S, int p,
                                                         uint32_t cw,
                                                         uint32_t T) {
  return (p ? s[p] ^ S : 0u) ^ (cw & T);
}

// The walk of column (k, j).  st and nx are this column's two 128-word
// buffers, plane p at index p * kStride.  Step 2 i runs level i's left MMO,
// step 2 i + 1 its right MMO, step 2 nu the leaf MMO: one cipher call site,
// so the kernel holds one copy of the unrolled rounds.
template <int kStride>
__host__ __device__ inline void walk_column(const WalkArgs& a, long long k,
                                            long long j, uint32_t* st,
                                            uint32_t* nx) {
  const size_t K = static_cast<size_t>(a.K), qp = static_cast<size_t>(a.qp);
  uint32_t s[128];
#pragma unroll
  for (int p = 0; p < 128; ++p) st[p * kStride] = a.seeds[p * K + k];
  uint32_t T = a.t[k], go = 0, tl = 0;
#pragma unroll 1
  for (int step = 0;; ++step) {
    const int i = step >> 1, key = step & 1;
    const bool leaf = i == a.nu;
#pragma unroll
    for (int p = 0; p < 128; ++p) s[p] = st[p * kStride];
    aes128_encrypt_bm(s, key);
    if (leaf) {
      // Canonical plane p = 8 * byte + bit is bit-major register
      // 16 * bit + byte; the final CW under t; the one-hot bit select.
      uint32_t o = 0;
#pragma unroll
      for (int p = 0; p < 128; ++p) {
        const int q = 16 * (p & 7) + (p >> 3);
        const uint32_t c = s[q] ^ st[q * kStride] ^ (a.fcw[p * K + k] & T);
        o |= c & a.sel[(p * K + k) * qp + j];
      }
      a.out[k * qp + j] = o;
      return;
    }
    const uint32_t* cw = a.scw + i * 128 * K + k;
    if (key == 0) {  // the left child, kept where the path goes left
      go = a.pw[(i * K + k) * qp + j];
      tl = (s[0] ^ st[0]) ^ (a.tl[i * K + k] & T);
#pragma unroll
      for (int p = 0; p < 128; ++p)
        nx[p * kStride] = child_plane(s, st[p * kStride], p, cw[p * K], T) & ~go;
    } else {  // the right child where it goes right; S is read a last time
      const uint32_t tr = (s[0] ^ st[0]) ^ (a.tr[i * K + k] & T);
#pragma unroll
      for (int p = 0; p < 128; ++p)
        st[p * kStride] =
            (child_plane(s, st[p * kStride], p, cw[p * K], T) & go) | nx[p * kStride];
      T = (tr & go) | (tl & ~go);
    }
  }
}

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

constexpr int kWalkThreads = 32;

extern "C" __global__ void __launch_bounds__(kWalkThreads)
    walk_bm_kernel(const WalkArgs a) {
  __shared__ uint32_t st[128 * kWalkThreads];
  __shared__ uint32_t nx[128 * kWalkThreads];
  const long long k = blockIdx.x;
  const long long j = static_cast<long long>(blockIdx.y) * kWalkThreads + threadIdx.x;
  if (j >= a.qp) return;
  walk_column<kWalkThreads>(a, k, j, st + threadIdx.x, nx + threadIdx.x);
}

// C interface for ctypes: launch on `stream`, return cudaGetLastError().
extern "C" int dpf_walk_bm(const void* seeds, const void* t, const void* scw,
                           const void* tl, const void* tr, const void* fcw,
                           const void* pw, const void* sel, void* out,
                           long long K, long long qp, int nu, void* stream) {
  const long long tiles = (qp + kWalkThreads - 1) / kWalkThreads;
  if (K < 1 || qp < 1 || nu < 0 || K > 0x7FFFFFFFLL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WalkArgs a{static_cast<const uint32_t*>(seeds), static_cast<const uint32_t*>(t),
                   static_cast<const uint32_t*>(scw), static_cast<const uint32_t*>(tl),
                   static_cast<const uint32_t*>(tr), static_cast<const uint32_t*>(fcw),
                   static_cast<const uint32_t*>(pw), static_cast<const uint32_t*>(sel),
                   static_cast<uint32_t*>(out), K, qp, nu};
  walk_bm_kernel<<<dim3(static_cast<unsigned>(K), static_cast<unsigned>(tiles)),
                   kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dpf_walk_bm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
