// What K3's forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu) must agree on: the tiles, the mask, the key
// tiles the index path visits, and the copies into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace attn {

constexpr int kBQ = 64;             // query rows a tile
constexpr int kBKV = 64;            // keys a tile
constexpr float kMaskFill = -2.0e38f;
constexpr int kBf16Threads = 128;   // the bf16 kernels: 4 warps x 16 rows
constexpr int kF32Threads = 256;    // the f32 kernels: a 16 x 16 grid

// Whether the mask keeps the key at position kp for a query at position
// qp: causal keeps kp <= qp, a window (> 0) kp > qp - window.
__device__ __forceinline__ bool kept(int qp, int kp, int causal,
                                     int window) {
  bool ok = true;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

// Key tiles [kt_begin, kt_end) that hold a key some row of the query tile
// at q0 keeps: on the index path tiles wholly past the diagonal or before
// the window are skipped (see flash_attention.cu's header); the position
// path visits all.
template <bool kPos>
__device__ __forceinline__ void key_tiles(int q0, int sk, int causal,
                                          int window, int& kt_begin,
                                          int& kt_end) {
  kt_end = (sk + kBKV - 1) / kBKV;
  kt_begin = 0;
  if (kPos) return;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBKV + 1);
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBKV;
}

// The position of the key at index kidx on the position path (0 past Sk,
// where the key does not exist whatever its position).
__device__ __forceinline__ int key_pos(const int* __restrict__ k_pos,
                                       int kidx, int sk) {
  return kidx < sk ? __ldg(k_pos + kidx) : 0;
}

// Rows [row0, row0 + 64) of a (nrows, D) bf16 matrix into a shared tile of
// row stride D + 8 by cp.async (kBf16Threads threads), zero past nrows.
template <int D>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(kBQ * kChunks % kBf16Threads == 0, "copy_tile");
#pragma unroll
  for (int i = 0; i < kBQ * kChunks / kBf16Threads; ++i) {
    const int idx = threadIdx.x + i * kBf16Threads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const bool ok = row0 + r < nrows;
    tc::cp_async16(dst + r * (D + 8) + c,
                   src + (size_t)(ok ? row0 + r : 0) * D + c, ok ? 16 : 0);
  }
}

// 64 rows x D elements of a (nrows, D) f32 matrix into shared memory (row
// stride ld_s, kF32Threads threads), times `mul`, zero past nrows.
template <int D>
__device__ void load_rows(float* dst, int ld_s, const float* src, int row0,
                          int nrows, float mul) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < kBQ * kVecs; idx += kF32Threads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 4;
    float* d = dst + r * ld_s + c;
    if (row0 + r < nrows) {
      const float4 e = *reinterpret_cast<const float4*>(
          src + (size_t)(row0 + r) * D + c);
      d[0] = e.x * mul;
      d[1] = e.y * mul;
      d[2] = e.z * mul;
      d[3] = e.w * mul;
    } else {
      d[0] = d[1] = d[2] = d[3] = 0.0f;
    }
  }
}

}  // namespace attn
