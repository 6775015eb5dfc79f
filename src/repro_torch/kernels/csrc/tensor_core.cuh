// Warp-level tensor-core and asynchronous-copy helpers shared by K2
// (lora_matmul.cu), K3 (flash_attention.cu) and K4 (ssd_scan.cu): cp.async
// 16-byte copies into shared memory, ldmatrix, movmatrix, and mma.sync
// m16n8k16 bf16 -> f32.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row-major), 4 registers of two bf16: a0 (row g, cols 2t,
//   2t+1), a1 (row g + 8, cols 2t, 2t+1), a2 (row g, cols 2t+8, 2t+9), a3
//   (row g + 8, cols 2t+8, 2t+9);
// - B (16 x 8, k x n), 2 registers: b0 (k rows 2t, 2t+1, col g), b1 (k rows
//   2t+8, 2t+9, col g);
// - C / D (16 x 8, f32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3
//   (row g + 8, cols 2t, 2t+1).
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the
// row addresses of matrix i, and register i of every lane receives matrix
// i's elements (row lane / 4, cols 2 (lane % 4), +1), transposed with .trans.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; the bytes past
// src_bytes (0 or 16 here) are zero-filled, so a row past the edge costs no
// branch. src must be a valid 16-byte aligned address even when src_bytes
// is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b: one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8 x 8 bf16 matrix held one row pair a lane (row
// lane / 4, cols 2 (lane % 4), +1), in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// two floats as one register of two bf16 (lo in the low half), each rounded
// to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
