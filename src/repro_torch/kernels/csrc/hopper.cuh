// Hopper (sm_90a) helpers shared by K3's backward (flash_attention_bwd.cu)
// and K4's backward (ssd_scan_bwd.cu): shared-memory matrix descriptors,
// mbarriers (with a wait that traps rather than hangs), the warpgroup MMA
// m64n64k16 (f32 += bf16 x bf16) with both operands in shared memory or A
// in registers, the split of an f32 accumulator into hi + lo bf16 A
// fragments, and libcuda's tensor-map encoder.
//
// wgmma accumulator layout of a 64 x 64 f32 tile (g = lane / 4, t = lane
// % 4, w the warp in its warpgroup): d[4 j + 2 h + c] is row 16 w + g + 8 h,
// column 8 j + 2 t + c. Its 16 columns of k-step kq are the A fragment of
// m64nNk16 (mma.m16n8k16's A layout, one 16-row slice a warp).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace hop {

// Shared memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (1: 128-byte swizzle, 2: 64-byte,
// 3: 32-byte).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | mode << 62;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA writes on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tc::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of this parity has completed; traps
// (a launch error, not a hang) if it has not after 2^24 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n.reg .u32 polls;\nmov.u32 polls, 0;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\nadd.u32 polls, polls, 1;\n"
      "setp.lt.u32 done, polls, 16777216;\n@done bra WAIT;\ntrap;\n"
      "DONE:\n}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before a
// later async-proxy read (wgmma, TMA) that a barrier separates from them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The dynamic shared memory from its first 1,024-byte boundary (the
// 128-byte swizzle's period); each kernel asks for 1 KB more than it uses.
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (tc::smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// After wg_wait_all: the compiler may not read an accumulator, nor reuse a
// fragment's registers, before this point (it does not see wgmma's
// asynchronous reads and writes)
template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ void hold(uint32_t (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
  }
}

// d (64 x 64, f32) += a b (or = a b when accumulate is 0): A and B from
// shared memory, each K-major (0) or MN-major (1: wgmma's transpose bit)
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, f32) += a b: A (64 x 16) in registers, B from shared memory,
// MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// The A fragments of the four 16-column k-steps of a 64 x 64 accumulator x
// (k-step kq: its n8 blocks 2 kq and 2 kq + 1) as hi + lo bf16 halves
// (x_hi = bf16(x), x_lo = bf16(x - x_hi)).
__device__ __forceinline__ void split_a(const float (&x)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0: row g, cols 2t, 2t+1; a1: row g + 8; a2, a3: cols + 8
      const int e = 8 * kq + 4 * (i >> 1) + 2 * (i & 1);
      hi[kq][i] = tc::pack_bf16(x[e], x[e + 1]);
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(&hi[kq][i]);
      lo[kq][i] =
          tc::pack_bf16(x[e] - __low2float(h), x[e + 1] - __high2float(h));
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, looked up in the already loaded
// libcuda.so.1 (nothing links against it); null if it is not there.
inline decltype(&cuTensorMapEncodeTiled) encode_tiled() {
  static const auto fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(
        lib == nullptr ? nullptr : dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

}  // namespace hop
