// K4: the Mamba2 SSD chunk scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_kernel (the Pallas
// `ssd_scan`). Per head (heads folded into the batch, B and C already
// repeated from groups to heads by the caller, as on the TPU):
//   h_t = exp(dt_t A) h_{t-1} + dt_t outer(B_t, x_t),   y_t = C_t . h_t
// for x (BH, S, P) and B, C (BH, S, N) in float32 or bfloat16, dt (BH, S)
// and A (BH,) in float32; y (BH, S, P) in x's dtype, the final state
// h_final (BH, N, P) in float32. The function and its constants are the
// TPU kernel's: per chunk, the masked intra-chunk product
// (C B^T * exp(clip(cum_i - cum_j)) * dt_j, i >= j) @ x, the incoming
// state's contribution (C @ h) * exp(clip(cum_i)), and the state update
// h <- h exp(clip(cum_last)) + sum_j exp(clip(cum_last - cum_j)) dt_j
// outer(B_j, x_j), with cum the inclusive in-chunk sum of dt A and every
// exponent clipped to [-60, 0]. Everything is f32 on the CUDA cores; y is
// rounded to its dtype once. The plain version is
// repro_torch/kernels/ref.py:ssd_scan_ref (step by step).
//
// Design. On the TPU the state sits in VMEM across a sequential grid axis
// over chunks; here one block of 256 threads owns one head and a loop over
// chunks inside the block takes that axis's place, the (N, P) f32 state in
// shared memory throughout. The chunk is the kernel's own, 64 steps (the
// TPU kernel takes the model's 256): at N = 128 a 256-step chunk would need
// B and C tiles of 128 KB each plus a 256 KB score matrix, beyond the
// 227 KB a block may use; the result does not depend on the chunk up to
// rounding. Per chunk the x, B, C and dt tiles are widened to f32 in shared
// memory (steps past S load as dt = 0 and x = B = C = 0: identity steps,
// so a ragged S needs no padded copy); warp 0 takes the in-chunk cumsum as
// a shuffle scan; thread (ty, tx) of a 16 x 16 grid then computes rows
// ty + 16 i, columns tx + 16 j of the 64 x 64 masked score tile, of
// C @ h and of M @ x, and rows ty + 16 i of the state update. No tensor
// cores, TMA or pipelining yet: simple and right first.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at mamba2-370m's
// prefill, BH = 8 x 32, S = 2048, P = 64, N = 128, bf16: x and y (67.1 MB
// each), B and C (134.2 MB each), dt (2.1 MB) and the f32 state (8.4 MB)
// move 413.1 MB, 123.3 us; the 64-step chunks need 30.1 G operations
// (30.4 us; 68.7 G at the TPU kernel's 256-step chunk, 69.5 us). Bound by
// bytes. At zamba2-2.7b's, BH = 8 x 80, S = 1024, N = 64: 348.7 MB, 104.1 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;          // chunk length; 16 x 16 threads, 4 rows each
constexpr int kThreads = 256;
constexpr int kMaxN = 128;
constexpr int kLdM = kL + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// exp of an exponent clipped to [-60, 0], as the TPU kernel (expf, not
// the fast __expf)
__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.0f), 0.0f));
}

// B and C (kL x n+1), x (kL x P), the score tile (kL x kL+1), the state
// (n x P), dt and cum (kL each), all f32
size_t smem_bytes(int n, int p) {
  return sizeof(float) * ((size_t)2 * kL * (n + 1) + (size_t)kL * p +
                          (size_t)kL * kLdM + (size_t)n * p + 2 * kL);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ B,
                    const T* __restrict__ C, T* __restrict__ y,
                    float* __restrict__ hfin, int s, int n) {
  static_assert(P % 16 == 0, "16 columns of threads cover P");
  constexpr int kCols = P / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ldbc = n + 1;
  float* bs = smem;
  float* cs = bs + kL * ldbc;
  float* xs = cs + kL * ldbc;
  float* ms = xs + kL * P;
  float* st = ms + kL * kLdM;
  float* dts = st + n * P;
  float* cum = dts + kL;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t bh = blockIdx.x;
  const T* xb = x + bh * (size_t)s * P;
  const float* dtb = dt + bh * (size_t)s;
  const T* bb = B + bh * (size_t)s * n;
  const T* cb = C + bh * (size_t)s * n;
  T* yb = y + bh * (size_t)s * P;
  const float a = A[bh];

  for (int i = tid; i < n * P; i += kThreads) st[i] = 0.0f;

  const int nc = (s + kL - 1) / kL;
  for (int ck = 0; ck < nc; ++ck) {
    const size_t t0 = (size_t)ck * kL;
    const int len = min(kL, s - (int)t0);
    __syncthreads();  // the previous chunk's state update is done
    for (int i = tid; i < kL * P; i += kThreads) {
      xs[i] = i / P < len ? to_f32(xb[t0 * P + i]) : 0.0f;
    }
    for (int i = tid; i < kL * n; i += kThreads) {
      const int r = i / n, c = i % n;
      const bool in = r < len;
      bs[r * ldbc + c] = in ? to_f32(bb[t0 * n + i]) : 0.0f;
      cs[r * ldbc + c] = in ? to_f32(cb[t0 * n + i]) : 0.0f;
    }
    if (tid < kL) dts[tid] = tid < len ? dtb[t0 + tid] : 0.0f;
    __syncthreads();

    // inclusive cumsum of dt A over the chunk: warp 0, two steps a lane
    if (tid < 32) {
      const float d0 = dts[2 * tid] * a, d1 = dts[2 * tid + 1] * a;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      cum[2 * tid] = excl + d0;
      cum[2 * tid + 1] = (excl + d0) + d1;
    }
    __syncthreads();

    // masked, decayed scores: ms[i][j] = (C_i . B_j) exp(clip(cum_i -
    // cum_j)) dt_j for i >= j, else 0
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      }
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldbc + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ldbc + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          ms[r * kLdM + c] =
              r >= c ? sc[i][j] * clip_exp(cum[r] - cum[c]) * dts[c] : 0.0f;
        }
      }
    }

    // the incoming state's contribution: (C @ h) exp(clip(cum_i))
    float yo[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) yo[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      float cv[4], sv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldbc + k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) sv[j] = st[k * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) yo[i][j] = fmaf(cv[i], sv[j], yo[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float din = clip_exp(cum[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) yo[i][j] *= din;
    }
    __syncthreads();  // the score tile is complete; the state is read

    // the intra-chunk product M @ x, then y = intra + inter
    {
      float yi[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) yi[i][j] = 0.0f;
      }
#pragma unroll 4
      for (int c = 0; c < kL; ++c) {
        float mv[4], xv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ms[(ty + 16 * i) * kLdM + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) xv[j] = xs[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < len) {
          T* yrow = yb + (t0 + r) * P;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            store(yrow + tx + 16 * j, yi[i][j] + yo[i][j]);
          }
        }
      }
    }

    // B rows weighted for the state update: B_j exp(clip(cum_last - cum_j))
    // dt_j (the scores are done with B)
    const float cum_last = cum[kL - 1];
    for (int i = tid; i < kL * n; i += kThreads) {
      const int r = i / n, c = i % n;
      bs[r * ldbc + c] *= clip_exp(cum_last - cum[r]) * dts[r];
    }
    __syncthreads();

    // h <- h exp(clip(cum_last)) + sum_j Bw_j^T x_j: each thread owns rows
    // ty + 16 i (four at a time) and columns tx + 16 j of the state
    const float chunk_decay = clip_exp(cum_last);
    for (int r0 = 0; r0 < n; r0 += 64) {
      float su[4][kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) su[i][j] = 0.0f;
      }
#pragma unroll 4
      for (int c = 0; c < kL; ++c) {
        float bv[4], xv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ty + 16 * i;
          bv[i] = row < n ? bs[c * ldbc + row] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) xv[j] = xs[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) su[i][j] = fmaf(bv[i], xv[j], su[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        if (row < n) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            float* h = st + row * P + tx + 16 * j;
            *h = *h * chunk_decay + su[i][j];
          }
        }
      }
    }
  }
  __syncthreads();
  float* hb = hfin + bh * (size_t)n * P;
  for (int i = tid; i < n * P; i += kThreads) hb[i] = st[i];
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* hfin, int bh, int s, int n,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(n, P);
  auto kernel = ssd_scan_kernel<T, P>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<bh, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)B,
      (const T*)C, (T*)y, (float*)hfin, s, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K4 on `stream`: y (bh, s, p) and h_final (bh, n, p) f32 from x
// (bh, s, p), dt (bh, s) f32, A (bh,) f32, B and C (bh, s, n), all
// contiguous; x, B, C and y of one dtype, 0 float32 or 1 bfloat16. p is 32
// or 64, n in [1, 128]. Returns cudaGetLastError() after the launch (0 on
// success) or cudaErrorInvalidValue for shapes it does not take.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, void* y, void* hfin, int bh,
                    int s, int p, int n, int dtype, void* stream) {
  if (bh < 0 || s < 0 || n < 1 || n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && p == 32)
    return launch<float, 32>(x, dt, A, B, C, y, hfin, bh, s, n, st);
  if (dtype == 0 && p == 64)
    return launch<float, 64>(x, dt, A, B, C, y, hfin, bh, s, n, st);
  if (dtype == 1 && p == 32)
    return launch<bf16, 32>(x, dt, A, B, C, y, hfin, bh, s, n, st);
  if (dtype == 1 && p == 64)
    return launch<bf16, 64>(x, dt, A, B, C, y, hfin, bh, s, n, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
