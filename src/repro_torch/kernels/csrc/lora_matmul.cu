// K2: the fused base + LoRA projection y = x @ W + scale * (x @ A) @ B for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py:_kernel (the
// Pallas `lora_matmul`). x (M, K), W (K, N), A (K, r), B (r, N), all of one
// dtype (float32 or bfloat16), r <= 64; y (M, N) in that dtype. As in the
// TPU kernel, x @ W and x @ A accumulate in f32 in one pass over K, and the
// rank-r product with B is an f32 epilogue: (x @ A) never reaches device
// memory. The plain version is repro_torch/kernels/ref.py:lora_matmul_ref.
//
// Design. One block per output tile; a loop over K stages the x, W and A
// tiles through shared memory (zero-filled past the edges, so ragged M, N
// and K are masked; the TPU kernel needs 128-divisible shapes, decode calls
// this one with M = 8).
// - bfloat16: nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators.
//   Tiles of 128 x 128 (8 warps, 32 x 64 each, BK = 32) for M > 64, and of
//   16 x 32 (2 warps, BK = 64) for the decode-sized M <= 64, which puts 128
//   blocks on the card for N = 4096. The block's first column of warps
//   also accumulates x @ A (bm x r, r padded to 16) in wmma fragments.
// - float32: full f32 on the CUDA cores (no TF32): 64 x 64 tiles, 256
//   threads, a 4 x 4 register micro-tile each, BK = 16; each thread also
//   accumulates its rows' share of x @ A.
// Epilogue: (x @ A) for the tile (bm x r) goes to shared memory in f32, the
// B tile (r x bn) is widened to f32 beside it, and each output takes
// acc + scale * sum_t xa[row, t] * B[t, col] in f32 before one rounding to
// the output dtype. No pipelining, TMA or wgmma yet: simple and right first.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at llama2-7b's
// q / v projection, K = N = 4096, r = 16, bf16:
// - prefill, M = 8 x 1024 = 8192: 2MKN + 2MKr + 2MrN = 274.9 + 1.07 + 1.07
//   = 277.0 G operations, 280 us; x, W, A, B in and y out move 167.9 MB,
//   50 us. Bound by operations: 280 us.
// - decode, M = 8: 0.55 G operations, 0.6 us; W alone is 33.6 MB and all
//   bytes 33.8 MB, 10.1 us. Bound by bytes: 10.1 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kMaxRank = 64;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// ---------------------------------------------------------------------------
// Tile loads: rows x cols elements from a row-major (nrows, ncols) matrix
// with leading dimension ld into shared memory (ld_s), zero past the edges.
// ---------------------------------------------------------------------------

template <int kThreads>
__device__ void load_tile_bf16(bf16* dst, int ld_s, const bf16* src, int ld,
                               int row0, int col0, int rows, int cols,
                               int nrows, int ncols, bool vec_ok) {
  const int vecs = cols / 8;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int c = (idx % vecs) * 8;
    const int gr = row0 + r, gc = col0 + c;
    bf16* d = dst + r * ld_s + c;
    if (vec_ok && gr < nrows && gc + 8 <= ncols) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < nrows && gc + e < ncols)
                   ? src[(size_t)gr * ld + gc + e]
                   : __float2bfloat16(0.0f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wmma tiles
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, int WM, int WN>
struct Bf16Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpRows = BM / WM;
  static constexpr int kWarpCols = BN / WN;
  static constexpr int kFragM = kWarpRows / 16;
  static constexpr int kFragN = kWarpCols / 16;
  static constexpr int kLdX = BK + 8;          // bf16 elements
  static constexpr int kLdW = BN + 8;
  static constexpr int kLdA = kMaxRank + 8;
  static_assert(kWarpRows % 16 == 0 && kWarpCols % 16 == 0, "warp tile");
  static_assert(BK % 16 == 0, "BK");

  // shared-memory layout for rank padded to rp (a multiple of 16)
  __host__ __device__ static size_t off_w() {
    return align128(sizeof(bf16) * BM * kLdX);
  }
  __host__ __device__ static size_t off_a() {
    return off_w() + align128(sizeof(bf16) * BK * kLdW);
  }
  __host__ __device__ static size_t off_xa() {
    return off_a() + align128(sizeof(bf16) * BK * kLdA);
  }
  __host__ __device__ static size_t off_b(int rp) {
    return off_xa() + align128(sizeof(float) * BM * (rp + 4));
  }
  __host__ __device__ static size_t off_scratch(int rp) {
    return off_b(rp) + align128(sizeof(float) * rp * BN);
  }
  __host__ __device__ static size_t smem_bytes(int rp) {
    return off_scratch(rp) + sizeof(float) * 256 * WM * WN;
  }
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
    lora_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ a, const bf16* __restrict__ b,
                     bf16* __restrict__ y, int m, int n, int k, int r,
                     float scale, int vec_x, int vec_w, int vec_a) {
  using Tile = Bf16Tile<BM, BN, BK, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rp = (r + 15) & ~15;
  const int ldxa = rp + 4;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + Tile::off_w());
  bf16* as = reinterpret_cast<bf16*>(smem + Tile::off_a());
  float* xa_s = reinterpret_cast<float*>(smem + Tile::off_xa());
  float* bs = reinterpret_cast<float*>(smem + Tile::off_b(rp));
  float* scratch = reinterpret_cast<float*>(smem + Tile::off_scratch(rp));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int rp16 = rp / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[Tile::kFragM][Tile::kFragN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      xacc[Tile::kFragM][kMaxRank / 16];
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int j = 0; j < kMaxRank / 16; ++j)
      wmma::fill_fragment(xacc[i][j], 0.f);
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    load_tile_bf16<Tile::kThreads>(xs, Tile::kLdX, x, k, m0, k0, BM, BK, m,
                                   k, vec_x);
    load_tile_bf16<Tile::kThreads>(ws, Tile::kLdW, w, n, k0, n0, BK, BN, k,
                                   n, vec_w);
    load_tile_bf16<Tile::kThreads>(as, Tile::kLdA, a, r, k0, 0, BK, rp, k,
                                   r, vec_a);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[Tile::kFragM];
#pragma unroll
      for (int i = 0; i < Tile::kFragM; ++i) {
        wmma::load_matrix_sync(
            fa[i], xs + (wm * Tile::kWarpRows + i * 16) * Tile::kLdX + kk,
            Tile::kLdX);
      }
#pragma unroll
      for (int j = 0; j < Tile::kFragN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(
            fb, ws + kk * Tile::kLdW + wn * Tile::kWarpCols + j * 16,
            Tile::kLdW);
#pragma unroll
        for (int i = 0; i < Tile::kFragM; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
      if (wn == 0) {
#pragma unroll
        for (int j = 0; j < kMaxRank / 16; ++j) {
          if (j < rp16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                fb;
            wmma::load_matrix_sync(fb, as + kk * Tile::kLdA + j * 16,
                                   Tile::kLdA);
#pragma unroll
            for (int i = 0; i < Tile::kFragM; ++i)
              wmma::mma_sync(xacc[i][j], fa[i], fb, xacc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: (x @ A) and B in f32, y = acc + scale * xa @ B ----
  if (wn == 0) {
#pragma unroll
    for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
      for (int j = 0; j < kMaxRank / 16; ++j) {
        if (j < rp16) {
          wmma::store_matrix_sync(
              xa_s + (wm * Tile::kWarpRows + i * 16) * ldxa + j * 16,
              xacc[i][j], ldxa, wmma::mem_row_major);
        }
      }
    }
  }
  for (int idx = threadIdx.x; idx < r * BN; idx += Tile::kThreads) {
    const int t = idx / BN, c = idx % BN;
    bs[idx] = (n0 + c < n) ? __bfloat162float(b[(size_t)t * n + n0 + c])
                           : 0.0f;
  }
  __syncthreads();

  float* scr = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < Tile::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < Tile::kFragN; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int lrow = wm * Tile::kWarpRows + i * 16 + (e >> 4);
        const int lcol = wn * Tile::kWarpCols + j * 16 + (e & 15);
        const int grow = m0 + lrow, gcol = n0 + lcol;
        if (grow < m && gcol < n) {
          float d = 0.0f;
          for (int t = 0; t < r; ++t) d += xa_s[lrow * ldxa + t] * bs[t * BN + lcol];
          y[(size_t)grow * n + gcol] = __float2bfloat16(scr[e] + scale * d);
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core tiles, full f32
// ---------------------------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    lora_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ y, int m, int n, int k, int r,
                    float scale) {
  __shared__ float xs[kFBK][kFBM + 4];  // transposed: xs[kk][row]
  __shared__ float ws[kFBK][kFBN];
  __shared__ float as[kFBK][kMaxRank];
  __shared__ float xa_s[kFBM][kMaxRank + 1];
  __shared__ float bs[kMaxRank][kFBN];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;

  float acc[4][4] = {};
  float xacc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int idx = tid; idx < kFBM * kFBK; idx += kFThreads) {
      const int row = idx / kFBK, kk = idx % kFBK;
      const int gr = m0 + row, gk = k0 + kk;
      xs[kk][row] = (gr < m && gk < k) ? x[(size_t)gr * k + gk] : 0.0f;
    }
    for (int idx = tid; idx < kFBK * kFBN; idx += kFThreads) {
      const int kk = idx / kFBN, c = idx % kFBN;
      const int gk = k0 + kk, gc = n0 + c;
      ws[kk][c] = (gk < k && gc < n) ? w[(size_t)gk * n + gc] : 0.0f;
    }
    for (int idx = tid; idx < kFBK * kMaxRank; idx += kFThreads) {
      const int kk = idx / kMaxRank, c = idx % kMaxRank;
      const int gk = k0 + kk;
      as[kk][c] = (gk < k && c < r) ? a[(size_t)gk * r + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float xv[4], wv[4], av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wv[j] = ws[kk][tx + 16 * j];
        av[j] = as[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
          xacc[i][j] = fmaf(xv[i], av[j], xacc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) xa_s[ty + 16 * i][tx + 16 * j] = xacc[i][j];
  }
  for (int idx = tid; idx < r * kFBN; idx += kFThreads) {
    const int t = idx / kFBN, c = idx % kFBN;
    bs[t][c] = (n0 + c < n) ? b[(size_t)t * n + n0 + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int grow = m0 + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int gcol = n0 + col;
      if (grow < m && gcol < n) {
        float d = 0.0f;
        for (int t = 0; t < r; ++t) d += xa_s[row][t] * bs[t][col];
        y[(size_t)grow * n + gcol] = acc[i][j] + scale * d;
      }
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN>
int launch_bf16(const void* x, const void* w, const void* a, const void* b,
                void* y, int m, int n, int k, int r, float scale,
                cudaStream_t stream) {
  using Tile = Bf16Tile<BM, BN, BK, WM, WN>;
  const int rp = (r + 15) & ~15;
  const size_t smem = Tile::smem_bytes(rp);
  auto kernel = lora_bf16_kernel<BM, BN, BK, WM, WN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = aligned(x) && k % 8 == 0;
  const int vec_w = aligned(w) && n % 8 == 0;
  const int vec_a = aligned(a) && r % 8 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, Tile::kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)a, (const bf16*)b,
      (bf16*)y, m, n, k, r, scale, vec_x, vec_w, vec_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K2 on `stream`: y (m, n) = x (m, k) @ w (k, n)
// + scale * (x @ a (k, r)) @ b (r, n), all row-major and contiguous.
// dtype 0 is float32, 1 is bfloat16. Returns cudaGetLastError() after the
// launch (0 on success) or cudaErrorInvalidValue for shapes it does not
// take.
int lora_matmul_launch(const void* x, const void* w, const void* a,
                       const void* b, void* y, int m, int n, int k, int r,
                       float scale, int dtype, void* stream) {
  if (m < 0 || n < 0 || k < 1 || r < 1 || r > kMaxRank) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || n == 0) return 0;
  if ((m + 15) / 16 > 65535) {  // grid.y
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
    lora_f32_kernel<<<grid, kFThreads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)a, (const float*)b,
        (float*)y, m, n, k, r, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (m <= 64) {
      return launch_bf16<16, 32, 64, 1, 2>(x, w, a, b, y, m, n, k, r, scale,
                                           s);
    }
    return launch_bf16<128, 128, 32, 4, 2>(x, w, a, b, y, m, n, k, r, scale,
                                           s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* lora_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
