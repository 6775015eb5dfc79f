// K2: the fused base + LoRA projection y = x @ W + scale * (x @ A) @ B for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py:_kernel (the
// Pallas `lora_matmul`). x (M, K), W (K, N), A (K, r), B (r, N), all of one
// dtype (float32 or bfloat16), r <= 64; y (M, N) in that dtype. As in the
// TPU kernel, x @ W and x @ A accumulate in f32 in one pass over K, and the
// rank-r product with B is an f32 epilogue: (x @ A) never reaches device
// memory; y is rounded once. Ragged M, N and K are masked inside the kernel
// (zero-filled copies, guarded stores; the TPU kernel needs 128-divisible
// shapes, decode calls this one with M = 8). The plain version is
// repro_torch/kernels/ref.py:lora_matmul_ref.
//
// Three variants behind the one entry point:
//
// - bfloat16, M > 64 (prefill): mma.sync m16n8k16 bf16 -> f32 on 128 x 256
//   output tiles, 8 warps of 64 x 64, BK 64, fed by a 3-stage cp.async
//   ring of x, W and A tiles (one __syncthreads a k-step, the next two
//   stages' copies in flight). x and W tiles are XOR-swizzled by 16-byte
//   chunk (chunk ^ row % 8), so ldmatrix is free of bank conflicts; A's
//   rows are padded to r + 8. x @ A (r padded to 16 or 64) rides along as
//   one more n-tile: warp w accumulates its 16 rows 16 w .. 16 w + 15, so
//   the eight warps share it evenly. B's tile arrives with the first stage.
//   Epilogue: the x @ A tile goes to shared memory in f32 and each output
//   is acc (read from registers) + scale * sum_t xa[row, t] B[t, col].
//   Tiles run grouped by 8 along M, so the blocks in flight share W's
//   column tiles in L2. One block an SM (164 KB of shared memory at r <=
//   16, 208 KB at r <= 64; 254 registers, no spills at r <= 16: each
//   thread copies two rows of the W tile, four chunks of each, so one
//   pointer a row serves its copies). Tuned on the card against 128 x 128
//   tiles at two blocks an SM (spills at the 128-register cap), 4 stages,
//   partial unrolling and grouping by 16, all slower. mma.sync rather than
//   wgmma: one warp-level code shape serves any M, N, K and rank, with the
//   same ldmatrix layouts as K3; wgmma's shared-memory descriptors for a
//   transposed (N-major) W are left for later.
// - bfloat16, M <= 64 (decode): a stream of W, so the operands swap: y^T =
//   W^T x^T, with W (ldmatrix.trans of its K x 64 tile) as the 16-row A
//   operand and the M <= 8 .. 64 rows of x as the n dimension (8-row
//   n-tiles), and x @ A likewise as A^T x^T. A block of 4 warps owns 64
//   columns of y and a slice of K; a 4-stage cp.async ring of 64 x 64 W
//   tiles keeps three in flight. K is split over the blocks of one thread
//   block cluster (a power of two up to 8, the portable size, chosen to
//   bring the blocks closest to two an SM); the cluster adds its partial
//   sums in shared memory (distributed shared memory, rank order fixed, so
//   every run gives the same bits: no atomics, no workspace) and fuses the
//   rank-r epilogue, B's tile prefetched with the first stage.
// - float32: full f32 on the CUDA cores (no TF32, which the f32 tolerance
//   excludes): 64 x 64 tiles, 256 threads, a 4 x 4 register micro-tile
//   each, BK = 16; each thread also accumulates its rows' share of x @ A.
//
// Bound on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at llama2-7b's
// q / v projection, K = N = 4096, r = 16, bf16:
// - prefill, M = 8 x 1024 = 8192: 2MKN + 2MKr + 2MrN = 274.9 + 1.07 + 1.07
//   = 277.0 G operations, 280 us; x, W, A, B in and y out move 167.9 MB,
//   50 us. Bound by operations: 280 us.
// - decode, M = 8: 0.55 G operations, 0.6 us; W alone is 33.6 MB and all
//   bytes 33.8 MB, 10.1 us. Bound by bytes: 10.1 us.
// The previous design (wmma, synchronous tile loads, two barriers a
// k-step) took 6,895.6 us at prefill and 245.6 us at decode here (NVIDIA
// H100 80GB HBM3, 700 W; decode timed with W warm in L2 and the host's
// enqueue inside the timing).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kMaxRank = 64;

// 8 elements at `src` into 16 bytes of shared memory, zero past the
// matrix: row_ok says the row exists, cols_left how many of its elements
// from `src` on do. cp.async when `vec` (the base 16-byte aligned, the row
// length % 8 == 0), else element by element (a ragged row pitch). `base` is
// any valid 16-byte aligned address, the source of a zero-byte copy.
__device__ __forceinline__ void copy8p(bf16* dst, const bf16* src,
                                       bool row_ok, int cols_left, bool vec,
                                       const bf16* base) {
  if (vec) {
    const bool ok = row_ok && cols_left > 0;
    tc::cp_async16(dst, ok ? src : base, ok ? 16 : 0);
  } else {
    alignas(16) bf16 e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      e[i] = (row_ok && i < cols_left) ? src[i] : __float2bfloat16(0.0f);
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
  }
}

// Elements [col, col + 8) of row `row` of a row-major (nrows, ncols)
// matrix, as copy8p.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int row,
                                      int col, int nrows, int ncols,
                                      bool vec) {
  copy8p(dst, src + (size_t)row * ncols + col, row < nrows, ncols - col, vec,
         src);
}

// Element offset of (row, col) in a shared tile of `cols` bf16 a row whose
// 16-byte chunks are XOR-swizzled by row % 8 (col a multiple of 8).
template <int kCols>
__device__ __forceinline__ int swz(int row, int col) {
  return row * kCols + ((((col >> 3) ^ row) & 7) | ((col >> 3) & ~7)) * 8;
}

// ---------------------------------------------------------------------------
// bfloat16, M > 64: 128 x 256 tiles, 3-stage cp.async ring
// ---------------------------------------------------------------------------

constexpr int kPBM = 128, kPBN = 256, kPBK = 64, kPStages = 3;
constexpr int kPWarpsN = 4;  // 2 x kPWarpsN warps of 64 x kPWN outputs
constexpr int kPThreads = 64 * kPWarpsN;
constexpr int kPWN = kPBN / kPWarpsN;            // a warp's columns
constexpr int kPNI = kPWN / 8;                   // its n8-tiles
constexpr int kPXaRows = kPBM / (2 * kPWarpsN);  // its rows of x @ A
constexpr int kPGroup = 8;  // tiles grouped along M

template <int RP>  // rank padded to 16 or 64
struct Prefill {
  static constexpr int kLdA = RP + 8;
  static constexpr int kLdXa = RP + 4;
  static constexpr int kX = kPBM * kPBK;   // bf16 elements a stage
  static constexpr int kW = kPBK * kPBN;
  static constexpr int kA = kPBK * kLdA;
  static constexpr int kStage = kX + kW + kA;
  static constexpr size_t kRing = sizeof(bf16) * kStage * kPStages;
  // B's (RP, kPBN) tile after the ring, copied with the first stage
  static constexpr size_t kSmem = kRing + sizeof(bf16) * RP * kPBN;
  static_assert(sizeof(float) * kPBM * kLdXa <= kRing,
                "the epilogue's x @ A tile reuses the ring");
};

template <int RP>
__global__ void __launch_bounds__(kPThreads)
    lora_prefill_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w,
                        const bf16* __restrict__ a,
                        const bf16* __restrict__ b, bf16* __restrict__ y,
                        int m, int n, int k, int r, float scale, int vec_x,
                        int vec_w, int vec_a) {
  using P = Prefill<RP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + P::kRing);  // (RP, kPBN)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kPWarpsN, wn = warp % kPWarpsN;
  const int xa_row0 = warp * kPXaRows;

  // grouped rasterization: kPGroup M tiles walk the N tiles together
  const int num_m = (m + kPBM - 1) / kPBM, num_n = (n + kPBN - 1) / kPBN;
  const int per_group = kPGroup * num_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * kPGroup;
  const int gsize = min(num_m - first_m, kPGroup);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gsize) * kPBM;
  const int n0 = (in_group / gsize) * kPBN;

  // this thread's W chunks: row wr (+ kWRowStep i), column wc (+ 64 j)
  constexpr int kWRowStep = kPThreads / 8;
  const int wr = tid / 8, wc = (tid % 8) * 8;
  auto load_stage = [&](int stage, int kt) {
    bf16* xs = ring + stage * P::kStage;
    bf16* ws = xs + P::kX;
    bf16* as = ws + P::kW;
    const int k0 = kt * kPBK;
#pragma unroll
    for (int i = 0; i < kPBM * kPBK / 8 / kPThreads; ++i) {
      const int idx = tid + i * kPThreads;
      const int row = idx / (kPBK / 8), col = (idx % (kPBK / 8)) * 8;
      copy8(xs + swz<kPBK>(row, col), x, m0 + row, k0 + col, m, k, vec_x);
    }
    // W: rows wr + kWRowStep i, chunks wc / 8 + 8 j of each: one row
    // pointer serves a row's chunks, at constant offsets in both memories
#pragma unroll
    for (int i = 0; i < kPBK / kWRowStep; ++i) {
      const int row = wr + kWRowStep * i;
      const bf16* src = w + (size_t)(k0 + row) * n + n0 + wc;
      bf16* dst = ws + swz<kPBN>(row, wc);
#pragma unroll
      for (int j = 0; j < kPBN / 64; ++j) {
        copy8p(dst + 64 * j, src + 64 * j, k0 + row < k, n - (n0 + wc) - 64 * j,
               vec_w, w);
      }
    }
    for (int idx = tid; idx < kPBK * RP / 8; idx += kPThreads) {
      const int row = idx / (RP / 8), col = (idx % (RP / 8)) * 8;
      copy8(as + row * P::kLdA + col, a, k0 + row, col, k, r, vec_a);
    }
  };

  float acc[4][kPNI][4];
  float xacc[kPXaRows / 16][RP / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kPNI; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kPXaRows / 16; ++i) {
#pragma unroll
    for (int j = 0; j < RP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[i][j][e] = 0.0f;
    }
  }

  // B's tile rides with the first stage (zero past r and n)
  const bool vec_b = vec_w && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  for (int idx = tid; idx < RP * kPBN / 8; idx += kPThreads) {
    const int row = idx / (kPBN / 8), col = (idx % (kPBN / 8)) * 8;
    copy8(bs + row * kPBN + col, b, row, n0 + col, r, n, vec_b);
  }
  const int nk = (k + kPBK - 1) / kPBK;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0, stage = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kPStages - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread; tile kt - 1 is consumed
    // tile kt + kPStages - 1 goes where tile kt - 1 was
    const int next = kt + kPStages - 1;
    if (next < nk) load_stage(stage == 0 ? kPStages - 1 : stage - 1, next);
    tc::cp_async_commit();

    const bf16* xs = ring + stage * P::kStage;
    stage = stage == kPStages - 1 ? 0 : stage + 1;
    const bf16* ws = xs + P::kX;
    const bf16* as = ws + P::kW;
#pragma unroll
    for (int kk = 0; kk < kPBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        tc::ldmatrix_x4(af[mi], xs + swz<kPBK>(wm * 64 + mi * 16 + (lane & 15),
                                               kk + (lane >> 4) * 8));
      }
      const int brow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < kPNI / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(
            bf, ws + swz<kPBN>(brow, wn * kPWN + np * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          tc::mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          tc::mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
      // x @ A for this warp's kPXaRows rows
#pragma unroll
      for (int xm = 0; xm < kPXaRows / 16; ++xm) {
        uint32_t xf[4];
        tc::ldmatrix_x4(xf, xs + swz<kPBK>(xa_row0 + xm * 16 + (lane & 15),
                                           kk + (lane >> 4) * 8));
#pragma unroll
        for (int rq = 0; rq < RP / 16; ++rq) {
          uint32_t bf[4];
          tc::ldmatrix_x4_trans(
              bf, as + brow * P::kLdA + rq * 16 + (lane >> 4) * 8);
          tc::mma_bf16(xacc[xm][2 * rq], xf, bf[0], bf[1]);
          tc::mma_bf16(xacc[xm][2 * rq + 1], xf, bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // ---- epilogue: y = acc + scale * (x @ A) @ B, in f32 ----
  float* xa_s = reinterpret_cast<float*>(smem);  // (128, RP + 4)
#pragma unroll
  for (int xm = 0; xm < kPXaRows / 16; ++xm) {
#pragma unroll
    for (int j = 0; j < RP / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = xa_s + (xa_row0 + xm * 16 + g + 8 * h) * P::kLdXa +
                     j * 8 + 2 * t;
        dst[0] = xacc[xm][j][2 * h];
        dst[1] = xacc[xm][j][2 * h + 1];
      }
    }
  }
  __syncthreads();

  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 64 + mi * 16 + g + 8 * h;
      const int grow = m0 + row;
      float d[kPNI][2] = {};
      for (int tt = 0; tt < r; ++tt) {
        const float xv = xa_s[row * P::kLdXa + tt];
#pragma unroll
        for (int ni = 0; ni < kPNI; ++ni) {
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  bs + tt * kPBN + wn * kPWN + ni * 8 + 2 * t));
          d[ni][0] += xv * bv.x;
          d[ni][1] += xv * bv.y;
        }
      }
      if (grow >= m) continue;
#pragma unroll
      for (int ni = 0; ni < kPNI; ++ni) {
        const int gcol = n0 + wn * kPWN + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h] + scale * d[ni][0];
        const float v1 = acc[mi][ni][2 * h + 1] + scale * d[ni][1];
        bf16* out = y + (size_t)grow * n + gcol;
        if (pairs && gcol + 1 < n) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (gcol < n) out[0] = __float2bfloat16(v0);
          if (gcol + 1 < n) out[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, M <= 64: y^T = W^T x^T, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kDBN = 64, kDBK = 64, kDStages = 4;
constexpr int kDThreads = 2 * kDBN;  // warps of 16 columns of y
constexpr int kMaxSplit = 8;    // the portable cluster size

template <int MT, int RP>  // M <= 8 MT rows; rank padded to 16 or 64
struct Decode {
  static constexpr int kRows = 8 * MT;
  static constexpr int kLdA = RP + 8;
  static constexpr int kLdPart = kDBN + 4;
  static constexpr int kLdXa = RP + 4;
  static constexpr int kX = kRows * kDBK;  // bf16 elements a stage
  static constexpr int kW = kDBK * kDBN;
  static constexpr int kA = kDBK * kLdA;
  static constexpr int kStage = kX + kW + kA;
  static constexpr size_t kRing = sizeof(bf16) * kStage * kDStages;
  // B's (RP, kDBN) tile after the ring, copied with the first stage
  static constexpr size_t kSmem = kRing + sizeof(bf16) * RP * kDBN;
  static_assert(sizeof(float) * kRows * (kLdPart + 2 * kLdXa) <= kRing,
                "the epilogue's partial sums reuse the ring");
};

template <int MT, int RP>
__global__ void __launch_bounds__(kDThreads)
    lora_decode_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ w,
                       const bf16* __restrict__ a,
                       const bf16* __restrict__ b, bf16* __restrict__ y,
                       int m, int n, int k, int r, float scale, int vec_x,
                       int vec_w, int vec_a) {
  using P = Decode<MT, RP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + P::kRing);  // (RP, kDBN)
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDBN;
  // the cluster spans grid.y: rank q takes k-tiles [q nkt / ks, ...)
  const int ks = gridDim.y, rank = blockIdx.y;
  const int nkt = (k + kDBK - 1) / kDBK;
  const int kt0 = rank * nkt / ks, kt1 = (rank + 1) * nkt / ks;

  auto load_stage = [&](int stage, int kt) {
    bf16* xs = ring + stage * P::kStage;
    bf16* ws = xs + P::kX;
    bf16* as = ws + P::kW;
    const int k0 = kt * kDBK;
    for (int idx = tid; idx < P::kRows * kDBK / 8; idx += kDThreads) {
      const int row = idx / (kDBK / 8), col = (idx % (kDBK / 8)) * 8;
      copy8(xs + swz<kDBK>(row, col), x, row, k0 + col, m, k, vec_x);
    }
#pragma unroll
    for (int i = 0; i < kDBK * kDBN / 8 / kDThreads; ++i) {
      const int idx = tid + i * kDThreads;
      const int row = idx / (kDBN / 8), col = (idx % (kDBN / 8)) * 8;
      copy8(ws + swz<kDBN>(row, col), w, k0 + row, n0 + col, k, n, vec_w);
    }
    for (int idx = tid; idx < kDBK * RP / 8; idx += kDThreads) {
      const int row = idx / (RP / 8), col = (idx % (RP / 8)) * 8;
      copy8(as + row * P::kLdA + col, a, k0 + row, col, k, r, vec_a);
    }
  };

  float acc[MT][4], xacc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = xacc[i][e] = 0.0f;
  }
  const bool rank_warp = warp < RP / 16;  // warp owns x @ A columns 16 warp..

  // B's tile rides with the first stage (zero past r and n)
  const bool vec_b = vec_w && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  for (int idx = tid; idx < RP * kDBN / 8; idx += kDThreads) {
    const int row = idx / (kDBN / 8), col = (idx % (kDBN / 8)) * 8;
    copy8(bs + row * kDBN + col, b, row, n0 + col, r, n, vec_b);
  }
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (kt0 + s < kt1) load_stage(s, kt0 + s);
    tc::cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    tc::cp_async_wait<kDStages - 2>();
    __syncthreads();
    if (kt + kDStages - 1 < kt1)
      load_stage((i + kDStages - 1) % kDStages, kt + kDStages - 1);
    tc::cp_async_commit();

    const bf16* xs = ring + (i % kDStages) * P::kStage;
    const bf16* ws = xs + P::kX;
    const bf16* as = ws + P::kW;
#pragma unroll
    for (int kk = 0; kk < kDBK; kk += 16) {
      // A operand: W^T rows n0 + 16 warp .. + 15 by k kk .. kk + 15
      const int arow = kk + (lane & 7) + ((lane >> 4) & 1) * 8;
      const int acol = warp * 16 + ((lane >> 3) & 1) * 8;
      uint32_t wf[4], af[4];
      tc::ldmatrix_x4_trans(wf, ws + swz<kDBN>(arow, acol));
      if (rank_warp) tc::ldmatrix_x4_trans(af, as + arow * P::kLdA + acol);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t xf[2];
        tc::ldmatrix_x2(xf, xs + swz<kDBK>(mt * 8 + (lane & 7),
                                           kk + ((lane >> 3) & 1) * 8));
        tc::mma_bf16(acc[mt], wf, xf[0], xf[1]);
        if (rank_warp) tc::mma_bf16(xacc[mt], af, xf[0], xf[1]);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // ---- partial sums to shared memory: (rows of x, columns of y) ----
  float* part = reinterpret_cast<float*>(smem);  // (kRows, 64 + 4)
  float* xa_part = part + P::kRows * P::kLdPart; // (kRows, RP + 4)
  float* xa_tot = xa_part + P::kRows * P::kLdXa; // (kRows, RP + 4)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // c_e: (column 16 warp + g + 8 (e / 2), row 8 mt + 2 t + e % 2)
      const int row = mt * 8 + 2 * t + (e & 1);
      const int col = warp * 16 + g + 8 * (e >> 1);
      part[row * P::kLdPart + col] = acc[mt][e];
      if (rank_warp) xa_part[row * P::kLdXa + col] = xacc[mt][e];
    }
  }
  cluster.sync();

  // x @ A over the whole of K: the ranks' partial sums in rank order
  // (loops unrolled to the cluster's limit, so the remote loads overlap)
  for (int idx = tid; idx < P::kRows * RP; idx += kDThreads) {
    const int at = (idx / RP) * P::kLdXa + idx % RP;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < ks) sum += cluster.map_shared_rank(xa_part, q)[at];
    }
    xa_tot[at] = sum;
  }
  __syncthreads();

  // this rank's share of the block's columns: y = sum of the ranks' x @ W
  // + scale * (x @ A) @ B
  const int cols = kDBN / ks, c0 = rank * cols;
  for (int idx = tid; idx < P::kRows * cols; idx += kDThreads) {
    const int row = idx / cols, col = c0 + idx % cols, gcol = n0 + col;
    if (row >= m || gcol >= n) continue;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q) {
      if (q < ks)
        sum += cluster.map_shared_rank(part, q)[row * P::kLdPart + col];
    }
    float d = 0.0f;
#pragma unroll
    for (int tt = 0; tt < RP; ++tt) {
      if (tt < r)
        d += xa_tot[row * P::kLdXa + tt] *
             __bfloat162float(bs[tt * kDBN + col]);
    }
    y[(size_t)row * n + gcol] = __float2bfloat16(sum + scale * d);
  }
  cluster.sync();  // no block leaves while the cluster reads its memory
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


// Lets `kernel` take `smem` bytes of dynamic shared memory. Each launcher
// calls it once (a function-local static), so no launch inside a CUDA
// graph capture sets a function attribute.
int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Bf16Args {
  const bf16 *x, *w, *a, *b;
  bf16* y;
  int m, n, k, r;
  float scale;
  int vec_x, vec_w, vec_a;
};

template <int RP>
int launch_prefill(const Bf16Args& p, cudaStream_t stream) {
  auto kernel = lora_prefill_kernel<RP>;
  const size_t smem = Prefill<RP>::kSmem;
  static const int smem_rc = set_smem((const void*)kernel, smem);
  if (smem_rc) return smem_rc;
  const long tiles =
      (long)((p.m + kPBM - 1) / kPBM) * ((p.n + kPBN - 1) / kPBN);
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kPThreads, smem, stream>>>(
      p.x, p.w, p.a, p.b, p.y, p.m, p.n, p.k, p.r, p.scale, p.vec_x,
      p.vec_w, p.vec_a);
  return (int)cudaGetLastError();
}

// The K split of the decode path: the power of two (up to the cluster
// limit) that brings the blocks closest to two an SM, as long as every rank
// keeps at least two k-tiles.
int decode_splits(int n, int k) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int blocks = (n + kDBN - 1) / kDBN;
  const int nkt = (k + kDBK - 1) / kDBK;
  int ks = 1;
  const int target = 2 * sms;
  while (ks < kMaxSplit && nkt >= 4 * ks &&
         abs(2 * blocks * ks - target) < abs(blocks * ks - target))
    ks *= 2;
  return ks;
}

template <int MT, int RP>
int launch_decode(const Bf16Args& p, cudaStream_t stream) {
  auto kernel = lora_decode_kernel<MT, RP>;
  const size_t smem = Decode<MT, RP>::kSmem;
  static const int smem_rc = set_smem((const void*)kernel, smem);
  if (smem_rc) return smem_rc;
  const int ks = decode_splits(p.n, p.k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + kDBN - 1) / kDBN, ks);
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, p.x, p.w, p.a, p.b, p.y, p.m, p.n, p.k, p.r, p.scale,
      p.vec_x, p.vec_w, p.vec_a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int RP>
int launch_bf16(const Bf16Args& p, cudaStream_t stream) {
  if (p.m > 64) return launch_prefill<RP>(p, stream);
  if (p.m > 32) return launch_decode<8, RP>(p, stream);
  if (p.m > 16) return launch_decode<4, RP>(p, stream);
  if (p.m > 8) return launch_decode<2, RP>(p, stream);
  return launch_decode<1, RP>(p, stream);
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if ((m + kFBM - 1) / kFBM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + kFBN - 1) / kFBN, (m + kFBM - 1) / kFBM);
    lora_f32_kernel<<<grid, kFThreads, 0, s>>>(
        (const float*)x, (const float*)w, (const float*)a, (const float*)b,
        (float*)y, m, n, k, r, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    auto aligned = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    };
    const Bf16Args p = {(const bf16*)x, (const bf16*)w, (const bf16*)a,
                        (const bf16*)b, (bf16*)y, m, n, k, r, scale,
                        aligned(x) && k % 8 == 0, aligned(w) && n % 8 == 0,
                        aligned(a) && r % 8 == 0};
    return r <= 16 ? launch_bf16<16>(p, s) : launch_bf16<64>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* lora_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
