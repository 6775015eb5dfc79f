// K4: the Mamba2 SSD chunk scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_kernel (the Pallas
// `ssd_scan`). Per head h of batch row b, with g = h / (H / G) its group:
//   h_t = exp(dt_t A) h_{t-1} + dt_t outer(B_t, x_t),   y_t = C_t . h_t
// for x (Bt, S, H, P) and B, C (Bt, S, G, N) in float32 or bfloat16, read
// in place through their strides (the Mamba2 layer's x, B and C are views
// of one conv output, rows of d_inner + 2 G N elements), dt (Bt, S, H) and
// A f32 (A indexed by (b, h) through two strides); y written to a
// contiguous (Bt, S, H, P) in x's dtype, the final state h_final
// (Bt, H, N, P) f32. The flattened layout of the TPU kernel, x (BH, S, P)
// and B, C (BH, S, N), is the case Bt = BH, H = G = 1 with A's batch stride
// 1. The function and its constants are the TPU kernel's: per chunk, the
// masked intra-chunk product (C B^T * exp(clip(cum_i - cum_j)) * dt_j,
// i >= j) @ x, the incoming state's term (C @ h) * exp(clip(cum_i)), and
// the state update h <- h exp(clip(cum_last)) + sum_j exp(clip(cum_last -
// cum_j)) dt_j outer(B_j, x_j), cum the inclusive in-chunk sum of dt A and
// every exponent clipped to [-60, 0]; f32 state, f32 sums, y rounded to its
// dtype once; steps past S are dt = 0 steps (x, B, C zero), so a ragged S
// needs no padded copy. The plain version is
// repro_torch/kernels/ref.py:ssd_scan_ref (step by step).
//
// On the TPU the state sits in VMEM across a sequential grid axis over
// chunks; here a loop over 64-step chunks inside one block per (b, h) takes
// that axis's place. The chunk is the kernel's own (the TPU kernel takes
// the model's 256); the result does not depend on it up to rounding.
//
// Two variants behind the one entry point:
//
// - bfloat16 (the serving path): the four chunk products on the tensor
//   cores, mma.sync m16n8k16 bf16 with f32 sums. One block of 4 warps per
//   (b, h). The x, B and C tiles of a chunk stay bf16 in shared memory
//   (rows padded by 8 elements: ldmatrix free of bank conflicts) and arrive
//   by 16-byte cp.async straight from the strided rows (columns past N
//   zero-filled by the copy's source size), two stages: chunk c + 1 is in
//   flight while chunk c computes. Per chunk:
//   * M = (C B^T) exp(clip(cum_i - cum_j)) dt_j, masked to i >= j, in the
//     ten 16 x 16 units at or below the diagonal (the rest is zero), dealt
//     3, 3, 2, 2 to the warps and stored to shared memory as hi and lo bf16
//     halves;
//   * warp w owns columns 16w .. 16w + 15 of y and of the (N, P) f32 state
//     (8w .. 8w + 7 at P 32); the state lives in its registers for the
//     whole scan. y = (C h) exp(clip(cum_i)) + M x over all 64 rows: h's B
//     operand comes from those registers (hi and lo halves, transposed
//     8 x 8 by movmatrix), so the state never goes through shared memory,
//     and C h runs before the barrier that completes M;
//   * h <- h exp(clip(cum_last)) + B^T (w x), w_j = exp(clip(cum_last -
//     cum_j)) dt_j applied to x's B-operand fragments in registers (the
//     same fragments M x uses), B^T through ldmatrix.trans.
//   x, B and C are bf16, so C B^T and every bf16 side is exact; the three
//   f32 operands, M, h and w x, each enter as hi + lo bf16 halves (v_hi =
//   bf16(v), v_lo = bf16(v - v_hi)) into one f32 accumulator, about 2^-16
//   relative, at twice those products' operations:
//   tests/test_torch_kernel_numerics.py shows that a single bf16 for any
//   one of the three leaves K4's tolerance (w x: the state's 3e-4; M or h:
//   the bf16 y's one ulp). Exponentials use the hardware's exp2 (about 2
//   ulp; the halves carry 2^-16). The in-chunk cumsum is a shuffle scan
//   that every warp takes for itself; dt for chunk c + 1 is loaded into
//   registers during chunk c. Two __syncthreads a chunk. Shared memory
//   104 KB at N 128, P 64 (two blocks an SM), 72 KB at N 64 (three).
// - float32 (the f32 logit check and tests): f32 on the CUDA cores, as the
//   f32 tolerance excludes TF32 and bf16 halves alike. One block of 256
//   threads per (b, h); the x, B, C and dt tiles widened to f32 in shared
//   memory, the (N, P) state in shared memory; thread (ty, tx) of a
//   16 x 16 grid computes rows ty + 16 i, columns tx + 16 j of the masked
//   score tile, of C h and of M x, and of the state update.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at mamba2-370m's
// prefill (Bt 8, H 32, S 2048, P 64, G 1, N 128, bf16). In the model's own
// layout x and y move 67.1 MB each, B and C 4.2 MB each (one group), dt
// 2.1 MB and the f32 state 8.4 MB: 153.1 MB, 45.7 us. The 64-step chunks
// need 30.1 G operations (30.4 us; 2 L^2 N + 2 L^2 P + 4 L N P a chunk and
// head). Bound by bytes. In the flattened layout (B and C repeated to
// heads by the caller) 413.1 MB, 123.3 us. At zamba2-2.7b's (Bt 8, H 80,
// S 1024, N 64): 183.0 MB, 54.6 us grouped; 348.7 MB, 104.1 us flattened.
// The kernel's own tensor-core work, with the hi / lo halves and the
// masked key tiles skipped, is 45.1 G operations at mamba2's shape (45.6 us
// at the dense peak, which mma.sync does not reach). This design takes
// 225.8 us at mamba2's shape and 189.0 us at zamba2's in the model's
// layout (device time, chip_smoke.py's `[time]`); the previous one, all
// f32 on the CUDA cores over the flattened layout, took 2,477.5 us and
// 1,324.6 us by events (NVIDIA H100 80GB HBM3, 700 W).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;  // chunk length
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

// Where the operands lie: element strides of x (batch, step, head), dt
// (batch, step, head), A (batch, head), B and C (batch, step, group); y
// is contiguous (batch, s, heads, p) and h_final (batch, heads, n, p).
struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* hfin;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sb, a_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int batch, s, heads, groups, n;
};

// exp of an exponent clipped to [-60, 0], as the TPU kernel (expf, not
// the fast __expf)
__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.0f), 0.0f));
}

// The same with the hardware's exp2 (ex2.approx, about 2 ulp): the bf16
// path, whose operands enter the tensor cores as bf16 halves
__device__ __forceinline__ float clip_exp_fast(float v) {
  return exp2f(fminf(fmaxf(v, -60.0f), 0.0f) * 1.4426950408889634f);
}

// The operands of block (b, h): x, dt, B and C at step 0, y's row 0, the
// final state, and A.
template <typename T>
struct Head {
  const T* x;
  const float* dt;
  const T* B;
  const T* C;
  T* y;
  float* hfin;
  float a;
  long long y_ss;  // y's step stride: heads * p

  __device__ Head(const Args& g, int p) {
    const int b = blockIdx.x / g.heads, h = blockIdx.x % g.heads;
    const int grp = h / (g.heads / g.groups);
    x = static_cast<const T*>(g.x) + b * g.x_sb + h * g.x_sh;
    dt = g.dt + b * g.dt_sb + h * g.dt_sh;
    B = static_cast<const T*>(g.B) + b * g.b_sb + grp * g.b_sg;
    C = static_cast<const T*>(g.C) + b * g.c_sb + grp * g.c_sg;
    y_ss = (long long)g.heads * p;
    y = static_cast<T*>(g.y) + (long long)b * g.s * y_ss + (long long)h * p;
    hfin = g.hfin + ((long long)b * g.heads + h) * g.n * p;
    a = g.A[b * g.a_sb + h * g.a_sh];
  }
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 128;  // 4 warps

// NP: N rounded up to a multiple of 16 in {16, 32, 64, 128}
template <int NP, int P>
struct Bf16Tiles {
  static constexpr int kLdX = P + 8;   // x tile (kL x P), bf16
  static constexpr int kLdB = NP + 8;  // B and C tiles (kL x NP), bf16
  static constexpr int kLdM = kL + 8;  // M's hi and lo (kL x kL), bf16
  static constexpr int kStage = kL * kLdX + 2 * kL * kLdB;  // elements
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * (size_t)kStage + 2 * (size_t)kL * kLdM);
};

// Chunk rows [t0, t0 + kL) of x, B and C into one stage by cp.async; rows
// past s and columns past n are zero-filled.
template <int NP, int P>
__device__ __forceinline__ void load_chunk(bf16* stage, const Head<bf16>& hd,
                                           const Args& g, int t0) {
  using Tl = Bf16Tiles<NP, P>;
  bf16* xs = stage;
  bf16* bs = xs + kL * Tl::kLdX;
  bf16* cs = bs + kL * Tl::kLdB;
  constexpr int kXc = P / 8;  // 16-byte chunks of a row
  static_assert(kL * kXc % kBf16Threads == 0, "load_chunk");
#pragma unroll
  for (int k = 0; k < kL * kXc / kBf16Threads; ++k) {
    const int i = threadIdx.x + k * kBf16Threads;
    const int r = i / kXc, c = (i % kXc) * 8;
    const bool ok = t0 + r < g.s;
    tc::cp_async16(xs + r * Tl::kLdX + c,
                   hd.x + (ok ? (t0 + r) * g.x_ss + c : 0), ok ? 16 : 0);
  }
  constexpr int kBc = NP / 8;
  static_assert(kL * kBc % kBf16Threads == 0, "load_chunk");
#pragma unroll
  for (int k = 0; k < kL * kBc / kBf16Threads; ++k) {
    const int i = threadIdx.x + k * kBf16Threads;
    const int r = i / kBc, c = (i % kBc) * 8;
    const int bytes = t0 + r < g.s ? 2 * max(0, min(8, g.n - c)) : 0;
    const long long row = t0 + r;
    tc::cp_async16(bs + r * Tl::kLdB + c,
                   hd.B + (bytes ? row * g.b_ss + c : 0), bytes);
    tc::cp_async16(cs + r * Tl::kLdB + c,
                   hd.C + (bytes ? row * g.c_ss + c : 0), bytes);
  }
}

// v as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = tc::pack_bf16(v0, v1);
  const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = tc::pack_bf16(v0 - __low2float(h2), v1 - __high2float(h2));
}

// cum (or any per-step value) of chunk row r, from the lane that holds
// rows 2 lane and 2 lane + 1 in v0, v1 (every lane of the warp calls it)
__device__ __forceinline__ float row_value(float v0, float v1, int r) {
  const float a = __shfl_sync(kFull, v0, r >> 1);
  const float b = __shfl_sync(kFull, v1, r >> 1);
  return (r & 1) ? b : a;
}

// The 10 (row tile, key tile) pairs of 16 x 16 at or below the chunk's
// diagonal, dealt to the 4 warps as 3, 3, 2, 2: warp w takes w, w + 4, w + 8
__constant__ const int8_t kUnitM[10] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3};
__constant__ const int8_t kUnitK[10] = {0, 0, 1, 0, 1, 2, 0, 1, 2, 3};

template <int NP, int P>
__global__ void __launch_bounds__(kBf16Threads, NP >= 128 ? 2 : 3)
    ssd_scan_bf16_kernel(const Args g) {
  using Tl = Bf16Tiles<NP, P>;
  constexpr int kLdX = Tl::kLdX, kLdB = Tl::kLdB, kLdM = Tl::kLdM;
  constexpr int kMT = kL / 16;   // row tiles of the chunk
  constexpr int kNK = NP / 16;   // k-steps over N; m-tiles of the state
  constexpr int kPW = P / 4;     // y and state columns a warp
  constexpr int kNTW = kPW / 8;  // n-tiles a warp
  static_assert(P == 32 || P == 64, "head dim");
  static_assert(NP % 16 == 0 && NP <= kMaxN, "state size");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  bf16* mhi = tiles + 2 * Tl::kStage;
  bf16* mlo = mhi + kL * kLdM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int col0 = warp * kPW;  // this warp's y and state columns
  const Head<bf16> hd(g, P);

  // this warp's columns of the (N, P) f32 state, in the accumulator layout
  float st[kNK][kNTW][4];
#pragma unroll
  for (int m = 0; m < kNK; ++m) {
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][j][e] = 0.0f;
    }
  }

  const int nc = (g.s + kL - 1) / kL;
  // dt of this lane's steps 2 lane, 2 lane + 1 of the chunk at t0
  auto load_dt = [&](int t0, float& d0, float& d1) {
    const int j = t0 + 2 * lane;
    d0 = j < g.s ? hd.dt[j * g.dt_ss] : 0.0f;
    d1 = j + 1 < g.s ? hd.dt[(j + 1) * g.dt_ss] : 0.0f;
  };
  float dn0, dn1;
  load_dt(0, dn0, dn1);
  load_chunk<NP, P>(tiles, hd, g, 0);
  tc::cp_async_commit();

  for (int ck = 0; ck < nc; ++ck) {
    const int t0 = ck * kL;
    const float dt0 = dn0, dt1 = dn1;
    if (ck + 1 < nc) load_dt(t0 + kL, dn0, dn1);
    tc::cp_async_wait<0>();
    __syncthreads();  // chunk ck's tiles are in place; M of ck - 1 is read
    if (ck + 1 < nc) {
      load_chunk<NP, P>(tiles + ((ck + 1) & 1) * Tl::kStage, hd, g, t0 + kL);
    }
    tc::cp_async_commit();
    const bf16* xs = tiles + (ck & 1) * Tl::kStage;
    const bf16* bs = xs + kL * kLdX;
    const bf16* cs = bs + kL * kLdB;

    // inclusive cumsum of dt A: lane l holds steps 2l and 2l + 1
    const float e0 = dt0 * hd.a, e1 = dt1 * hd.a;
    float incl = e0 + e1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float cum0 = excl + e0, cum1 = cum0 + e1;
    const float cum_last = __shfl_sync(kFull, cum1, 31);

    // M = (C B^T) exp(clip(cum_i - cum_j)) dt_j for i >= j, else 0, in
    // 16 x 16 units at or below the diagonal, to shared memory as hi + lo
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int unit = warp + 4 * u;
      if (unit < 10) {
        const int um = kUnitM[unit], uk = kUnitK[unit];
        float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk) {
          uint32_t a[4], b[4];
          tc::ldmatrix_x4(a, cs + (um * 16 + (lane & 15)) * kLdB + kk * 16 +
                                 (lane >> 4) * 8);
          tc::ldmatrix_x4(b, bs + (uk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      kLdB +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16(sc[0], a, b[0], b[1]);
          tc::mma_bf16(sc[1], a, b[2], b[3]);
        }
        const int ra = um * 16 + gq;  // rows ra, ra + 8
        const float ci_a = row_value(cum0, cum1, ra);
        const float ci_b = row_value(cum0, cum1, ra + 8);
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          const int j0 = uk * 16 + jt * 8 + 2 * t;
          const int src = j0 >> 1;  // the lane holding columns j0, j0 + 1
          const float cj0 = __shfl_sync(kFull, cum0, src);
          const float cj1 = __shfl_sync(kFull, cum1, src);
          const float dj0 = __shfl_sync(kFull, dt0, src);
          const float dj1 = __shfl_sync(kFull, dt1, src);
          float* v = sc[jt];
          v[0] = ra >= j0 ? v[0] * clip_exp_fast(ci_a - cj0) * dj0 : 0.0f;
          v[1] = ra >= j0 + 1 ? v[1] * clip_exp_fast(ci_a - cj1) * dj1 : 0.0f;
          v[2] = ra + 8 >= j0 ? v[2] * clip_exp_fast(ci_b - cj0) * dj0 : 0.0f;
          v[3] = ra + 8 >= j0 + 1 ? v[3] * clip_exp_fast(ci_b - cj1) * dj1
                                  : 0.0f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int off = (ra + 8 * h) * kLdM + j0;
            uint32_t hi, lo;
            split2(v[2 * h], v[2 * h + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(mhi + off) = hi;
            *reinterpret_cast<uint32_t*>(mlo + off) = lo;
          }
        }
      }
    }

    // x's B fragments for this warp's columns, two k-steps an ldmatrix:
    // register q of xf[k2][j] holds steps 32 k2 + 8q + 2t, +1 of column
    // col0 + 8j + gq
    uint32_t xf[kL / 32][kNTW][4];
#pragma unroll
    for (int k2 = 0; k2 < kL / 32; ++k2) {
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        tc::ldmatrix_x4_trans(
            xf[k2][j], xs + (k2 * 32 + (lane & 7) + (lane >> 3) * 8) * kLdX +
                           col0 + j * 8);
      }
    }

    // y = (C h_hi + C h_lo) exp(clip(cum_i)) over all 64 rows and this
    // warp's columns; h's B fragments come from the state registers
    // (accumulator layout, rows n) by an in-register 8 x 8 transpose
    float yacc[kMT][kNTW][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[m][j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kNK; ++kk) {
      uint32_t hh[kNTW][2], hl[kNTW][2];
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi, lo;
          split2(st[kk][j][2 * h], st[kk][j][2 * h + 1], hi, lo);
          hh[j][h] = tc::movmatrix_trans(hi);
          hl[j][h] = tc::movmatrix_trans(lo);
        }
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        uint32_t a[4];
        tc::ldmatrix_x4(a, cs + (m * 16 + (lane & 15)) * kLdB + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kNTW; ++j) {
          tc::mma_bf16(yacc[m][j], a, hh[j][0], hh[j][1]);
          tc::mma_bf16(yacc[m][j], a, hl[j][0], hl[j][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const float din_a = clip_exp_fast(row_value(cum0, cum1, m * 16 + gq));
      const float din_b =
          clip_exp_fast(row_value(cum0, cum1, m * 16 + 8 + gq));
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        yacc[m][j][0] *= din_a;
        yacc[m][j][1] *= din_a;
        yacc[m][j][2] *= din_b;
        yacc[m][j][3] *= din_b;
      }
    }
    __syncthreads();  // M is complete

    // y += M_hi x + M_lo x over key steps at or below the diagonal, then
    // y to device memory
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int kk = 0; kk < kMT; ++kk) {
        if (kk <= m) {
          const int off = (m * 16 + (lane & 15)) * kLdM + kk * 16 +
                          (lane >> 4) * 8;
          uint32_t ah[4], al[4];
          tc::ldmatrix_x4(ah, mhi + off);
          tc::ldmatrix_x4(al, mlo + off);
#pragma unroll
          for (int j = 0; j < kNTW; ++j) {
            const uint32_t b0 = xf[kk >> 1][j][2 * (kk & 1)];
            const uint32_t b1 = xf[kk >> 1][j][2 * (kk & 1) + 1];
            tc::mma_bf16(yacc[m][j], ah, b0, b1);
            tc::mma_bf16(yacc[m][j], al, b0, b1);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t0 + m * 16 + gq + 8 * h;
        if (row < g.s) {
          bf16* yrow = hd.y + row * hd.y_ss + col0 + 2 * t;
#pragma unroll
          for (int j = 0; j < kNTW; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(yrow + j * 8) =
                __floats2bfloat162_rn(yacc[m][j][2 * h],
                                      yacc[m][j][2 * h + 1]);
          }
        }
      }
    }

    // h <- h exp(clip(cum_last)) + B^T (w x), w_j = exp(clip(cum_last -
    // cum_j)) dt_j applied to x's fragments; B^T by ldmatrix.trans
    {
      const float chunk_decay = clip_exp_fast(cum_last);
#pragma unroll
      for (int m = 0; m < kNK; ++m) {
#pragma unroll
        for (int j = 0; j < kNTW; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[m][j][e] *= chunk_decay;
        }
      }
      const float w0 = clip_exp_fast(cum_last - cum0) * dt0;
      const float w1 = clip_exp_fast(cum_last - cum1) * dt1;
#pragma unroll
      for (int k2 = 0; k2 < kL / 32; ++k2) {
        uint32_t xh[kNTW][4], xl[kNTW][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wq0 = __shfl_sync(kFull, w0, 16 * k2 + 4 * q + t);
          const float wq1 = __shfl_sync(kFull, w1, 16 * k2 + 4 * q + t);
#pragma unroll
          for (int j = 0; j < kNTW; ++j) {
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(&xf[k2][j][q]);
            split2(__low2float(v) * wq0, __high2float(v) * wq1, xh[j][q],
                   xl[j][q]);
          }
        }
#pragma unroll
        for (int m = 0; m < kNK; ++m) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t af[4];
            tc::ldmatrix_x4_trans(
                af, bs + ((2 * k2 + ks) * 16 + (lane & 7) + (lane >> 4) * 8) *
                             kLdB +
                        m * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int j = 0; j < kNTW; ++j) {
              tc::mma_bf16(st[m][j], af, xh[j][2 * ks], xh[j][2 * ks + 1]);
              tc::mma_bf16(st[m][j], af, xl[j][2 * ks], xl[j][2 * ks + 1]);
            }
          }
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < kNK; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * 16 + gq + 8 * h;
      if (row < g.n) {
#pragma unroll
        for (int j = 0; j < kNTW; ++j) {
          *reinterpret_cast<float2*>(hd.hfin + row * P + col0 + j * 8 +
                                     2 * t) =
              make_float2(st[m][j][2 * h], st[m][j][2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kLdM = kL + 1;

// B and C (kL x n+1), x (kL x P), the score tile (kL x kL+1), the state
// (n x P), dt and cum (kL each), all f32
size_t f32_smem_bytes(int n, int p) {
  return sizeof(float) * ((size_t)2 * kL * (n + 1) + (size_t)kL * p +
                          (size_t)kL * kLdM + (size_t)n * p + 2 * kL);
}

template <int P>
__global__ void __launch_bounds__(kF32Threads)
    ssd_scan_f32_kernel(const Args g) {
  static_assert(P % 16 == 0, "16 columns of threads cover P");
  constexpr int kCols = P / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem_f[];
  const int n = g.n;
  const int ldbc = n + 1;
  float* bs = smem_f;
  float* cs = bs + kL * ldbc;
  float* xs = cs + kL * ldbc;
  float* ms = xs + kL * P;
  float* st = ms + kL * kLdM;
  float* dts = st + n * P;
  float* cum = dts + kL;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const Head<float> hd(g, P);

  for (int i = tid; i < n * P; i += kF32Threads) st[i] = 0.0f;

  const int nc = (g.s + kL - 1) / kL;
  for (int ck = 0; ck < nc; ++ck) {
    const int t0 = ck * kL;
    const int len = min(kL, g.s - t0);
    __syncthreads();  // the previous chunk's state update is done
    for (int i = tid; i < kL * P; i += kF32Threads) {
      const int r = i / P, c = i % P;
      xs[i] = r < len ? hd.x[(t0 + r) * g.x_ss + c] : 0.0f;
    }
    for (int i = tid; i < kL * n; i += kF32Threads) {
      const int r = i / n, c = i % n;
      const bool in = r < len;
      bs[r * ldbc + c] = in ? hd.B[(t0 + r) * g.b_ss + c] : 0.0f;
      cs[r * ldbc + c] = in ? hd.C[(t0 + r) * g.c_ss + c] : 0.0f;
    }
    if (tid < kL) dts[tid] = tid < len ? hd.dt[(t0 + tid) * g.dt_ss] : 0.0f;
    __syncthreads();

    // inclusive cumsum of dt A over the chunk: warp 0, two steps a lane
    if (tid < 32) {
      const float d0 = dts[2 * tid] * hd.a, d1 = dts[2 * tid + 1] * hd.a;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += u;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
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
          float* yrow = hd.y + (t0 + r) * hd.y_ss;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            yrow[tx + 16 * j] = yi[i][j] + yo[i][j];
          }
        }
      }
    }

    // B rows weighted for the state update: B_j exp(clip(cum_last - cum_j))
    // dt_j (the scores are done with B)
    const float cum_last = cum[kL - 1];
    for (int i = tid; i < kL * n; i += kF32Threads) {
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
  for (int i = tid; i < n * P; i += kF32Threads) hd.hfin[i] = st[i];
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory. Each launcher
// calls it once (a function-local static), so no launch inside a CUDA
// graph capture sets a function attribute.
int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NP, int P>
int launch_bf16(const Args& g, int blocks, cudaStream_t stream) {
  auto kernel = ssd_scan_bf16_kernel<NP, P>;
  const size_t smem = Bf16Tiles<NP, P>::kSmem;
  static const int smem_rc = set_smem((const void*)kernel, smem);
  if (smem_rc) return smem_rc;
  kernel<<<blocks, kBf16Threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int P>
int launch_bf16_p(const Args& g, int blocks, cudaStream_t stream) {
  if (g.n <= 16) return launch_bf16<16, P>(g, blocks, stream);
  if (g.n <= 32) return launch_bf16<32, P>(g, blocks, stream);
  if (g.n <= 64) return launch_bf16<64, P>(g, blocks, stream);
  return launch_bf16<128, P>(g, blocks, stream);
}

template <int P>
int launch_f32(const Args& g, int blocks, cudaStream_t stream) {
  auto kernel = ssd_scan_f32_kernel<P>;
  // the largest state the kernel takes sets the attribute once
  static const int smem_rc =
      set_smem((const void*)kernel, f32_smem_bytes(kMaxN, P));
  if (smem_rc) return smem_rc;
  kernel<<<blocks, kF32Threads, f32_smem_bytes(g.n, P), stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K4 on `stream` for batch x heads blocks: y (batch, s, heads, p)
// contiguous and h_final (batch, heads, n, p) f32 contiguous, from x
// (batch, s, heads, p), dt (batch, s, heads) f32, A f32 indexed (batch,
// head), B and C (batch, s, groups, n), each given by its pointer and
// element strides (the last dimension contiguous). x, B, C and y share one
// dtype, 0 float32 or 1 bfloat16; x's, B's and C's pointers and strides
// are 16-byte aligned. p is 32 or 64, n in [1, 128], heads a multiple of
// groups. Returns cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for shapes it does not take.
int ssd_scan_launch(const void* x, long long x_sb, long long x_ss,
                    long long x_sh, const void* dt, long long dt_sb,
                    long long dt_ss, long long dt_sh, const void* A,
                    long long a_sb, long long a_sh, const void* B,
                    long long b_sb, long long b_ss, long long b_sg,
                    const void* C, long long c_sb, long long c_ss,
                    long long c_sg, void* y, void* hfin, int batch, int s,
                    int heads, int groups, int p, int n, int dtype,
                    void* stream) {
  if (batch < 0 || s < 0 || heads < 1 || groups < 1 || heads % groups ||
      n < 1 || n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)batch * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const Args g{x,    (const float*)dt, (const float*)A, B,     C,     y,
               (float*)hfin, x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, a_sb,
               a_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, batch, s, heads,
               groups, n};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && p == 32) return launch_f32<32>(g, (int)blocks, st);
  if (dtype == 0 && p == 64) return launch_f32<64>(g, (int)blocks, st);
  if (dtype == 1 && p == 32) return launch_bf16_p<32>(g, (int)blocks, st);
  if (dtype == 1 && p == 64) return launch_bf16_p<64>(g, (int)blocks, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
