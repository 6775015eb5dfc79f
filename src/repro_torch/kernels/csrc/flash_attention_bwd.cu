// K3's backward: the gradients of flash attention, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py:_kernel has no
// backward (the reference's models train through XLA's differentiation of
// models/attention.py:_plain_attn / attend); this is the backward of the
// function K3's forward (csrc/flash_attention.cu) computes. q, dO (BH, Sq,
// D), k and v (BH, Sk, D), contiguous, D in {64, 80, 128}, float32 or
// bfloat16, heads folded into the batch (GQA repetition is the caller's,
// as in the forward); m and l (BH, Sq) f32, the running max and running
// sum the forward wrote for each row. Outputs dq (BH, Sq, D), dk and dv
// (BH, Sk, D) in q's dtype, and the scratch dsum (BH, Sq) f32. The mask
// and its constants are the forward's: a masked score is -2e38 (causal:
// k_pos <= q_pos; window: k_pos > q_pos - window), positions count from 0
// unless q_pos (Sq) and k_pos (Sk) int32 are given (the position path).
//
// FlashAttention-2's backward with s the scaled score:
//   P_ij = exp(s_ij - m_i) / max(l_i, 1e-30)   (m and l kept apart: a row
//          whose keys are all masked keeps m = -2e38 and l = Sk, so P is
//          1/Sk there, the reference's softmax; -2e38 + log(Sk) would round
//          back to -2e38 and give P = 1)
//   dV = P^T dO,  dP = dO V^T,  D_i = sum_j P_ij dP_ij,
//   dS = P o (dP - D) sm_scale,  dQ = dS K,  dK = dS^T Q.
// Masked scores carry no gradient (masked_fill cuts the path): dS is 0 on
// every masked element, by the mask itself, also on a row whose keys are
// all masked, where P = 1/Sk is not 0. D_i is recomputed from P and dP (a
// first pass over each row's keys) rather than taken as dO_i . O_i: O is
// stored in bf16, and that rounding alone takes dQ and dK to 0.6 - 1.0 of
// GRAD_TOL at D 80 and S 1024, past it on one of three draws, where
// rowsum(P o dP) stays under 0.36 of it (a CPU emulation of this kernel's
// arithmetic, tests/test_torch_flash_attention_bwd.py). The plain version is
// repro_torch/kernels/ref.py:flash_attention_bwd_ref (these formulas in
// torch ops); the function's own plain version is autograd through
// ref.py:flash_attention_ref.
//
// Three kernels a launch, on one stream, in this order; no float atomics,
// every sum in a fixed order, so two launches give the same bits:
//   1. rowdot: one block per (64-row query tile, bh) walks the row's key
//      tiles (as the forward) and writes D to dsum;
//   2. dkdv: one block per (64-key tile, bh) holds its K and V tiles and
//      dK, dV in registers and walks the query tiles whose rows keep one of
//      its keys, recomputing S, P, dP and dS per tile;
//   3. dq: one block per (query tile, bh), as rowdot, recomputing S, P and
//      dP and summing dS K over the key tiles.
// On the index path each pass skips the tiles the forward skips (a key
// tile wholly past the diagonal or before the window adds exactly 0 to a
// row that keeps a key; the wrapper refuses, as the forward's does, the
// window case that would leave a row none); the position path visits
// every tile. Every element evaluates the mask. Keys past Sk and queries
// past Sq are zero-filled and get P = 0.
//
// - bfloat16 (the training path): the tensor cores, mma.sync m16n8k16 on
//   4 warps a block, each warp 16 rows of its tile (queries in rowdot and
//   dq, keys in dkdv). Tiles stay bf16 in shared memory (rows padded to D +
//   8, as the forward's) and arrive by cp.async, double-buffered. Scores
//   and dP are f32 sums of exact bf16 products; P and dS are f32 and enter
//   their products as hi + lo bf16 halves (x_hi = bf16(x), x_lo = bf16(x -
//   x_hi)), as the forward's p v does, or one bf16 rounding of each would
//   be summed over 1,024 keys. The other tile of each product is processed
//   16 columns at a time, so the accumulator layout of P and dS is the A
//   operand of the next mma and nothing but the input tiles goes through
//   shared memory. Shared memory 6 x 64 x (D + 8) x 2 B (+ 2 KB of row
//   statistics in dkdv): 106.5 KB at D 128, two blocks an SM.
// - float32 (the f32 checks and tests): the CUDA cores, as the f32
//   tolerance excludes TF32. 256 threads a block, thread (ty, tx) of a 16 x
//   16 grid holds a 4 x 4 slice of the 64 x 64 score tile; q is pre-scaled
//   and each score summed in the forward's order, so P is the forward's;
//   P and dS go through shared memory for the products with dO, Q and K.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at llama2-7b's
// training shape, BH = 8 x 32 = 256, S = 1024, D = 128, causal, bf16: the
// 524,800 unmasked (q, k) pairs of a head cost 10 D operations each (q k^T,
// dO V^T, P^T dO, dS K, dS^T Q), 171.96 G operations, 173.9 us; q, k, v, dO
// in and dq, dk, dv out move 7 x 67.1 MB and m, l 2.1 MB, 471.9 MB, 140.9
// us. Bound by operations: 173.9 us. This design does 24 D operations a
// pair (q k^T and dO V^T in all three passes, the hi / lo halves): 2.4
// times the bound's count. chip_smoke.py's `[time]` measures it; PERF.md
// keeps its times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"
#include "tensor_core.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* m;      // (bh, sq): the forward's running max
  const float* l;      // (bh, sq): the forward's running sum
  float* dsum;         // (bh, sq): D, written by rowdot
  void* dq;
  void* dk;
  void* dv;
  const int* q_pos;    // (sq) or null
  const int* k_pos;    // (sk) or null
  int sq, sk, causal, window;
  float sm_scale;
};

// P of one (query, key) element from its scaled score s: the forward's
// masked score (-2e38 where the mask drops the key) against the row's m
// and 1 / max(l, 1e-30); 0 where the pair does not exist (a key past Sk or
// a query past Sq).
__device__ __forceinline__ float prob(float s, bool keep, bool exists,
                                      float m, float inv_l) {
  return exists ? expf((keep ? s : kMaskFill) - m) * inv_l : 0.0f;
}

// Query tiles [qt_begin, qt_end) holding a query that keeps some key of the
// key tile at k0: on the index path causal drops the queries before k0 and
// a window those at or past the tile's last key + window; the position
// path visits all.
template <bool kPos>
__device__ __forceinline__ void query_tiles(int k0, int sq, int causal,
                                            int window, int& qt_begin,
                                            int& qt_end) {
  qt_end = (sq + kBQ - 1) / kBQ;
  qt_begin = 0;
  if (kPos) return;
  if (window > 0) qt_end = min(qt_end, (k0 + kBKV - 2 + window) / kBQ + 1);
  if (causal) qt_begin = min(qt_end, k0 / kBQ);
}

// Sets the dynamic shared memory limit of each kernel that needs more than
// the default 48 KB.
cudaError_t smem_attrs(void (*const* kernels)(Args), const size_t* bytes,
                       int n) {
  for (int i = 0; i < n; ++i) {
    if (bytes[i] > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)bytes[i]);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t bf16_tiles_bytes() {
  // six tiles of 64 rows of D + 8 bf16 (rowdot and dq: q, dO and two K and
  // V buffers; dkdv: K, V and two q and dO buffers)
  return sizeof(bf16) * 6 * (size_t)kBQ * (D + 8);
}

// dkdv's row statistics: m, 1 / l, D and the query position, two buffers
constexpr size_t kStatsBytes = 2 * 4 * kBQ * sizeof(float);

// The A operand of one k-step of 16 columns (n-tiles 0 and 1 of x, in the
// accumulator layout) as hi + lo bf16 halves.
__device__ __forceinline__ void split_a(const float (&x)[2][4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a0: x[0][0:2], a1: x[0][2:4], a2: x[1][0:2], a3: x[1][2:4]
    const float x0 = x[i >> 1][(i & 1) * 2];
    const float x1 = x[i >> 1][(i & 1) * 2 + 1];
    hi[i] = tc::pack_bf16(x0, x1);
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[i]);
    lo[i] = tc::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// acc (16 rows x D) += x (16 x 16, hi + lo) times rows [r0, r0 + 16) of the
// shared (.., D) tile src, read transposed (the B operand's k is src's row).
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         const bf16* src, int r0, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    tc::ldmatrix_x4_trans(
        b, src + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + dp * 16 +
               (lane >> 4) * 8);
    tc::mma_bf16(acc[2 * dp], hi, b[0], b[1]);
    tc::mma_bf16(acc[2 * dp], lo, b[0], b[1]);
    tc::mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
    tc::mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// Stores a warp's 16 rows x D accumulator (rows row_a and row_a + 8 of
// this thread) to a (.., D) bf16 matrix, times mul, rows below nrows.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4],
                                           int row_a, int nrows, int t,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    if (row < nrows) {
      bf16* out = dst + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * h] * mul,
                                  acc[j][2 * h + 1] * mul);
      }
    }
  }
}

// rowdot (kDq false: D_i = sum_j P_ij dP_ij into dsum) and dq (kDq true:
// dQ = sum_j dS_ij K_j), one block per (query tile, bh): each warp holds
// its 16 rows' q and dO fragments in registers and walks the key tiles, 16
// keys at a time.
template <int D, bool kPos, bool kDq>
__global__ void __launch_bounds__(kBf16Threads) bwd_q_bf16_kernel(Args a) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kBQ * kLd;
  bf16* ks = dos + kBQ * kLd;      // two buffers
  bf16* vs = ks + 2 * kBKV * kLd;  // two buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest first
  const size_t bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;
  const bf16* qb = static_cast<const bf16*>(a.q) + bh * (size_t)sq * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + bh * (size_t)sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + bh * (size_t)sk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + bh * (size_t)sk * D;

  int kt_begin, kt_end;
  key_tiles<kPos>(q0, sk, a.causal, a.window, kt_begin, kt_end);
  copy_tile<D>(qs, qb, q0, sq);
  copy_tile<D>(dos, dob, q0, sq);
  if (kt_begin < kt_end) {
    copy_tile<D>(ks, kb, kt_begin * kBKV, sk);
    copy_tile<D>(vs, vb, kt_begin * kBKV, sk);
  }
  tc::cp_async_commit();

  // this thread's rows row_a (h = 0) and row_a + 8 (h = 1)
  const int row_a = q0 + warp * 16 + g;
  int qpos[2];
  bool row_ok[2];
  float m_row[2], inv_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    const size_t i = bh * (size_t)sq + row;
    row_ok[h] = row < sq;
    qpos[h] = kPos ? (row_ok[h] ? __ldg(a.q_pos + row) : 0) : row;
    m_row[h] = row_ok[h] ? a.m[i] : 0.0f;
    inv_row[h] = row_ok[h] ? 1.0f / fmaxf(a.l[i], 1e-30f) : 0.0f;
    d_row[h] = kDq && row_ok[h] ? a.dsum[i] : 0.0f;
  }
  uint32_t qf[kKSteps][4], dof[kKSteps][4];
  float acc[kDq ? kDTiles : 1][4];
#pragma unroll
  for (int j = 0; j < (kDq ? kDTiles : 1); ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  float dsum_part[2] = {0.0f, 0.0f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    tc::cp_async_wait<0>();  // tile kt (and at first q, dO) has landed
    __syncthreads();         // ... for every thread; tile kt - 1 is consumed
    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int off =
            (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        tc::ldmatrix_x4(qf[kk], qs + off);
        tc::ldmatrix_x4(dof[kk], dos + off);
      }
    }
    if (kt + 1 < kt_end) {
      copy_tile<D>(ks + (buf ^ 1) * kBKV * kLd, kb, (kt + 1) * kBKV, sk);
      copy_tile<D>(vs + (buf ^ 1) * kBKV * kLd, vb, (kt + 1) * kBKV, sk);
    }
    tc::cp_async_commit();
    const bf16* kts = ks + buf * kBKV * kLd;
    const bf16* vts = vs + buf * kBKV * kLd;
    const int k0 = kt * kBKV;

#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      // s = q k^T and dp = dO v^T over keys k0 + kc * 16 + [0, 16)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int off =
            (kc * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
            ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        tc::ldmatrix_x4(b, kts + off);
        tc::mma_bf16(s[0], qf[kk], b[0], b[1]);
        tc::mma_bf16(s[1], qf[kk], b[2], b[3]);
        tc::ldmatrix_x4(b, vts + off);
        tc::mma_bf16(dp[0], dof[kk], b[0], b[1]);
        tc::mma_bf16(dp[1], dof[kk], b[2], b[3]);
      }
      // element (j, e): row h = e >> 1, key k0 + kc * 16 + j * 8 + 2 t +
      // (e & 1); P, then D's terms or dS (in place of s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kidx = k0 + kc * 16 + j * 8 + 2 * t + c;
          const int kp = kPos ? key_pos(a.k_pos, kidx, sk) : kidx;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const bool keep = kept(qpos[h], kp, a.causal, a.window);
            const bool exists = row_ok[h] && kidx < sk;
            const float p = prob(s[j][e] * a.sm_scale, keep, exists,
                                 m_row[h], inv_row[h]);
            if (kDq) {
              s[j][e] = keep && exists
                            ? p * (dp[j][e] - d_row[h]) * a.sm_scale
                            : 0.0f;
            } else {
              dsum_part[h] += p * dp[j][e];
            }
          }
        }
      }
      if constexpr (kDq) {
        // dq += dS k over these 16 keys
        uint32_t hi[4], lo[4];
        split_a(s, hi, lo);
        mma_rows<D>(acc, hi, lo, kts, kc * 16, lane);
      }
    }
  }
  tc::cp_async_wait<0>();

  if constexpr (kDq) {
    store_rows<D>(static_cast<bf16*>(a.dq) + bh * (size_t)sq * D, acc, row_a,
                  sq, t, 1.0f);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dsum_part[h];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t == 0 && row_ok[h]) a.dsum[bh * (size_t)sq + row_a + h * 8] = v;
    }
  }
}

// dkdv, one block per (key tile, bh): each warp holds dK and dV of its 16
// keys in registers and walks the query tiles, 16 queries at a time, its K
// and V fragments read from shared memory.
template <int D, bool kPos>
__global__ void __launch_bounds__(kBf16Threads) bwd_kv_bf16_kernel(Args a) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kBKV * kLd;
  bf16* qs = vs + kBKV * kLd;      // two buffers
  bf16* dos = qs + 2 * kBQ * kLd;  // two buffers
  // per buffer: m, 1 / l, D, the query position of each of the 64 rows
  float* stats = reinterpret_cast<float*>(dos + 2 * kBQ * kLd);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBKV;  // causal: the first have most queries
  const size_t bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;
  const bf16* qb = static_cast<const bf16*>(a.q) + bh * (size_t)sq * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + bh * (size_t)sq * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + bh * (size_t)sk * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + bh * (size_t)sk * D;

  // the row statistics of the query tile at q0 into buffer b (plain loads:
  // a row of m and l need not be 16-byte aligned)
  auto load_stats = [&](int b, int q0) {
    if (threadIdx.x < kBQ) {
      float* st = stats + b * 4 * kBQ;
      const int row = q0 + threadIdx.x;
      const bool ok = row < sq;
      const size_t i = bh * (size_t)sq + row;
      st[threadIdx.x] = ok ? a.m[i] : 0.0f;
      st[kBQ + threadIdx.x] = ok ? 1.0f / fmaxf(a.l[i], 1e-30f) : 0.0f;
      st[2 * kBQ + threadIdx.x] = ok ? a.dsum[i] : 0.0f;
      reinterpret_cast<int*>(st)[3 * kBQ + threadIdx.x] =
          kPos ? (ok ? __ldg(a.q_pos + row) : 0) : row;
    }
  };

  int qt_begin, qt_end;
  query_tiles<kPos>(k0, sq, a.causal, a.window, qt_begin, qt_end);
  copy_tile<D>(ks, kb, k0, sk);
  copy_tile<D>(vs, vb, k0, sk);
  if (qt_begin < qt_end) {
    copy_tile<D>(qs, qb, qt_begin * kBQ, sq);
    copy_tile<D>(dos, dob, qt_begin * kBQ, sq);
    load_stats(0, qt_begin * kBQ);
  }
  tc::cp_async_commit();

  // this thread's keys key_a (h = 0) and key_a + 8 (h = 1)
  const int key_a = k0 + warp * 16 + g;
  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kidx = key_a + h * 8;
    key_ok[h] = kidx < sk;
    kpos[h] = kPos ? key_pos(a.k_pos, kidx, sk) : kidx;
  }
  float dk[kDTiles][4], dv[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    tc::cp_async_wait<0>();  // tile qt (and at first K, V) has landed
    __syncthreads();         // ... for every thread; tile qt - 1 is consumed
    if (qt + 1 < qt_end) {
      copy_tile<D>(qs + (buf ^ 1) * kBQ * kLd, qb, (qt + 1) * kBQ, sq);
      copy_tile<D>(dos + (buf ^ 1) * kBQ * kLd, dob, (qt + 1) * kBQ, sq);
      load_stats(buf ^ 1, (qt + 1) * kBQ);
    }
    tc::cp_async_commit();
    const bf16* qts = qs + buf * kBQ * kLd;
    const bf16* dots = dos + buf * kBQ * kLd;
    const float* st = stats + buf * 4 * kBQ;
    const int q0 = qt * kBQ;

#pragma unroll
    for (int qc = 0; qc < kBQ / 16; ++qc) {
      // s^T = k q^T and dp^T = v dO^T over queries q0 + qc * 16 + [0, 16)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int a_off =
            (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        const int b_off =
            (qc * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
            ((lane >> 3) & 1) * 8;
        uint32_t af[4], b[4];
        tc::ldmatrix_x4(af, ks + a_off);
        tc::ldmatrix_x4(b, qts + b_off);
        tc::mma_bf16(s[0], af, b[0], b[1]);
        tc::mma_bf16(s[1], af, b[2], b[3]);
        tc::ldmatrix_x4(af, vs + a_off);
        tc::ldmatrix_x4(b, dots + b_off);
        tc::mma_bf16(dp[0], af, b[0], b[1]);
        tc::mma_bf16(dp[1], af, b[2], b[3]);
      }
      // element (j, e): key h = e >> 1, query qc * 16 + j * 8 + 2 t +
      // (e & 1) of the tile; P in place of s, dS in place of dp
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ql = qc * 16 + j * 8 + 2 * t + c;
          const float m = st[ql], inv_l = st[kBQ + ql], dd = st[2 * kBQ + ql];
          const int qp = reinterpret_cast<const int*>(st)[3 * kBQ + ql];
          const bool q_ok = q0 + ql < sq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const bool keep = kept(qp, kpos[h], a.causal, a.window);
            const bool exists = q_ok && key_ok[h];
            const float p =
                prob(s[j][e] * a.sm_scale, keep, exists, m, inv_l);
            s[j][e] = p;
            dp[j][e] = keep && exists ? p * (dp[j][e] - dd) * a.sm_scale
                                      : 0.0f;
          }
        }
      }
      // dv += P^T dO and dk += dS^T q over these 16 queries
      uint32_t hi[4], lo[4];
      split_a(s, hi, lo);
      mma_rows<D>(dv, hi, lo, dots, qc * 16, lane);
      split_a(dp, hi, lo);
      mma_rows<D>(dk, hi, lo, qts, qc * 16, lane);
    }
  }
  tc::cp_async_wait<0>();

  store_rows<D>(static_cast<bf16*>(a.dk) + bh * (size_t)sk * D, dk, key_a,
                sk, t, 1.0f);
  store_rows<D>(static_cast<bf16*>(a.dv) + bh * (size_t)sk * D, dv, key_a,
                sk, t, 1.0f);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLdP = kBKV + 1;

template <int D>
__host__ __device__ constexpr size_t f32_q_smem_bytes() {
  // q, dO, K, V (64 x D+1 each) and dS (64 x 65)
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) + (size_t)kBQ * kLdP);
}

template <int D>
__host__ __device__ constexpr size_t f32_kv_smem_bytes() {
  // K, V, q, dO (64 x D+1 each), P and dS (64 x 65 each), the row
  // statistics (m, 1 / l, D, position)
  return sizeof(float) * (4 * (size_t)kBQ * (D + 1) +
                          2 * (size_t)kBKV * kLdP + 4 * (size_t)kBQ);
}

// rowdot (kDq false) and dq (kDq true), as the bf16 kernel: thread (ty,
// tx) holds query rows ty + 16 i and keys tx + 16 j of each tile; q
// pre-scaled, so each score is the forward's sum.
template <int D, bool kPos, bool kDq>
__global__ void __launch_bounds__(kF32Threads) bwd_q_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  float* qs = smem_f;
  float* dos = qs + kBQ * kLd;
  float* ks = dos + kBQ * kLd;
  float* vs = ks + kBKV * kLd;
  float* dss = vs + kBKV * kLd;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;
  const float* qb = static_cast<const float*>(a.q) + bh * (size_t)sq * D;
  const float* dob = static_cast<const float*>(a.dout) + bh * (size_t)sq * D;
  const float* kb = static_cast<const float*>(a.k) + bh * (size_t)sk * D;
  const float* vb = static_cast<const float*>(a.v) + bh * (size_t)sk * D;

  load_rows<D>(qs, kLd, qb, q0, sq, a.sm_scale);
  load_rows<D>(dos, kLd, dob, q0, sq, 1.0f);

  int qpos[4];
  bool row_ok[4];
  float m_row[4], inv_row[4], d_row[4], dsum_part[4];
  float acc[4][kDq ? kCols : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t r = bh * (size_t)sq + row;
    row_ok[i] = row < sq;
    qpos[i] = kPos ? (row_ok[i] ? __ldg(a.q_pos + row) : 0) : row;
    m_row[i] = row_ok[i] ? a.m[r] : 0.0f;
    inv_row[i] = row_ok[i] ? 1.0f / fmaxf(a.l[r], 1e-30f) : 0.0f;
    d_row[i] = kDq && row_ok[i] ? a.dsum[r] : 0.0f;
    dsum_part[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < (kDq ? kCols : 1); ++j) acc[i][j] = 0.0f;
  }
  int kt_begin, kt_end;
  key_tiles<kPos>(q0, sk, a.causal, a.window, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the previous tile's K, V and dS are consumed
    load_rows<D>(ks, kLd, kb, k0, sk, 1.0f);
    load_rows<D>(vs, kLd, vb, k0, sk, 1.0f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * kLd + d];
        ov[i] = dos[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * kLd + d];
        vv[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kidx = k0 + tx + 16 * j;
      const int kp = kPos ? key_pos(a.k_pos, kidx, sk) : kidx;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool keep = kept(qpos[i], kp, a.causal, a.window);
        const bool exists = row_ok[i] && kidx < sk;
        const float p = prob(s[i][j], keep, exists, m_row[i], inv_row[i]);
        if (kDq) {
          dss[(ty + 16 * i) * kLdP + tx + 16 * j] =
              keep && exists ? p * (dp[i][j] - d_row[i]) : 0.0f;
        } else {
          dsum_part[i] += p * dp[i][j];
        }
      }
    }
    if constexpr (kDq) {
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kBKV; ++c) {
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float kv = ks[c * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if constexpr (kDq) {
      if (row_ok[i]) {
        float* out = static_cast<float*>(a.dq) + (bh * (size_t)sq + row) * D;
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          out[tx + 16 * j] = acc[i][j] * a.sm_scale;
      }
    } else {
      float v = dsum_part[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      if (tx == 0 && row_ok[i]) a.dsum[bh * (size_t)sq + row] = v;
    }
  }
}

// dkdv: thread (ty, tx) holds keys ty + 16 i and queries tx + 16 j of each
// tile, and dK, dV of its keys at columns tx + 16 c. dS is kept unscaled
// against the pre-scaled q.
template <int D, bool kPos>
__global__ void __launch_bounds__(kF32Threads) bwd_kv_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;
  float* ks = smem_f;
  float* vs = ks + kBKV * kLd;
  float* qs = vs + kBKV * kLd;
  float* dos = qs + kBQ * kLd;
  float* ps = dos + kBQ * kLd;
  float* dss = ps + kBKV * kLdP;
  float* st = dss + kBKV * kLdP;  // m, 1 / l, D, query position

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kBKV;
  const size_t bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;
  const float* qb = static_cast<const float*>(a.q) + bh * (size_t)sq * D;
  const float* dob = static_cast<const float*>(a.dout) + bh * (size_t)sq * D;
  const float* kb = static_cast<const float*>(a.k) + bh * (size_t)sk * D;
  const float* vb = static_cast<const float*>(a.v) + bh * (size_t)sk * D;

  load_rows<D>(ks, kLd, kb, k0, sk, 1.0f);
  load_rows<D>(vs, kLd, vb, k0, sk, 1.0f);
  int kpos[4];
  bool key_ok[4];
  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kidx = k0 + ty + 16 * i;
    key_ok[i] = kidx < sk;
    kpos[i] = kPos ? key_pos(a.k_pos, kidx, sk) : kidx;
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk[i][j] = dv[i][j] = 0.0f;
  }
  int qt_begin, qt_end;
  query_tiles<kPos>(k0, sq, a.causal, a.window, qt_begin, qt_end);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's q, dO, P and dS are consumed
    load_rows<D>(qs, kLd, qb, q0, sq, a.sm_scale);
    load_rows<D>(dos, kLd, dob, q0, sq, 1.0f);
    if (tid < kBQ) {
      const int row = q0 + tid;
      const bool ok = row < sq;
      const size_t r = bh * (size_t)sq + row;
      st[tid] = ok ? a.m[r] : 0.0f;
      st[kBQ + tid] = ok ? 1.0f / fmaxf(a.l[r], 1e-30f) : 0.0f;
      st[2 * kBQ + tid] = ok ? a.dsum[r] : 0.0f;
      reinterpret_cast<int*>(st)[3 * kBQ + tid] =
          kPos ? (ok ? __ldg(a.q_pos + row) : 0) : row;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * kLd + d];
        vv[i] = vs[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * kLd + d];
        ov[j] = dos[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = tx + 16 * j;
      const float m = st[ql], inv_l = st[kBQ + ql], dd = st[2 * kBQ + ql];
      const int qp = reinterpret_cast<const int*>(st)[3 * kBQ + ql];
      const bool q_ok = q0 + ql < sq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool keep = kept(qp, kpos[i], a.causal, a.window);
        const bool exists = q_ok && key_ok[i];
        const float p = prob(s[i][j], keep, exists, m, inv_l);
        ps[(ty + 16 * i) * kLdP + ql] = p;
        dss[(ty + 16 * i) * kLdP + ql] =
            keep && exists ? p * (dp[i][j] - dd) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBQ; ++c) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty + 16 * i) * kLdP + c];
        sv[i] = dss[(ty + 16 * i) * kLdP + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float ov = dos[c * kLd + tx + 16 * j];
        const float qv = qs[c * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (key_ok[i]) {
      const size_t r = (bh * (size_t)sk + k0 + ty + 16 * i) * D;
      float* dk_out = static_cast<float*>(a.dk) + r;
      float* dv_out = static_cast<float*>(a.dv) + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dk_out[tx + 16 * j] = dk[i][j];
        dv_out[tx + 16 * j] = dv[i][j];
      }
    }
  }
}

template <typename T, int D, bool kPos>
int launch(const Args& a, int bh, cudaStream_t stream) {
  void (*rowdot)(Args);
  void (*dq)(Args);
  void (*dkdv)(Args);
  size_t q_smem, kv_smem;
  int threads;
  if constexpr (std::is_same_v<T, bf16>) {
    rowdot = bwd_q_bf16_kernel<D, kPos, false>;
    dq = bwd_q_bf16_kernel<D, kPos, true>;
    dkdv = bwd_kv_bf16_kernel<D, kPos>;
    q_smem = bf16_tiles_bytes<D>();
    kv_smem = bf16_tiles_bytes<D>() + kStatsBytes;
    threads = kBf16Threads;
  } else {
    rowdot = bwd_q_f32_kernel<D, kPos, false>;
    dq = bwd_q_f32_kernel<D, kPos, true>;
    dkdv = bwd_kv_f32_kernel<D, kPos>;
    q_smem = f32_q_smem_bytes<D>();
    kv_smem = f32_kv_smem_bytes<D>();
    threads = kF32Threads;
  }
  // once per instantiation, so no launch inside a CUDA graph capture sets a
  // function attribute
  void (*const kernels[3])(Args) = {rowdot, dq, dkdv};
  const size_t bytes[3] = {q_smem, q_smem, kv_smem};
  static const cudaError_t attr = smem_attrs(kernels, bytes, 3);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 q_grid((a.sq + kBQ - 1) / kBQ, bh);
  const dim3 kv_grid((a.sk + kBKV - 1) / kBKV, bh);
  rowdot<<<q_grid, threads, q_smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv<<<kv_grid, threads, kv_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq<<<q_grid, threads, q_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The index path (no positions) or the position path, by q_pos.
template <typename T, int D>
int launch_path(const Args& a, int bh, cudaStream_t stream) {
  if (a.q_pos == nullptr) return launch<T, D, false>(a, bh, stream);
  return launch<T, D, true>(a, bh, stream);
}

}  // namespace

extern "C" {

// Launches K3's backward on `stream` (three kernels, in order): dq (bh,
// sq, d), dk and dv (bh, sk, d) of o = softmax(q k^T * sm_scale + mask) v
// at the cotangent dout (bh, sq, d), from q, k, v, dout (contiguous,
// 16-byte aligned, one dtype: 0 float32, 1 bfloat16) and the forward's row
// statistics m, l (bh, sq) f32; dsum (bh, sq) f32 is scratch. window <= 0
// means no window; q_pos (sq) and k_pos (sk) int32, both null for
// positions counted from 0. Returns cudaGetLastError() after the launches
// (0 on success) or cudaErrorInvalidValue for shapes it does not take.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const float* m,
                               const float* l, float* dsum, void* dq,
                               void* dk, void* dv, int bh, int sq, int sk,
                               int d, int causal, int window, float sm_scale,
                               int dtype, const int* q_pos, const int* k_pos,
                               void* stream) {
  if (bh < 0 || bh > 65535 || sq < 0 || sk < 1 ||
      (q_pos == nullptr) != (k_pos == nullptr) || m == nullptr ||
      l == nullptr || dsum == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0 || sq == 0) {
    // no query: dk and dv are 0
    if (bh == 0) return 0;
    const size_t bytes = (size_t)bh * sk * d * (dtype == 0 ? 4 : 2);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, s);
    return (int)e;
  }
  const Args a{q,     k,     v,  dout, m,      l,
               dsum,  dq,    dk, dv,   q_pos,  k_pos,
               sq,    sk,    causal,   window > 0 ? window : 0,
               sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
#define K3B_LAUNCH(T, D) launch_path<T, D>(a, bh, s)
  if (dtype == 0 && d == 64) return K3B_LAUNCH(float, 64);
  if (dtype == 0 && d == 80) return K3B_LAUNCH(float, 80);
  if (dtype == 0 && d == 128) return K3B_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) return K3B_LAUNCH(bf16, 64);
  if (dtype == 1 && d == 80) return K3B_LAUNCH(bf16, 80);
  if (dtype == 1 && d == 128) return K3B_LAUNCH(bf16, 128);
#undef K3B_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
