// K3: forward flash attention (online softmax), causal and / or sliding
// window, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel (the
// Pallas `flash_attention`). q (BH, Sq, D), k and v (BH, Sk, D), heads
// folded into the batch (GQA repetition is the caller's, as on the TPU),
// D in {64, 80, 128}, float32 or bfloat16; o (BH, Sq, D) in q's dtype. The
// function and its constants are the TPU kernel's: q is scaled by
// sm_scale = 1/sqrt(D) before q k^T, a masked score is -2e38 (causal: k_pos
// <= q_pos; window: k_pos > q_pos - window), and the running max, the
// running sum and the output accumulator are f32; the output is acc /
// max(l, 1e-30). The plain version is
// repro_torch/kernels/ref.py:flash_attention_ref.
//
// Row statistics. Given m_out and l_out (BH, Sq) f32, the launch also
// writes each row's final running max m and running sum l where it stores
// the row's output, for K3's backward (csrc/flash_attention_bwd.cu), which
// recomputes P = exp(s - m) / max(l, 1e-30) from them. They stay two
// numbers: a row whose keys are all masked ends with m = -2e38 and l = Sk,
// and their log-sum-exp would round back to -2e38. Null pointers (serving)
// write nothing.
//
// Positions. Without position vectors (null pointers: the index path)
// query and key positions both count from 0 (also when Sq != Sk), as in the
// TPU kernel. With q_pos (Sq) and k_pos (Sk) int32, shared by every bh (the
// position path), the mask compares those positions, as the reference's
// XLA attention (src/repro/models/attention.py:_mask_bias) does for
// Qwen2-VL's M-RoPE temporal stream: an image span gives all its patches
// one position, so a query sees keys at later indices that share it, and
// no index shortcut holds. The position path visits every key tile and
// evaluates the element mask on each (position vectors read through the
// read-only cache). A row whose keys are all masked then gets the
// reference's answer, V averaged over all Sk keys: the running max starts
// at -2e38, so each masked key weighs exp(0) = 1 until a kept key's score
// wipes them (exp(-2e38 - m) = 0). Where every row keeps a key (q_pos is
// k_pos, as in the model) a masked tile adds exactly 0, so an explicit
// arange gives the index path's bits.
//
// Two variants behind the one entry point:
//
// - bfloat16 (the serving path): FlashAttention-2 on the tensor cores. One
//   block of 4 warps per (bh, 64-row query tile); each warp owns 16 query
//   rows, whose q fragments stay in registers for the whole key loop. K and
//   V tiles of 64 keys stay bf16 in shared memory (rows padded to D + 8
//   elements, an odd number of 16-byte chunks, so ldmatrix is free of bank
//   conflicts at D 64, 80 and 128 alike; D 80's 160-byte rows admit no
//   power-of-two swizzle) and arrive by cp.async, double-buffered: tile j + 1
//   is in flight while tile j computes, one __syncthreads a tile. Keys past
//   Sk are zero-filled by the copy's source size. q k^T is mma.sync
//   m16n8k16 on the unscaled bf16 q and k (exact products, f32 sums), then
//   multiplied by sm_scale in f32: against the TPU kernel's (q sm_scale) k
//   this is f32 reassociation only. Scores stay in the mma accumulator
//   layout; row max and row sum are quad shuffles. p is f32 after expf;
//   since one bf16 p would round every probability to 8 bits, p v is
//   p_hi v + p_lo v with p_hi = bf16(p), p_lo = bf16(p - p_hi), both into
//   the same f32 accumulator (error about 2^-16 p, at twice the p v
//   operations). The accumulator layout of p is the A-operand layout of the
//   next mma, so p never goes through shared memory; V enters through
//   ldmatrix.trans. Only the key tiles that straddle a mask edge (the
//   diagonal, the window's start, Sk) evaluate the element mask. Query tiles
//   run longest first (causal: the last tile has the most keys).
//   Shared memory 5 x 64 x (D + 8) x 2 B: 85 KB at D 128, so two blocks
//   share an SM (56 KB at D 80: four). 64-row query tiles of 4 warps
//   rather than 128 of 8: the registers (231 a thread at D 128, 168 at D
//   80, no spills) hold an SM to 8 warps at D 128 either way, and the
//   smaller tile skips more of the causal triangle.
// - float32 (the f32 logit check and tests): f32 on the CUDA cores, as the
//   f32 tolerance (2e-5) excludes TF32. One block of 256 threads per (bh,
//   64-row query tile); q (pre-scaled), K and V tiles in shared memory as
//   f32; thread (ty, tx) of a 16 x 16 grid holds a 4 x 4 slice of the score
//   tile and of the output accumulator; row max and row sum are 16-lane
//   shuffles.
//
// On the index path both skip key tiles wholly past the diagonal (causal)
// or wholly before the window: in the TPU kernel they contribute
// exp(-2e38 - m) = 0 or are wiped by the correction factor exp(-2e38 - m) =
// 0 once a real score arrives, so skipping them gives the same result for
// every row that keeps a key. (A row whose keys are all masked, which only
// a window with Sq >= Sk + window leaves, would differ: the wrapper refuses
// that case on the index path.) Keys past Sk are -inf (they do not exist),
// query rows past Sq are not stored.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at llama2-7b's
// prefill, BH = 8 x 32 = 256, S = 1024, D = 128, causal, bf16: q, k, v in
// and o out move 268.4 MB, 80.1 us; the S (S + 1) / 2 = 524,800 unmasked
// (q, k) pairs of a head cost 4 D operations each (q k^T and p v), 68.8 G
// operations, 69.6 us. Bound by bytes: 80.1 us. (The p_hi / p_lo split
// makes the kernel's own work 6 D operations a pair, 103.2 G, 104.4 us on
// the tensor cores.) The previous design, f32 on the CUDA cores, took
// 2,915.6 us here (NVIDIA H100 80GB HBM3, 700 W).
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

// The score of the key at index kidx (position kp) for a query at position
// qp after the mask: -2e38 where causal or window masks it, -inf past Sk.
__device__ __forceinline__ float masked(float s, int qp, int kp, int kidx,
                                        int sk, int causal, int window) {
  return kidx >= sk ? -INFINITY
                    : (kept(qp, kp, causal, window) ? s : kMaskFill);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, cp.async double buffering
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  // q, two K tiles, two V tiles, 64 rows of D + 8 bf16 each
  return sizeof(bf16) * 5 * (size_t)kBQ * (D + 8);
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kBf16Threads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          int sq, int sk, int causal, int window,
                          float sm_scale, const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;  // k-steps of q k^T
  constexpr int kDTiles = D / 8;   // n-tiles of p v
  constexpr int kNTiles = kBKV / 8;
  static_assert(D % 16 == 0, "head dim");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * kLd;   // two buffers
  bf16* vs = ks + 2 * kBKV * kLd;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // longest query tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)sq * D;
  const bf16* kb = k + bh * (size_t)sk * D;
  const bf16* vb = v + bh * (size_t)sk * D;

  int kt_begin, kt_end;
  key_tiles<kPos>(q0, sk, causal, window, kt_begin, kt_end);

  copy_tile<D>(qs, qb, q0, sq);
  if (kt_begin < kt_end) {
    copy_tile<D>(ks, kb, kt_begin * kBKV, sk);
    copy_tile<D>(vs, vb, kt_begin * kBKV, sk);
  }
  tc::cp_async_commit();

  const int row_a = q0 + warp * 16 + g;  // this thread's rows: a, a + 8
  int qpos[2] = {row_a, row_a + 8};     // their positions
  if (kPos) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qpos[h] = qpos[h] < sq ? __ldg(q_pos + qpos[h]) : 0;
  }
  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
  float m_run[2] = {kMaskFill, kMaskFill};
  float l_run[2] = {0.0f, 0.0f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    tc::cp_async_wait<0>();  // tile kt (and at first q) has landed
    __syncthreads();         // ... for every thread; tile kt - 1 is consumed
    if (kt == kt_begin) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        tc::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd +
                                    kk * 16 + (lane >> 4) * 8);
      }
    }
    if (kt + 1 < kt_end) {
      copy_tile<D>(ks + (buf ^ 1) * kBKV * kLd, kb, (kt + 1) * kBKV, sk);
      copy_tile<D>(vs + (buf ^ 1) * kBKV * kLd, vb, (kt + 1) * kBKV, sk);
    }
    tc::cp_async_commit();
    const bf16* kts = ks + buf * kBKV * kLd;
    const bf16* vts = vs + buf * kBKV * kLd;

    // s = q k^T: 16 rows x 64 keys a warp, unscaled
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, kts + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     kLd +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = kt * kBKV;
    if constexpr (kPos) {
      // every tile evaluates the mask on positions
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kidx = k0 + j * 8 + 2 * t + c;
          const int kp = key_pos(k_pos, kidx, sk);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[j][2 * h + c] = masked(s[j][2 * h + c] * sm_scale, qpos[h], kp,
                                     kidx, sk, causal, window);
          }
        }
      }
    } else {
      const bool edge = (causal && k0 + kBKV - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kBQ - 1 - window) ||
                        k0 + kBKV > sk;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= sm_scale;
          if (edge) {
            const int kidx = k0 + j * 8 + 2 * t + (e & 1);
            s[j][e] = masked(s[j][e], qpos[e >> 1], kidx, kidx, sk, causal,
                             window);
          }
        }
      }
    }

    // online softmax over the tile; rows a (e = 0, 1) and a + 8 (e = 2, 3)
    float m_new[2], corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kMaskFill;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[h] = fmaxf(m_run[h], mx);
      corr[h] = expf(m_run[h] - m_new[h]);
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_new[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * corr[h] + sum[h];
      m_run[h] = m_new[h];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += p_hi v + p_lo v; p's accumulator layout is the A operand's
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a0: s[2kk][0:2], a1: s[2kk][2:4], a2: s[2kk+1][0:2], a3: ...[2:4]
        const float p0 = s[2 * kk + (i >> 1)][(i & 1) * 2];
        const float p1 = s[2 * kk + (i >> 1)][(i & 1) * 2 + 1];
        ph[i] = tc::pack_bf16(p0, p1);
        const __nv_bfloat162 hi =
            *reinterpret_cast<const __nv_bfloat162*>(&ph[i]);
        pl[i] = tc::pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(
            b, vts + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                   dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dp], ph, b[0], b[1]);
        tc::mma_bf16(acc[2 * dp], pl, b[0], b[1]);
        tc::mma_bf16(acc[2 * dp + 1], ph, b[2], b[3]);
        tc::mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    if (row < sq) {
      const float inv = 1.0f / fmaxf(l_run[h], 1e-30f);
      bf16* orow = o + (bh * (size_t)sq + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[j][2 * h] * inv,
                                  acc[j][2 * h + 1] * inv);
      }
      // the quad holds one row's statistics; its first thread writes them
      if (m_out != nullptr && t == 0) {
        m_out[bh * (size_t)sq + row] = m_run[h];
        l_out[bh * (size_t)sq + row] = l_run[h];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  // q (BQ x D+1), k (BKV x D+1), v (BKV x D), p (BQ x BKV+1), all f32
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBKV * (D + 1) +
                          (size_t)kBKV * D + (size_t)kBQ * (kBKV + 1));
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int sq, int sk, int causal, int window,
                         float sm_scale, const int* __restrict__ q_pos,
                         const int* __restrict__ k_pos,
                         float* __restrict__ m_out,
                         float* __restrict__ l_out) {
  extern __shared__ __align__(16) float smem_f[];
  constexpr int kLdQ = D + 1, kLdK = D + 1, kLdV = D, kLdP = kBKV + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  float* qs = smem_f;
  float* ks = qs + kBQ * kLdQ;
  float* vs = ks + kBKV * kLdK;
  float* ps = vs + kBKV * kLdV;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * (size_t)sq * D;
  const float* kb = k + bh * (size_t)sk * D;
  const float* vb = v + bh * (size_t)sk * D;

  load_rows<D>(qs, kLdQ, qb, q0, sq, sm_scale);

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMaskFill;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // this thread's query rows' positions and, per tile, its keys'
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    qpos[i] = kPos ? (row < sq ? __ldg(q_pos + row) : 0) : row;
  }
  int kt_begin, kt_end;
  key_tiles<kPos>(q0, sk, causal, window, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_rows<D>(ks, kLdK, kb, k0, sk, 1.0f);
    load_rows<D>(vs, kLdV, vb, k0, sk, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kLdQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    int kpos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kidx = k0 + tx + 16 * j;
      kpos[j] = kPos ? key_pos(k_pos, kidx, sk) : kidx;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMaskFill;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked(s[i][j], qpos[i], kpos[j], k0 + tx + 16 * j, sk,
                         causal, window);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * kLdV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      const float inv = 1.0f / fmaxf(l_run[i], 1e-30f);
      float* orow = o + (bh * (size_t)sq + row) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
      // the 16 threads of a row hold its statistics; the first writes them
      if (m_out != nullptr && tx == 0) {
        m_out[bh * (size_t)sq + row] = m_run[i];
        l_out[bh * (size_t)sq + row] = l_run[i];
      }
    }
  }
}

template <typename T, int D, bool kPos>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int causal, int window, float sm_scale,
           const int* q_pos, const int* k_pos, float* m_out, float* l_out,
           cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int,
                 float, const int*, const int*, float*, float*);
  size_t smem;
  int threads;
  if constexpr (std::is_same_v<T, bf16>) {
    kernel = flash_fwd_bf16_kernel<D, kPos>;
    smem = bf16_smem_bytes<D>();
    threads = kBf16Threads;
  } else {
    kernel = flash_fwd_f32_kernel<D, kPos>;
    smem = f32_smem_bytes<D>();
    threads = kF32Threads;
  }
  // once per instantiation, so no launch inside a CUDA graph capture sets a
  // function attribute
  static const cudaError_t attr =
      smem > 48 * 1024
          ? cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem)
          : cudaSuccess;
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                          (const T*)v, (T*)o, sq, sk, causal,
                                          window, sm_scale, q_pos, k_pos,
                                          m_out, l_out);
  return (int)cudaGetLastError();
}

// The index path (no positions) or the position path, by q_pos.
template <typename T, int D>
int launch_path(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int sk, int causal, int window, float sm_scale,
                const int* q_pos, const int* k_pos, float* m_out,
                float* l_out, cudaStream_t stream) {
  if (q_pos == nullptr) {
    return launch<T, D, false>(q, k, v, o, bh, sq, sk, causal, window,
                               sm_scale, nullptr, nullptr, m_out, l_out,
                               stream);
  }
  return launch<T, D, true>(q, k, v, o, bh, sq, sk, causal, window, sm_scale,
                            q_pos, k_pos, m_out, l_out, stream);
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: o (bh, sq, d) = softmax(q k^T * sm_scale + mask)
// v for q (bh, sq, d), k and v (bh, sk, d), contiguous, 16-byte aligned.
// window <= 0 means no window. dtype 0 is float32, 1 is bfloat16. q_pos
// (sq) and k_pos (sk) int32 are the tokens' positions, both null for
// positions counted from 0 (see the header). m_out and l_out (bh, sq)
// f32, both or neither (null), receive each row's running max and running
// sum. Returns cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for shapes it does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bh, int sq, int sk, int d, int causal,
                           int window, float sm_scale, int dtype,
                           const int* q_pos, const int* k_pos, float* m_out,
                           float* l_out, void* stream) {
  if (bh < 0 || bh > 65535 || sq < 0 || sk < 1 ||
      (q_pos == nullptr) != (k_pos == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define K3_LAUNCH(T, D)                                                      \
  launch_path<T, D>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, q_pos, \
                    k_pos, m_out, l_out, s)
  if (dtype == 0 && d == 64) return K3_LAUNCH(float, 64);
  if (dtype == 0 && d == 80) return K3_LAUNCH(float, 80);
  if (dtype == 0 && d == 128) return K3_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) return K3_LAUNCH(bf16, 64);
  if (dtype == 1 && d == 80) return K3_LAUNCH(bf16, 80);
  if (dtype == 1 && d == 128) return K3_LAUNCH(bf16, 128);
#undef K3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
