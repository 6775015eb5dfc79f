// K3: forward flash attention (online softmax), causal and / or sliding
// window, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel (the
// Pallas `flash_attention`). q (BH, Sq, D), k and v (BH, Sk, D), heads
// folded into the batch (GQA repetition is the caller's, as on the TPU),
// D in {64, 80, 128}, float32 or bfloat16; o (BH, Sq, D) in q's dtype. The
// function and its constants are the TPU kernel's: q is scaled by
// sm_scale = 1/sqrt(D) before q k^T, query and key positions both count
// from 0 (also when Sq != Sk), a masked score is -2e38 (causal: k_pos <=
// q_pos; window: k_pos > q_pos - window), and the running max, the running
// sum and the output accumulator are f32; the output is acc / max(l, 1e-30).
// The plain version is repro_torch/kernels/ref.py:flash_attention_ref.
//
// Design. One block of 256 threads per (bh, 64-row query tile). The query
// tile (pre-scaled, f32) stays in shared memory while 64-row K and V tiles
// stream through it, widened to f32. Scores, the softmax and both products
// are f32 on the CUDA cores: thread (ty, tx) of a 16 x 16 grid holds a
// 4 x 4 slice of the score tile (rows ty + 16 i, columns tx + 16 j) and
// rows ty + 16 i, columns tx + 16 j of the output accumulator; row max and
// row sum are 16-lane shuffle reductions. Key tiles wholly past the
// diagonal (causal) or wholly before the window are skipped: in the TPU
// kernel they contribute exp(-2e38 - m) = 0 or are wiped by the correction
// factor exp(-2e38 - m) = 0 once a real score arrives, so skipping them
// gives the same result for every row that keeps a key. (A row whose keys
// are all masked, which only a window with Sq >= Sk + window leaves, would
// differ: the wrapper refuses that case.) Keys past Sk are -inf (they do
// not exist), query rows past Sq are not stored. No tensor cores, TMA or pipelining yet:
// simple and right first.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at llama2-7b's
// prefill, BH = 8 x 32 = 256, S = 1024, D = 128, causal, bf16: q, k, v in
// and o out move 268.4 MB, 80.1 us; the S (S + 1) / 2 = 524,800 unmasked
// (q, k) pairs of a head cost 4 D operations each (q k^T and p v), 68.8 G
// operations, 69.6 us. Bound by bytes: 80.1 us.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;
constexpr int kBKV = 64;
constexpr int kThreads = 256;
constexpr float kMaskFill = -2.0e38f;
static_assert(kBQ == kBKV, "load_rows stages 64-row tiles of q, k and v");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows x D elements of a (nrows, D) matrix into shared memory (ld_s), as
// f32 times `mul`, zero past nrows.
template <typename T, int D>
__device__ void load_rows(float* dst, int ld_s, const T* src, int row0,
                          int nrows, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecs = D / kVec;
  for (int idx = threadIdx.x; idx < kBQ * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * kVec;
    float* d = dst + r * ld_s + c;
    if (row0 + r < nrows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = to_f32(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) d[i] = 0.0f;
    }
  }
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // q (BQ x D+1), k (BKV x D+1), v (BKV x D), p (BQ x BKV+1), all f32
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBKV * (D + 1) +
                          (size_t)kBKV * D + (size_t)kBQ * (kBKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int sq,
                     int sk, int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLdQ = D + 1, kLdK = D + 1, kLdV = D, kLdP = kBKV + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  float* qs = smem;
  float* ks = qs + kBQ * kLdQ;
  float* vs = ks + kBKV * kLdK;
  float* ps = vs + kBKV * kLdV;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * (size_t)sq * D;
  const T* kb = k + bh * (size_t)sk * D;
  const T* vb = v + bh * (size_t)sk * D;

  load_rows<T, D>(qs, kLdQ, qb, q0, sq, sm_scale);

  float m_run[4], l_run[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMaskFill;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  int kt_end = (sk + kBKV - 1) / kBKV;
  int kt_begin = 0;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBKV + 1);
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBKV;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_rows<T, D>(ks, kLdK, kb, k0, sk, 1.0f);
    load_rows<T, D>(vs, kLdV, vb, k0, sk, 1.0f);
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kMaskFill;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        float sv = ok ? s[i][j] : kMaskFill;
        if (kp >= sk) sv = -INFINITY;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
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
      T* orow = o + (bh * (size_t)sq + row) * D;
#pragma unroll
      for (int j = 0; j < kCols; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)o, sq, sk, causal,
                                           window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: o (bh, sq, d) = softmax(q k^T * sm_scale + mask)
// v for q (bh, sq, d), k and v (bh, sk, d), contiguous, 16-byte aligned.
// window <= 0 means no window. dtype 0 is float32, 1 is bfloat16. Returns
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for shapes it does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bh, int sq, int sk, int d, int causal,
                           int window, float sm_scale, int dtype,
                           void* stream) {
  if (bh < 0 || bh > 65535 || sq < 0 || sk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  if (dtype == 0 && d == 80)
    return launch<float, 80>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  if (dtype == 1 && d == 64)
    return launch<bf16, 64>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  if (dtype == 1 && d == 80)
    return launch<bf16, 80>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  if (dtype == 1 && d == 128)
    return launch<bf16, 128>(q, k, v, o, bh, sq, sk, causal, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
