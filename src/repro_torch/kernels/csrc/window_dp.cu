// K1: the CHC window min-plus DP (paper Eq. 10) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/window_dp.py:_kernel (the Pallas
// `window_dp`). B independent rows; row b holds slot_cost[b] (w1, tn+1) and
// gain[b] (U+1), U = w1 * tn. For each slot tau,
//   C'[u] = min_k C[u-k] + cost[tau, k]   (out of range = BIG, strict `<`
//                                          so the smallest k wins ties),
// recording choice[tau, u]; then obj = max_u (gain[u] - C[u]) over C < BIG/2
// with the first argmax u*, and the backtrack n_tot[tau] = choice[tau, u],
// u -= n_tot[tau]. Only adds and compares: the result is bit-equal to the
// plain PyTorch DP (repro_torch/kernels/ref.py:window_dp_ref).
//
// Design: one warp per row; the unit axis u is strided across the 32 lanes
// (U+1 = 97 on the main path, so 4 units per lane, the last masked). Per
// warp, shared memory holds the row's cost table, the DP state C padded on
// the left with tn BIG entries (double-buffered, so C[u-k] is a plain
// shifted read), and the int8 choices [w1][U+1] (tn <= 127). The objective
// argmax is a (value, index) warp-shuffle reduction keeping the smaller
// index on ties; lane 0 backtracks through shared memory. Device memory is
// read once (slot_cost, gain) and written once (n_tot, obj).
//
// Bound on one H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the main-path shape
// B = 105,000, w1 = 6, tn = 16: it moves 42.84 + 40.74 MB in and
// 2.52 + 0.42 MB out, 86.5 MB or 25.8 us; it does B*w1*(tn+1)*(U+1) =
// 1.04 G candidate terms, each one f32 add and one f32 compare (the
// min-plus analogue of a multiply-add), 2.08 G operations or 31.0 us.
// The larger, 31.0 us, is the bound; chip_smoke.py reports the kernel's
// time beside it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e9f;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTableN = 127;  // choices are stored as int8

// Bytes of shared memory one warp needs, rounded up to 16.
size_t warp_smem_bytes(int w1, int tn) {
  const size_t kw = tn + 1, u1 = (size_t)w1 * tn + 1, plen = tn + u1;
  const size_t bytes = (w1 * kw + 2 * plen) * sizeof(float) + w1 * u1;
  return (bytes + 15) & ~size_t(15);
}

__global__ void window_dp_kernel(const float* __restrict__ slot_cost,
                                 const float* __restrict__ gain,
                                 int* __restrict__ n_tot,
                                 float* __restrict__ obj,
                                 long long b, int w1, int tn,
                                 int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= b) return;  // the whole warp leaves together

  const int kw = tn + 1;
  const int u1 = w1 * tn + 1;
  const int plen = tn + u1;
  float* s_cost = reinterpret_cast<float*>(smem + (size_t)warp * warp_bytes);
  float* cur = s_cost + w1 * kw;
  float* nxt = cur + plen;
  int8_t* choice = reinterpret_cast<int8_t*>(nxt + plen);

  const float* cost_row = slot_cost + row * (long long)(w1 * kw);
  for (int i = lane; i < w1 * kw; i += 32) s_cost[i] = cost_row[i];
  // C = [BIG x tn | 0, BIG, ...]; the left pad of both buffers stays BIG
  for (int i = lane; i < plen; i += 32) {
    cur[i] = (i == tn) ? 0.0f : kBig;
    nxt[i] = kBig;
  }
  __syncwarp();

  // ---- forward min-plus DP over slots ----
  for (int tau = 0; tau < w1; ++tau) {
    const float* crow = s_cost + tau * kw;
    for (int u = lane; u < u1; u += 32) {
      float best = cur[tn + u] + crow[0];
      int bk = 0;
      for (int k = 1; k <= tn; ++k) {
        const float cand = cur[tn + u - k] + crow[k];
        if (cand < best) {  // keep the smallest k on ties
          best = cand;
          bk = k;
        }
      }
      nxt[tn + u] = best;
      choice[tau * u1 + u] = (int8_t)bk;
    }
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // ---- objective argmax over prefix length u (first max wins) ----
  const float* g = gain + row * (long long)u1;
  float bv = -INFINITY;
  int bi = u1;  // sentinel: this lane has seen no unit yet
  for (int u = lane; u < u1; u += 32) {
    const float c = cur[tn + u];
    const float o = (c < kBig * 0.5f) ? (g[u] - c) : -INFINITY;
    if (bi == u1 || o > bv) {
      bv = o;
      bi = u;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }

  // ---- backtrack through the shared choices ----
  if (lane == 0) {
    int u = bi;
    for (int tau = w1 - 1; tau >= 0; --tau) {
      const int k = choice[tau * u1 + u];
      n_tot[row * w1 + tau] = k;
      u -= k;
    }
    obj[row] = bv;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over b rows. Returns cudaGetLastError() after the
// launch (0 on success) or cudaErrorInvalidValue for shapes it does not take.
int window_dp_launch(const void* slot_cost, const void* gain, void* n_tot,
                     void* obj, long long b, int w1, int tn, void* stream) {
  if (b < 0 || w1 < 1 || tn < 1 || tn > kMaxTableN) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  const size_t warp_bytes = warp_smem_bytes(w1, tn);
  const size_t smem = warp_bytes * kWarpsPerBlock;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  window_dp_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                     (cudaStream_t)stream>>>(
      (const float*)slot_cost, (const float*)gain, (int*)n_tot, (float*)obj,
      b, w1, tn, (int)warp_bytes);
  return (int)cudaGetLastError();
}

const char* window_dp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
