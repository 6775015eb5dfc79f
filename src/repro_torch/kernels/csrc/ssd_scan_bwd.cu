// K4's backward: the gradients of the Mamba2 SSD chunk scan, for Hopper
// (sm_90a).
//
// The TPU kernel src/repro/kernels/ssd_scan.py:_kernel has no backward (the
// reference's models train through XLA's differentiation of
// models/ssm.py:ssd_chunked); this is the backward of the function K4's
// forward (csrc/ssd_scan.cu) computes, on the model's layout: x (Bt, S, H,
// P) and B, C (Bt, S, G, N) in float32 or bfloat16 read in place through
// their strides, dt (Bt, S, H) f32, A (H,) f32, the cotangents dy (Bt, S,
// H, P) in x's dtype and dh (Bt, H, N, P) f32 of the final state (null:
// zero). Outputs: dx (Bt, S, H, P) in x's dtype, dB and dC (Bt, S, G, N)
// in B's dtype, d(dt) (Bt, S, H) f32 and dA (H,) f32, all contiguous.
//
// Per (b, h), in chunks of 64 steps with cum the inclusive in-chunk sum of
// dt A, every exponent clipped to [-60, 0] (its gradient zero past the
// clip's edges), e_i = exp(cum_i), d_j = exp(cum_last - cum_j),
// k_j = d_j dt_j, E = exp(cum_last), H the state entering the chunk and G
// the gradient of the state leaving it:
//   dx_j = k_j (B G)_j + (M^T dy)_j,      M_ij = (C_i . B_j) w_ij dt_j
//   dB_j = k_j (x G^T)_j + (dS^T C)_j,    dS_ij = (dy_i . x_j) w_ij dt_j
//   dC_i = e_i (dy H^T)_i + (dS B)_i,     w_ij = exp(cum_i - cum_j), i >= j
//   G <- E G + sum_i e_i C_i dy_i^T       (the reverse scan over chunks)
// and d(dt), dA through d(cum): the intra-chunk terms (dy_i . x_j)(C_i .
// B_j) w_ij dt_j for i > j, e_i's C_i . (dy H^T)_i, k_j's B_j . (x G^T)_j
// and E's <G, H>; a reverse in-chunk sum gives d(dt A), hence d(dt) += A
// d(dt A) and dA = sum over (b, t) of dt d(dt A). The plain version is
// repro_torch/kernels/ref.py:ssd_scan_grouped_bwd_ref (the same chunked
// scan in torch ops); the function's own plain version is autograd through
// ref.py:ssd_scan_grouped_ref.
//
// Design (simple and right first: CUDA-core f32, no tensor cores). One
// block of 256 threads (a 16 x 16 grid) per (b, h). Pass 1 runs the
// forward's state recurrence over the chunks (h <- E h + sum_j B_j k_j
// x_j^T, the state in registers) and writes the states entering chunks 1
// .. nc-1 to a global f32 scratch, (Bt, H, nc - 1, N, P): 260 MB at
// mamba2-370m's training shape, written and read once. (Recomputing them
// in the reverse pass would cost a forward scan per chunk; keeping them on
// chip would take 1 MB a block.) Pass 2 walks the chunks backwards with G
// in shared memory (dh at the start): x, dy, B, C and dt are widened to f32
// in shared memory (odd row strides: the 16 x 16 grid's reads are free of
// bank conflicts), H comes from the scratch, and every product is a thread
// tile of 4 x 4 (or 4 x N/16) fmaf sums over shared memory. Each gradient
// of a chunk is complete in the block: dx and d(dt) are written once, dx
// rounded once. dB and dC sum over the H / G heads of their group and dA
// over the batch: each block writes f32 partials ((Bt, S, H, N) for dB
// and dC when G < H; (Bt, H) for dA), and a second kernel sums them in a
// fixed order and rounds once. No float atomics: the result does not
// depend on the schedule. Shared memory 204.6 KB at N 128, P 64 (one
// block an SM).
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at
// mamba2-370m's training shape (Bt 8, S 2048, H 32, P 64, G 1, N 128,
// bf16): x, dy and dx 67.1 MB each, B, C, dB, dC 4.2 MB each, dt and d(dt)
// 2.1 MB each, dh 8.4 MB: 230.7 MB, 68.9 us; the products (the score and
// dy x^T tiles, three against score-shaped tiles, four state-sized ones,
// the state recurrence again: launch/op_analysis.ssd_backward_flops) 77.0
// G operations, 77.9 us at the bf16 peak: bound by operations
// (chip_smoke.py's `[time]` computes both). This design also moves the
// scratch and the partials (1.6 GB) and runs at the CUDA cores' f32 rate:
// 4.9 ms at that shape, 3.9 ms at zamba2-2.7b's (Bt 8, S 1024, H 80, N 64)
// by events (NVIDIA H100 80GB HBM3); PERF.md keeps its times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;         // chunk length, the forward's
constexpr int kMaxN = 128;
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kLdM = kL + 1;   // the score-shaped tiles' row stride
constexpr unsigned kFull = 0xffffffffu;

// Where the operands lie: element strides of x, dy (batch, step, head), dt
// (batch, step, head), A (head), B and C (batch, step, group); every output
// and scratch buffer is contiguous.
struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* dh;   // (batch, heads, n, p) or null
  void* dx;          // (batch, s, heads, p)
  float* ddt;        // (batch, s, heads)
  void* dB;          // (batch, s, groups, n)
  void* dC;
  float* dA;         // (heads,)
  float* dA_part;    // (batch, heads)
  float* dB_part;    // (batch, s, heads, n) when groups < heads, else null
  float* dC_part;
  float* states;     // (batch, heads, nc - 1, n, p)
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, s, heads, groups, n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// exp of an exponent clipped to [-60, 0] (expf, as the forward's f32 path)
__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.0f), 0.0f));
}

// Whether the clip passes v's gradient: inside or on its edges, as
// torch.clamp's backward (an exponent that rounds to 0 off the diagonal,
// after a tiny dt, still carries one; the diagonal terms, whose two sides
// cancel, are left out by index)
__device__ __forceinline__ bool passes(float v) {
  return v >= -60.0f && v <= 0.0f;
}

// the sum over the 16 threads of a row of the 16 x 16 grid (half a warp),
// in every one of them
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// acc[i][j] += sum_k a(r_i, k) b(k, c_j) for this thread's rows r_i = ty +
// 16 i and columns c_j = tx + 16 j of the 16 x 16 grid
template <int RI, int CJ, int K, typename FA, typename FB>
__device__ __forceinline__ void tile_sum(float (&acc)[RI][CJ], FA a, FB b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a(ty + 16 * i, k);
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
  }
}

// Shared memory, in floats. NP: N rounded up to a multiple of 16 (columns
// of B and C, rows of H and G past N are zero).
template <int NP, int P>
struct Smem {
  static constexpr int kLdX = P + 1;   // x, dy (kL x P)
  static constexpr int kLdB = NP + 1;  // B, C (kL x NP)
  static constexpr int kLdH = P + 1;   // H, G (NP x P)
  static constexpr int kXs = 0;
  static constexpr int kDys = kXs + kL * kLdX;
  static constexpr int kBs = kDys + kL * kLdX;
  static constexpr int kCs = kBs + kL * kLdB;
  static constexpr int kHs = kCs + kL * kLdB;
  static constexpr int kGs = kHs + NP * kLdH;
  static constexpr int kMs = kGs + NP * kLdH;   // M (kL x kL)
  static constexpr int kDss = kMs + kL * kLdM;  // dS (kL x kL)
  static constexpr int kCol = kDss + kL * kLdM; // column partials [2][16][kL]
  static constexpr int kVec = kCol + 2 * 16 * kL;  // 8 per-step vectors
  static constexpr int kRed = kVec + 8 * kL;       // one value a warp
  static constexpr int kFloats = kRed + 32;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
};

// Rows [t0, t0 + kL) of a (steps x width) operand into a (kL x COLS) f32
// tile of row stride ld; rows past s and columns past width are zero.
template <int COLS, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long ss, int width, int t0,
                                          int s) {
  for (int i = threadIdx.x; i < kL * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[r * ld + c] = (t0 + r < s && c < width)
                          ? to_f(src[(long long)(t0 + r) * ss + c])
                          : 0.0f;
  }
}

template <typename T, int NP, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_bwd_kernel(const Args g) {
  using Sm = Smem<NP, P>;
  constexpr int kLdX = Sm::kLdX, kLdB = Sm::kLdB, kLdH = Sm::kLdH;
  constexpr int kNJ = NP / 16, kPJ = P / 16;
  static_assert(P == 32 || P == 64, "head dim");
  static_assert(NP % 16 == 0 && NP <= kMaxN, "state size");
  extern __shared__ __align__(16) float sm[];
  float* xs = sm + Sm::kXs;
  float* dys = sm + Sm::kDys;
  float* bs = sm + Sm::kBs;
  float* cs = sm + Sm::kCs;
  float* hs = sm + Sm::kHs;
  float* gs = sm + Sm::kGs;
  float* ms = sm + Sm::kMs;
  float* dss = sm + Sm::kDss;
  float* colV = sm + Sm::kCol;     // [16][kL]: column sums of V by row group
  float* colR = colV + 16 * kL;    // the same of R
  float* dts = sm + Sm::kVec;
  float* cum = dts + kL;
  float* ev = cum + kL;    // exp(clip(cum_i))
  float* dv = ev + kL;     // exp(clip(cum_last - cum_j))
  float* kv = dv + kL;     // d_j dt_j
  float* rowR = kv + kL;   // row sums of R
  float* dev = rowR + kL;  // d e_i = C_i . (dy H^T)_i
  float* dkv = dev + kL;   // d k_j = B_j . (x G^T)_j
  float* red = sm + Sm::kRed;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / g.heads, h = blockIdx.x % g.heads;
  const int grp = h / (g.heads / g.groups);
  const int n = g.n, s = g.s;
  const T* xp = static_cast<const T*>(g.x) + b * g.x_sb + h * g.x_sh;
  const T* dyp = static_cast<const T*>(g.dy) + b * g.dy_sb + h * g.dy_sh;
  const T* bp = static_cast<const T*>(g.B) + b * g.b_sb + grp * g.b_sg;
  const T* cp = static_cast<const T*>(g.C) + b * g.c_sb + grp * g.c_sg;
  const float* dtp = g.dt + b * g.dt_sb + h * g.dt_sh;
  const float a = g.A[h * g.a_sh];
  const int nc = (s + kL - 1) / kL;
  float* states =
      g.states + (long long)blockIdx.x * (nc > 1 ? nc - 1 : 0) * n * P;

  // dt of the chunk at t0 (zero past s), then warp 0: cum, e, d, k (lane l
  // holds steps 2l, 2l + 1; the forward's shuffle scan)
  auto load_dt = [&](int t0) {
    if (tid < kL) {
      dts[tid] = t0 + tid < s ? dtp[(long long)(t0 + tid) * g.dt_ss] : 0.0f;
    }
  };
  auto chunk_scalars = [&]() {
    if (warp == 0) {
      const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
      const float e0 = d0 * a, e1 = d1 * a;
      float incl = e0 + e1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float c0 = excl + e0, c1 = c0 + e1;
      const float last = __shfl_sync(kFull, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ev[2 * lane] = clip_exp(c0);
      ev[2 * lane + 1] = clip_exp(c1);
      const float w0 = clip_exp(last - c0), w1 = clip_exp(last - c1);
      dv[2 * lane] = w0;
      dv[2 * lane + 1] = w1;
      kv[2 * lane] = w0 * d0;
      kv[2 * lane + 1] = w1 * d1;
    }
  };

  // ---- pass 1: the states entering chunks 1 .. nc - 1, to the scratch ----
  {
    float hst[kNJ][kPJ];  // rows ty + 16 i, columns tx + 16 j of the state
    zero(hst);
    for (int c = 0; c + 1 < nc; ++c) {
      const int t0 = c * kL;
      __syncthreads();  // the previous chunk's tiles are read
      load_rows<P>(xs, kLdX, xp, g.x_ss, P, t0, s);
      load_rows<NP>(bs, kLdB, bp, g.b_ss, n, t0, s);
      load_dt(t0);
      __syncthreads();
      chunk_scalars();
      __syncthreads();
      // h <- h E + sum_j (B_j k_j) x_j^T
      float su[kNJ][kPJ];
      zero(su);
      tile_sum<kNJ, kPJ, kL>(
          su, [&](int r, int k) { return bs[k * kLdB + r] * kv[k]; },
          [&](int k, int cc) { return xs[k * kLdX + cc]; });
      const float E = ev[kL - 1];
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          hst[i][j] = hst[i][j] * E + su[i][j];
          if (r < n) {
            states[((long long)c * n + r) * P + tx + 16 * j] = hst[i][j];
          }
        }
      }
    }
  }

  // ---- pass 2: the chunks in reverse, G the gradient of the state leaving
  // the chunk (dh at the start) ----
  for (int i = tid; i < NP * P; i += kThreads) {
    const int r = i / P, c = i % P;
    gs[r * kLdH + c] =
        (g.dh != nullptr && r < n)
            ? g.dh[((long long)blockIdx.x * n + r) * P + c]
            : 0.0f;
  }
  float dA_acc = 0.0f;  // warp 0's, the same in every lane
  for (int ck = nc - 1; ck >= 0; --ck) {
    const int t0 = ck * kL;
    __syncthreads();  // the previous chunk is done with every tile
    load_rows<P>(xs, kLdX, xp, g.x_ss, P, t0, s);
    load_rows<P>(dys, kLdX, dyp, g.dy_ss, P, t0, s);
    load_rows<NP>(bs, kLdB, bp, g.b_ss, n, t0, s);
    load_rows<NP>(cs, kLdB, cp, g.c_ss, n, t0, s);
    for (int i = tid; i < NP * P; i += kThreads) {
      const int r = i / P, c = i % P;
      hs[r * kLdH + c] =
          (ck > 0 && r < n) ? states[((long long)(ck - 1) * n + r) * P + c]
                            : 0.0f;
    }
    load_dt(t0);
    __syncthreads();
    chunk_scalars();
    __syncthreads();

    // A: S = C B^T and Q = dy x^T on the chunk's 64 x 64 tile; M, dS to
    // shared memory; V = Q S w and R = V dt_j (i > j, w's clip passing):
    // R's row sums, and V's and R's column sums by row group
    {
      float sa[4][4], qa[4][4];
      zero(sa);
      zero(qa);
      tile_sum<4, 4, NP>(sa, [&](int r, int k) { return cs[r * kLdB + k]; },
                         [&](int k, int cc) { return bs[cc * kLdB + k]; });
      tile_sum<4, 4, P>(qa, [&](int r, int k) { return dys[r * kLdX + k]; },
                        [&](int k, int cc) { return xs[cc * kLdX + k]; });
      float rr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j;
          float m = 0.0f, ds = 0.0f;
          if (r >= cc) {
            const float v = cum[r] - cum[cc];
            const float w = clip_exp(v);
            const float dtj = dts[cc];
            m = sa[i][j] * w * dtj;
            ds = qa[i][j] * w * dtj;
            const float vv = qa[i][j] * sa[i][j] * w;
            const float rv = (r > cc && passes(v)) ? vv * dtj : 0.0f;
            rr[i] += rv;
            cv[j] += vv;
            cr[j] += rv;
          }
          ms[r * kLdM + cc] = m;
          dss[r * kLdM + cc] = ds;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = row_sum(rr[i]);
        if (tx == 0) rowR[ty + 16 * i] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        colV[ty * kL + tx + 16 * j] = cv[j];
        colR[ty * kL + tx + 16 * j] = cr[j];
      }
    }
    __syncthreads();  // M and dS are complete

    // B1: dx = k (B G) + M^T dy, written once in x's dtype
    {
      float acc[4][kPJ];
      zero(acc);
      tile_sum<4, kPJ, NP>(acc, [&](int r, int k) { return bs[r * kLdB + k]; },
                           [&](int k, int cc) { return gs[k * kLdH + cc]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kr = kv[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < kPJ; ++j) acc[i][j] *= kr;
      }
      tile_sum<4, kPJ, kL>(acc, [&](int r, int k) { return ms[k * kLdM + r]; },
                           [&](int k, int cc) { return dys[k * kLdX + cc]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t < s) {
          T* row = static_cast<T*>(g.dx) +
                   (((long long)b * s + t) * g.heads + h) * P;
#pragma unroll
          for (int j = 0; j < kPJ; ++j) put(row + tx + 16 * j, acc[i][j]);
        }
      }
    }

    // dB or dC rows of this chunk: f32 partials per head when G < H, else
    // the gradient itself in the input's dtype
    auto store_bc = [&](float (&acc)[4][kNJ], float* part, void* out) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t < s) {
#pragma unroll
          for (int j = 0; j < kNJ; ++j) {
            const int nn = tx + 16 * j;
            if (nn < n) {
              if (part != nullptr) {
                part[(((long long)b * s + t) * g.heads + h) * n + nn] =
                    acc[i][j];
              } else {
                put(static_cast<T*>(out) +
                        (((long long)b * s + t) * g.groups + grp) * n + nn,
                    acc[i][j]);
              }
            }
          }
        }
      }
    };

    // B2: dB = k (x G^T) + dS^T C; d k_j = B_j . (x G^T)_j
    {
      float acc[4][kNJ];
      zero(acc);
      tile_sum<4, kNJ, P>(acc, [&](int r, int k) { return xs[r * kLdX + k]; },
                          [&](int k, int cc) { return gs[cc * kLdH + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          part += bs[r * kLdB + tx + 16 * j] * acc[i][j];
        }
        part = row_sum(part);
        if (tx == 0) dkv[r] = part;
        const float kr = kv[r];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] *= kr;
      }
      tile_sum<4, kNJ, kL>(
          acc, [&](int r, int k) { return dss[k * kLdM + r]; },
          [&](int k, int cc) { return cs[k * kLdB + cc]; });
      store_bc(acc, g.dB_part, g.dB);
    }

    // B3: dC = e (dy H^T) + dS B; d e_i = C_i . (dy H^T)_i
    {
      float acc[4][kNJ];
      zero(acc);
      tile_sum<4, kNJ, P>(acc, [&](int r, int k) { return dys[r * kLdX + k]; },
                          [&](int k, int cc) { return hs[cc * kLdH + k]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          part += cs[r * kLdB + tx + 16 * j] * acc[i][j];
        }
        part = row_sum(part);
        if (tx == 0) dev[r] = part;
        const float er = ev[r];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] *= er;
      }
      tile_sum<4, kNJ, kL>(
          acc, [&](int r, int k) { return dss[r * kLdM + k]; },
          [&](int k, int cc) { return bs[k * kLdB + cc]; });
      store_bc(acc, g.dC_part, g.dC);
    }

    // B4: <G, H>, E's gradient, over the block in a fixed order
    {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          const int o = (ty + 16 * i) * kLdH + tx + 16 * j;
          part += gs[o] * hs[o];
        }
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();  // G and H are read; the per-step sums are complete

    // C1: G <- E G + sum_i e_i C_i dy_i^T, each thread its own elements
    {
      float acc[kNJ][kPJ];
      zero(acc);
      tile_sum<kNJ, kPJ, kL>(
          acc, [&](int r, int k) { return cs[k * kLdB + r] * ev[k]; },
          [&](int k, int cc) { return dys[k * kLdX + cc]; });
      const float E = ev[kL - 1];
#pragma unroll
      for (int i = 0; i < kNJ; ++i) {
#pragma unroll
        for (int j = 0; j < kPJ; ++j) {
          float* gp = gs + (ty + 16 * i) * kLdH + tx + 16 * j;
          *gp = *gp * E + acc[i][j];
        }
      }
    }

    // C2: warp 0, steps 2 lane and 2 lane + 1: d(dt) and d(cum), then the
    // reverse in-chunk sum d(dt A)_k = sum_{i >= k} d(cum)_i, d(dt) += A
    // d(dt A), dA += dt d(dt A)
    if (warp == 0) {
      float dE = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) dE += red[w];
      const float E = ev[kL - 1], cl = cum[kL - 1];
      float ddt_v[2], dcum_v[2], tsum = 0.0f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = 2 * lane + q;
        float sv = 0.0f, sr = 0.0f;
#pragma unroll
        for (int y = 0; y < 16; ++y) {
          sv += colV[y * kL + r];
          sr += colR[y * kL + r];
        }
        const float dk = dkv[r];
        ddt_v[q] = sv + dv[r] * dk;
        const float tq = (r < kL - 1 && passes(cl - cum[r]))
                             ? dts[r] * dk * dv[r]
                             : 0.0f;
        tsum += tq;
        const float de = passes(cum[r]) ? dev[r] * ev[r] : 0.0f;
        dcum_v[q] = rowR[r] - sr + de - tq;
      }
      tsum = warp_sum(tsum);
      if (lane == 31) dcum_v[1] += tsum + (passes(cl) ? dE * E : 0.0f);
      float incl = dcum_v[0] + dcum_v[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(kFull, incl, off);
        if (lane + off < 32) incl += u;
      }
      float excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = 0.0f;
      const float dda1 = excl + dcum_v[1], dda0 = dda1 + dcum_v[0];
      ddt_v[0] += a * dda0;
      ddt_v[1] += a * dda1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int t = t0 + 2 * lane + q;
        if (t < s) g.ddt[((long long)b * s + t) * g.heads + h] = ddt_v[q];
      }
      dA_acc += warp_sum(dts[2 * lane] * dda0 + dts[2 * lane + 1] * dda1);
    }
  }
  if (tid == 0) g.dA_part[blockIdx.x] = dA_acc;
}

// dB and dC summed over the heads of each group (when G < H), in head
// order, rounded once; dA summed over the batch in batch order (the last
// block)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_finish_kernel(const Args g, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g.dB_part != nullptr && i < total) {
    const int rep = g.heads / g.groups;
    const int nn = (int)(i % g.n);
    const long long row = i / g.n;  // (b s + t) groups + grp
    const int grp = (int)(row % g.groups);
    const long long base =
        ((row / g.groups) * g.heads + (long long)grp * rep) * g.n + nn;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += g.dB_part[base + (long long)r * g.n];
      sc += g.dC_part[base + (long long)r * g.n];
    }
    put(static_cast<T*>(g.dB) + i, sb);
    put(static_cast<T*>(g.dC) + i, sc);
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (int hh = threadIdx.x; hh < g.heads; hh += kThreads) {
      float sa = 0.0f;
      for (int b = 0; b < g.batch; ++b) sa += g.dA_part[b * g.heads + hh];
      g.dA[hh] = sa;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Lets `kernel` take `smem` bytes of dynamic shared memory; each launcher
// calls it once (a function-local static), so no launch inside a CUDA
// graph capture sets a function attribute.
int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NP, int P>
int launch_typed(const Args& g, cudaStream_t stream) {
  auto kernel = ssd_scan_bwd_kernel<T, NP, P>;
  const size_t smem = Smem<NP, P>::kBytes;
  static const int smem_rc = set_smem((const void*)kernel, smem);
  if (smem_rc) return smem_rc;
  kernel<<<g.batch * g.heads, kThreads, smem, stream>>>(g);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long total =
      g.dB_part != nullptr ? (long long)g.batch * g.s * g.groups * g.n : 0;
  const long long blocks = total > 0 ? (total + kThreads - 1) / kThreads : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_scan_bwd_finish_kernel<T>
      <<<(int)blocks, kThreads, 0, stream>>>(g, total);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(const Args& g, cudaStream_t stream) {
  if (g.n <= 16) return launch_typed<T, 16, P>(g, stream);
  if (g.n <= 32) return launch_typed<T, 32, P>(g, stream);
  if (g.n <= 64) return launch_typed<T, 64, P>(g, stream);
  return launch_typed<T, 128, P>(g, stream);
}

}  // namespace

extern "C" {

// Launches K4's backward on `stream`: the main kernel, batch x heads
// blocks, then the finishing sums. Inputs as the forward's entry takes them
// (x, B, C and dy by pointer and element strides, the last dimension
// contiguous; A indexed by head through a_sh) plus dy and dh (null: zero;
// else (batch, heads, n, p) f32 contiguous). Outputs and scratch are
// contiguous and allocated by the caller: dx (batch, s, heads, p) and dB,
// dC (batch, s, groups, n) in x's dtype; ddt (batch, s, heads), dA (heads),
// dA_part (batch, heads), states (batch, heads, max(nc - 1, 0), n, p) f32
// (nc = ceil(s / 64)); dB_part, dC_part (batch, s, heads, n) f32 when
// groups < heads, else null. dtype 0 float32 or 1 bfloat16; p 32 or 64, n
// in [1, 128], heads a multiple of groups. Returns cudaGetLastError() after
// the launches (0 on success) or cudaErrorInvalidValue for shapes it does
// not take.
int ssd_scan_bwd_launch(
    const void* x, long long x_sb, long long x_ss, long long x_sh,
    const void* dt, long long dt_sb, long long dt_ss, long long dt_sh,
    const void* A, long long a_sh, const void* B, long long b_sb,
    long long b_ss, long long b_sg, const void* C, long long c_sb,
    long long c_ss, long long c_sg, const void* dy, long long dy_sb,
    long long dy_ss, long long dy_sh, const void* dh, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dA_part, void* dB_part,
    void* dC_part, void* states, int batch, int s, int heads, int groups,
    int p, int n, int dtype, void* stream) {
  if (batch < 0 || s < 0 || heads < 1 || groups < 1 || heads % groups ||
      n < 1 || n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  if ((groups < heads) != (dB_part != nullptr && dC_part != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)batch * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  Args g{x,
         (const float*)dt,
         (const float*)A,
         B,
         C,
         dy,
         (const float*)dh,
         dx,
         (float*)ddt,
         dB,
         dC,
         (float*)dA,
         (float*)dA_part,
         (float*)dB_part,
         (float*)dC_part,
         (float*)states,
         x_sb, x_ss, x_sh,
         dt_sb, dt_ss, dt_sh,
         a_sh,
         b_sb, b_ss, b_sg,
         c_sb, c_ss, c_sg,
         dy_sb, dy_ss, dy_sh,
         batch, s, heads, groups, n};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && p == 32) return launch_p<float, 32>(g, st);
  if (dtype == 0 && p == 64) return launch_p<float, 64>(g, st);
  if (dtype == 1 && p == 32) return launch_p<bf16, 32>(g, st);
  if (dtype == 1 && p == 64) return launch_p<bf16, 64>(g, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
