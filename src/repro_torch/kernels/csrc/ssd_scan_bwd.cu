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
// (= x_j . (B G)_j) and E's <G, H>; a reverse in-chunk sum gives d(dt A),
// hence d(dt) += A d(dt A) and dA = sum over (b, t) of dt d(dt A). The
// plain version is repro_torch/kernels/ref.py:ssd_scan_grouped_bwd_ref
// (the same chunked scan in torch ops); the function's own plain version
// is autograd through ref.py:ssd_scan_grouped_ref.
//
// bfloat16 (the training path): Hopper's warpgroup MMA (wgmma.mma_async
// m64n64k16, f32 += bf16 x bf16) for every product; no mma.sync, no f32
// copy of x, dy, B or C in shared memory. Three kernels a launch, on one
// stream, no float atomics, every sum in a fixed order:
//   1. states: one warpgroup per (b, h, direction) walks the chunks, the
//      forward one writing H_c (h <- E h + B^T (k o x)), the reverse one
//      G_c (G <- E G + C^T (e o dy), from dh), each before the chunk's
//      update, as hi + lo bf16 halves to a scratch of (Bt, H, nc, 2, NP,
//      64) (NP: N padded to 64 or 128); the state is the accumulator (N / 64
//      m-tiles), scaled by E before B^T (C^T), read MN-major from the B (C)
//      tile itself, times the weighted rows' hi and lo halves is added;
//   2. gradients: one block of two warpgroups per (run of consecutive heads
//      of one group, chunk, b); the run length is the caller's, so that the
//      grid has at least 2 blocks an SM (on an H100's 132 SMs at
//      mamba2-370m's training shape 2 runs of 16 heads, 512 blocks; at
//      zamba2-2.7b's 3 runs of 27, 27, 26, 384 blocks; 3 blocks an SM gave
//      the same times, runs of 20 at zamba2-2.7b's shape). S^T =
//      B C^T once for the run (the heads of a group share it). Warpgroup 0
//      per head: Q^T = x dy^T; M^T, dS^T, V and R in the accumulators (rows
//      j, columns i: the A fragments of products over i); dx = k o (B G) +
//      M^T dy with G and M^T as hi + lo halves (M^T in registers, as K3's
//      backward holds P); d k_j = x_j . (B G)_j; the run's sum of dS^T;
//      warp 0 then the reverse in-chunk sum for d(dt) and dA's chunk
//      partial. Warpgroup 1 per head: dB += k o (x G^T) and dC += e o (dy
//      H^T) (G, H hi + lo) in its accumulators, d e_i = C_i . (dy H^T)_i
//      and <G, H>. After the run dB += (sum dS^T) C and dC += (sum dS) B,
//      the sum as hi + lo halves in one swizzled tile read K-major and
//      MN-major (dS's products are linear, and C, B are the group's: one
//      product a run, not a head), and the run's f32 partials go to a
//      scratch (Bt, S, G x runs, N);
//   3. finish: dB and dC summed over the runs in order and rounded once,
//      dA over the (b, chunk) partials in order.
//   Every f32 operand of a product is fed as hi + lo bf16 halves (x_hi =
//   bf16(x), x_lo = bf16(x - x_hi)): M, dS, G, H, k o x and e o dy. One
//   bf16 for any of them takes its gradients' worst error to 0.6-0.85 of
//   the bf16 GRAD_TOL, all six to 0.92 (tests/test_torch_kernel_numerics.py
//   emulates this arithmetic). Tiles are bf16 in wgmma's canonical layout
//   with the 128-byte swizzle, copied by TMA (tensor maps encoded at each
//   launch through libcuda's cuTensorMapEncodeTiled, found with dlsym) from
//   the strided views (x, B, C as the conv output's slices: their row
//   stride is a multiple of 16 bytes, which the wrapper checks); columns
//   past P or N and steps past S are the copies' zero fill. The gradient
//   kernel's per-head tiles (x, dy, G and H halves: 80 KB at N 128) come
//   through a ring of 2 stages on mbarriers whose wait traps after 2^24
//   polls rather than hang. The halves of k o x (e o dy) and of the sum of
//   dS^T are written to shared memory by the threads and read by wgmma
//   after a proxy fence; the states leave through shared memory by TMA
//   stores. Shared memory (ssd_scan_bwd_bf16_smem_bytes): the states kernel
//   98.3 / 66.3 KB at N 128 / 64 (2 / 3 blocks an SM), the gradient kernel
//   212.3 / 132.3 KB (one block an SM).
// float32 (the f32 checks and tests): the CUDA cores, as the f32 tolerance
//   excludes TF32 and bf16 halves. One block of 256 threads (a 16 x 16
//   grid) per (b, h): pass 1 writes the states entering chunks 1 .. nc-1
//   to an f32 scratch, (Bt, H, nc - 1, N, P); pass 2 walks the chunks
//   backwards with G in shared memory and every product a thread tile of 4
//   x 4 (or 4 x N/16) fmaf sums over f32 tiles in shared memory; per-head
//   dB / dC partials (G < H) and per-block dA partials are summed by the
//   finishing kernel.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at
// mamba2-370m's training shape (Bt 8, S 2048, H 32, P 64, G 1, N 128,
// bf16): x, dy and dx 67.1 MB each, B, C, dB, dC 4.2 MB each, dt and d(dt)
// 2.1 MB each, dh 8.4 MB: 230.7 MB, 68.9 us; the products
// (launch/op_analysis.ssd_backward_flops: S and dS's two products over N
// once a group, the rest once a head) 52.1 G operations, 52.7 us at the
// bf16 peak: bound by bytes (chip_smoke.py's `[time]` computes both).
// This design also moves the two state scratches (268.4 MB each, written
// once and read once: 1.07 GB, >= 320 us at 3.35 TB/s) and issues 100.4 G
// operations (hi + lo halves counted; chip_smoke._k4_bwd_issued_ops).
// Measured (chip_smoke.py `[time]`, 5 launches in a CUDA graph; NVIDIA
// H100 80GB HBM3, 700.00 W): 660.1 us at that shape (152.1 TFLOP/s
// issued; the f32 CUDA-core design before it 4,810.3 us), 588.3 us at
// zamba2-2.7b's (Bt 8, S 1024, H 80, N 64; 3,796.9 before). Of a launch
// (tools/k4_bwd_phases.py: device time a kernel, cycles a step of each
// phase) the states kernel takes 253.3 / 196.5 us at the two shapes, near
// its 537 / 336 MB of writes, the gradient kernel 373.9 / 378.8 us (its
// warpgroup 0's elementwise work and warp 0's serial reverse sum set a
// head's pace while warpgroup 1 waits a third of it), the finishing sums
// 31.6 / 12.0 us. PERF.md keeps the times.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

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
  float* dA_part;    // f32: (batch, heads); bf16: (batch x nc, heads)
  float* dB_part;    // f32: (batch, s, heads, n) when groups < heads, else
  float* dC_part;    // null; bf16: (batch, s, groups x rpg, n)
  float* states;     // f32: (batch, heads, nc - 1, n, p)
  void* hs;          // bf16: (batch, heads, nc, 2, np, 64), the states
  void* gs;          // entering and the state gradients leaving each chunk
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, s, heads, groups, n, p;
  int run, rpg;      // bf16: heads a run, runs a group
};

__device__ __forceinline__ float to_f(float v) { return v; }
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

// dB and dC summed over the rep partials of each group (the f32 path: its
// heads, when G < H; the bf16 path: its runs), in order, rounded once; dA
// summed over its dA_rows partial rows in order (the last block)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_finish_kernel(const Args g, long long total, int rep,
                               int dA_rows) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g.dB_part != nullptr && i < total) {
    const int nn = (int)(i % g.n);
    const long long row = i / g.n;  // (b s + t) groups + grp
    const int grp = (int)(row % g.groups);
    const long long base =
        ((row / g.groups) * g.groups * rep + (long long)grp * rep) * g.n +
        nn;
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
      for (int b = 0; b < dA_rows; ++b) {
        sa += g.dA_part[(long long)b * g.heads + hh];
      }
      g.dA[hh] = sa;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: warpgroup MMA
// ---------------------------------------------------------------------------

constexpr int kWg = 128;                // threads of a warpgroup
constexpr uint32_t kRowB = 128;         // bytes a tile row: 64 bf16, the swizzle
constexpr uint32_t kBlk = kL * kRowB;   // a 64 x 64 tile or column block

// The tiles in shared memory, bf16 in wgmma's canonical layout with the
// 128-byte swizzle (the 16-byte chunk c of row r at chunk c ^ (r & 7), as
// TMA writes it; every tile starts on a 1,024-byte boundary): x and dy 64
// steps x 64 (P padded with zeros), B and C 64 steps x NP in NP / 64
// column blocks, a state half (hi or lo) NP x 64. NP is N padded to 64 or
// 128 (the padding is zero in B, C and the states).
template <int NP>
struct Bf {
  static constexpr int kNH = NP / 64;                // 64-column halves of N
  static constexpr uint32_t kBC = kNH * kBlk;        // B or C
  static constexpr uint32_t kSt = NP * kRowB;        // a state half
  // the gradient kernel: B, C, a ring of 2 stages (x, dy, G hi, lo, H hi,
  // lo of one head), the run's sum of dS^T (hi, lo); 13 vectors of 64
  // floats and 4 more
  static constexpr uint32_t kStage = 2 * kBlk + 4 * kSt;
  static constexpr uint32_t kGradTiles = 2 * kBC + 2 * kStage + 2 * kBlk;
  static constexpr size_t kGradBytes = 1024 + kGradTiles + 4 * (13 * kL + 4);
  // the states kernel: a ring of 2 (B or C, x or dy), the weighted rows'
  // hi and lo tiles, the state's hi and lo halves on their way out, 5
  // vectors of 64 floats
  static constexpr uint32_t kRing = kBC + kBlk;
  static constexpr size_t kStatesBytes = 1024 + 2 * kRing + 2 * kBlk +
                                         2 * kSt + 4 * 5 * kL;
};

// The bf16 operands as TMA tensor maps: x and dy (P, H, S, Bt), B and C
// (N, G, S, Bt), read where they lie (box 64 x 1 x 64 x 1: one 64 x 64
// tile, columns and rows past the tensor's end zero-filled), and the two
// state scratches, (rows, 64) with an NP-row box.
struct Maps {
  CUtensorMap x, dy, b, c, hs, gs;
};

// The 64 x 64 tile at (col0, k, t0, b) of a 4-D map into dst, completing
// on bar (one thread issues it).
__device__ __forceinline__ void tma_4d(unsigned char* dst,
                                       const CUtensorMap& map, uint64_t* bar,
                                       int col0, int k, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          tc::smem_addr(dst)),
      "l"(&map), "r"(tc::smem_addr(bar)), "r"(col0), "r"(k), "r"(t0), "r"(b)
      : "memory");
}

// The NP x 64 state half at row0 of a 2-D map into dst.
__device__ __forceinline__ void tma_2d(unsigned char* dst,
                                       const CUtensorMap& map, uint64_t* bar,
                                       int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(&map), "r"(tc::smem_addr(bar)), "r"(0), "r"(row0)
      : "memory");
}

// The NP x 64 state half in src to row0 of a 2-D map, by TMA (one thread
// issues it, then commits the bulk group).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap& map,
                                             const unsigned char* src,
                                             int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(&map),
      "r"(tc::smem_addr(src)), "r"(0), "r"(row0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed bulk stores have read their shared
// memory (kRead) or are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The descriptor of a tile as a K-major operand (its rows are M or N, 8-row
// groups 1,024 bytes apart): k-step kk reads columns [16 kk, 16 kk + 16),
// in column block kk / 4.
__device__ __forceinline__ uint64_t kmaj(uint32_t base, int kk) {
  return hop::desc(base + (kk >> 2) * kBlk + (kk & 3) * 32, 16, 1024, 1);
}

// ... as an MN-major operand (its rows are K, its 64 columns M or N): k-step
// kk reads rows [16 kk, 16 kk + 16).
__device__ __forceinline__ uint64_t mnmaj(uint32_t base, int kk) {
  return hop::desc(base + kk * 16 * kRowB, kBlk, 1024, 1);
}

// Byte offset of element pair (row r, columns 8 j + 2 t, +1) in a 64-wide
// swizzled tile.
__device__ __forceinline__ uint32_t sw_off(int r, int j, int t) {
  return r * kRowB + ((j ^ (r & 7)) << 4) + 4 * t;
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(2 * kWg) : "memory");
}

// Warp 0: the chunk's per-step scalars from its dt (lane l holds steps 2 l
// and 2 l + 1; zero past s): cum (the forward's shuffle scan), e = exp(cum),
// d = exp(cum_last - cum), k = d dt, each exponent clipped.
__device__ __forceinline__ void chunk_scalars(const float (&dtv)[2], float a,
                                              float* dts, float* cum,
                                              float* ev, float* dv,
                                              float* kv) {
  const int lane = threadIdx.x & 31;
  const float e0 = dtv[0] * a, e1 = dtv[1] * a;
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
  const float w0 = clip_exp(last - c0), w1 = clip_exp(last - c1);
  dts[2 * lane] = dtv[0];
  dts[2 * lane + 1] = dtv[1];
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  ev[2 * lane] = clip_exp(c0);
  ev[2 * lane + 1] = clip_exp(c1);
  dv[2 * lane] = w0;
  dv[2 * lane + 1] = w1;
  kv[2 * lane] = w0 * dtv[0];
  kv[2 * lane + 1] = w1 * dtv[1];
}

// Warp 0: head h's dt at the chunk from t0 (lane l: steps 2 l, 2 l + 1)
__device__ __forceinline__ void fetch_dt(float (&dtv)[2], const Args& g,
                                         int b, int h, int t0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = t0 + 2 * lane + q;
    dtv[q] = t < g.s ? g.dt[b * g.dt_sb + (long long)t * g.dt_ss +
                            (long long)h * g.dt_sh]
                     : 0.0f;
  }
}

// The states kernel: one warpgroup per (b, h, direction) walks the chunks.
// Forward (blockIdx.y 0): H_c, the state entering chunk c, h <- E h +
// B^T (k o x) from 0; reverse (1): G_c, the gradient of the state leaving
// chunk c, G <- E G + C^T (e o dy) from dh. Each is written before the
// chunk's update, as hi + lo bf16 halves (hs / gs: (batch, heads, nc, 2,
// NP, 64)), staged in shared memory in the swizzled layout and stored by
// TMA (the threads' own 4-byte stores, 8 rows apart, took half of a step).
// The state is the wgmma accumulator (NP / 64 m-tiles of 64 x 64): scaled
// by E, then B^T (MN-major A, the B tile itself) times the weighted rows'
// hi and lo halves (MN-major B) added.
template <int NP>
__global__ void __launch_bounds__(kWg)
    bwd_states_bf16_kernel(const Args g, const __grid_constant__ Maps maps) {
  using Z = Bf<NP>;
  constexpr int kNH = Z::kNH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = hop::align_1k(smem_raw);   // 2 x (B or C, x or dy)
  unsigned char* hl = ring + 2 * Z::kRing;         // weighted rows: hi, lo
  unsigned char* so = hl + 2 * kBlk;               // the state out: hi, lo
  float* fl = reinterpret_cast<float*>(so + 2 * Z::kSt);
  float* dts = fl;
  float* cum = fl + kL;
  float* ev = fl + 2 * kL;
  float* dv = fl + 3 * kL;
  float* kv = fl + 4 * kL;
  __shared__ uint64_t bars[2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bool rev = blockIdx.y == 1;
  const int b = blockIdx.x / g.heads, h = blockIdx.x % g.heads;
  const int grp = h / (g.heads / g.groups);
  const int nc = (g.s + kL - 1) / kL;
  const float a = g.A[h * g.a_sh];
  const uint32_t hla = tc::smem_addr(hl);
  const int row0 = 16 * warp + gq;  // this thread's rows row0, row0 + 8 of
                                    // each m-tile

  float acc[kNH][32];
#pragma unroll
  for (int mt = 0; mt < kNH; ++mt) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int n = 64 * mt + row0 + 8 * ((e >> 1) & 1);
      const int p = 8 * (e >> 2) + 2 * tq + (e & 1);
      acc[mt][e] = (rev && g.dh != nullptr && n < g.n && p < g.p)
                       ? g.dh[(((long long)b * g.heads + h) * g.n + n) * g.p +
                              p]
                       : 0.0f;
    }
  }

  // step q updates with chunk c(q); the state is stored before each
  auto chunk_of = [&](int q) { return rev ? nc - 1 - q : q; };
  auto load = [&](int q) {
    unsigned char* r = ring + (q & 1) * Z::kRing;
    const int t0 = chunk_of(q) * kL;
    hop::mbar_expect(bars + (q & 1), Z::kRing);
#pragma unroll
    for (int k = 0; k < kNH; ++k) {
      tma_4d(r + k * kBlk, rev ? maps.c : maps.b, bars + (q & 1), 64 * k,
             grp, t0, b);
    }
    tma_4d(r + Z::kBC, rev ? maps.dy : maps.x, bars + (q & 1), 0, h, t0, b);
  };
  const int steps = nc - 1;
  if (tid == 0) {
    hop::mbar_init(bars);
    hop::mbar_init(bars + 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (steps > 0) load(0);
    if (steps > 1) load(1);
  }
  float dtv[2] = {0.0f, 0.0f};
  if (warp == 0 && steps > 0) fetch_dt(dtv, g, b, h, chunk_of(0) * kL);

  const CUtensorMap& out = rev ? maps.gs : maps.hs;
  const int tile0 = (b * g.heads + h) * nc;  // chunk c's halves: tiles
                                             // 2 (tile0 + c), + 1
  for (int q = 0; q < nc; ++q) {
    const int c = chunk_of(q);
    // the state entering (leaving) chunk c into the staging halves (thread
    // 0 waited for the last store's reads before the last barrier)
#pragma unroll
    for (int mt = 0; mt < kNH; ++mt) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const uint32_t o =
            sw_off(64 * mt + row0 + 8 * ((e >> 1) & 1), e >> 2, tq);
        const uint32_t hv = tc::pack_bf16(acc[mt][e], acc[mt][e + 1]);
        const __nv_bfloat162 hb =
            *reinterpret_cast<const __nv_bfloat162*>(&hv);
        *reinterpret_cast<uint32_t*>(so + o) = hv;
        *reinterpret_cast<uint32_t*>(so + Z::kSt + o) = tc::pack_bf16(
            acc[mt][e] - __low2float(hb), acc[mt][e + 1] - __high2float(hb));
      }
    }
    hop::fence_proxy_async();
    if (q == steps) {
      __syncthreads();
      if (tid == 0) {
        tma_store_2d(out, so, 2 * (tile0 + c) * NP);
        tma_store_2d(out, so + Z::kSt, (2 * (tile0 + c) + 1) * NP);
        bulk_commit();
        bulk_wait<false>();
      }
      break;
    }
    if (warp == 0) {
      chunk_scalars(dtv, a, dts, cum, ev, dv, kv);
      if (q + 1 < steps) fetch_dt(dtv, g, b, h, chunk_of(q + 1) * kL);
    }
    const int st = q & 1;
    unsigned char* r = ring + st * Z::kRing;
    hop::mbar_wait(bars + st, (q >> 1) & 1);
    __syncthreads();  // the chunk's tiles and scalars are in
    if (tid == 0) {
      tma_store_2d(out, so, 2 * (tile0 + c) * NP);
      tma_store_2d(out, so + Z::kSt, (2 * (tile0 + c) + 1) * NP);
      bulk_commit();
    }
    // the weighted rows k o x (forward) or e o dy (reverse) as hi + lo
    // halves, chunk by chunk of 16 bytes (a chunk's row is its offset / 128)
    const float* wv = rev ? ev : kv;
    for (int k = tid; k < kL * 8; k += kWg) {
      const uint4 raw = *reinterpret_cast<const uint4*>(r + Z::kBC + 16 * k);
      const float w = wv[k >> 3];
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&raw);
      uint4 hv, lv;
      uint32_t* ho = reinterpret_cast<uint32_t*>(&hv);
      uint32_t* lw = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(u + i));
        const float v0 = f.x * w, v1 = f.y * w;
        ho[i] = tc::pack_bf16(v0, v1);
        const __nv_bfloat162 hb =
            *reinterpret_cast<const __nv_bfloat162*>(ho + i);
        lw[i] = tc::pack_bf16(v0 - __low2float(hb), v1 - __high2float(hb));
      }
      *reinterpret_cast<uint4*>(hl + 16 * k) = hv;
      *reinterpret_cast<uint4*>(hl + kBlk + 16 * k) = lv;
    }
    hop::fence_proxy_async();
    __syncthreads();  // the halves are written
    const float E = ev[kL - 1];
#pragma unroll
    for (int mt = 0; mt < kNH; ++mt) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mt][e] *= E;
    }
    const uint32_t ra = tc::smem_addr(r);
    hop::wg_fence();
#pragma unroll
    for (int mt = 0; mt < kNH; ++mt) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hop::wgmma_ss_n64<1, 1>(acc[mt], mnmaj(ra + mt * kBlk, kk),
                                mnmaj(hla, kk), 1);
        hop::wgmma_ss_n64<1, 1>(acc[mt], mnmaj(ra + mt * kBlk, kk),
                                mnmaj(hla + kBlk, kk), 1);
      }
    }
    hop::wg_commit();
    hop::wg_wait_all();
#pragma unroll
    for (int mt = 0; mt < kNH; ++mt) hop::hold(acc[mt]);
    if (tid == 0) bulk_wait<true>();
    __syncthreads();  // the ring stage and both pairs of halves are free
    if (tid == 0 && q + 2 < steps) load(q + 2);
  }
}

// The gradient kernel: one block per (run of consecutive heads of one
// group, chunk, b), two warpgroups. Warpgroup 0: S^T = B C^T once (rows j,
// columns i: the A fragments of the products over i), then per head Q^T =
// x dy^T, M^T and dS^T in the accumulators, the run's sum of dS^T, the row
// and column sums of V and R, dx = k o (B G) + M^T dy (M^T as hi + lo A
// fragments) and d k_j = x_j . (B G)_j; warp 0 then the in-chunk reverse
// sum for d(dt) and dA. Warpgroup 1: per head dB += k o (x G^T) and dC +=
// e o (dy H^T) in its accumulators (64-column halves of N), d e_i = C_i .
// (dy H^T)_i and <G, H>; after the run dB += (sum dS^T) C and dC += (sum
// dS) B, both read from one swizzled tile, and the run's f32 partials
// written. Stages of (x, dy, G, H) come by TMA through a ring of 2.
template <int NP>
__global__ void __launch_bounds__(2 * kWg, 1)
    bwd_grad_bf16_kernel(const Args g, const __grid_constant__ Maps maps) {
  using Z = Bf<NP>;
  constexpr int kNH = Z::kNH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* bsm = hop::align_1k(smem_raw);
  unsigned char* csm = bsm + Z::kBC;
  unsigned char* stg = csm + Z::kBC;             // 2 stages
  unsigned char* dsm = stg + 2 * Z::kStage;      // sum of dS^T: hi, lo
  float* fl = reinterpret_cast<float*>(dsm + 2 * kBlk);
  float* dts = fl;
  float* cum = fl + kL;
  float* ev = fl + 2 * kL;
  float* dv = fl + 3 * kL;
  float* kv = fl + 4 * kL;
  float* sv = fl + 5 * kL;    // sum_i V_ij, row j
  float* sr = fl + 6 * kL;    // sum_i R_ij, row j
  float* dkv = fl + 7 * kL;   // d k_j
  float* dev = fl + 8 * kL;   // d e_i
  float* colR = fl + 9 * kL;  // [4][kL]: sum_j R_ij over each warp's rows
  float* gh = colR + 4 * kL;  // [4]: <G, H> by warp of warpgroup 1
  __shared__ uint64_t bars[2];

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int run = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int hpg = g.heads / g.groups, grp = run / g.rpg;
  const int h0 = grp * hpg + (run % g.rpg) * g.run;
  const int nh = min(g.run, (grp + 1) * hpg - h0);
  const int s = g.s, t0 = c * kL, nc = (s + kL - 1) / kL;
  if (nh <= 0) return;
  const uint32_t bsa = tc::smem_addr(bsm), csa = tc::smem_addr(csm);
  const uint32_t dsa = tc::smem_addr(dsm);
  const int jr = 16 * warp + gq;  // this thread's rows jr, jr + 8

  auto load_stage = [&](int st, int h) {
    unsigned char* sp = stg + st * Z::kStage;
    const int tile = ((b * g.heads + h) * nc + c) * 2;
    tma_4d(sp, maps.x, bars + st, 0, h, t0, b);
    tma_4d(sp + kBlk, maps.dy, bars + st, 0, h, t0, b);
    tma_2d(sp + 2 * kBlk, maps.gs, bars + st, tile * NP);
    tma_2d(sp + 2 * kBlk + Z::kSt, maps.gs, bars + st, (tile + 1) * NP);
    tma_2d(sp + 2 * kBlk + 2 * Z::kSt, maps.hs, bars + st, tile * NP);
    tma_2d(sp + 2 * kBlk + 3 * Z::kSt, maps.hs, bars + st, (tile + 1) * NP);
  };
  if (tid == 0) {
    hop::mbar_init(bars);
    hop::mbar_init(bars + 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hop::mbar_expect(bars, 2 * Z::kBC + Z::kStage);
#pragma unroll
    for (int k = 0; k < kNH; ++k) {
      tma_4d(bsm + k * kBlk, maps.b, bars, 64 * k, grp, t0, b);
      tma_4d(csm + k * kBlk, maps.c, bars, 64 * k, grp, t0, b);
    }
    load_stage(0, h0);
  }

  if (tid < kWg) {
    // ---- warpgroup 0 ----
    float sT[32], dsum[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dsum[e] = 0.0f;
    float dtv[2] = {0.0f, 0.0f};
    if (warp == 0) fetch_dt(dtv, g, b, h0, t0);
    for (int q = 0; q < nh; ++q) {
      const int h = h0 + q, st = q & 1;
      const float a = g.A[h * g.a_sh];
      if (warp == 0) {
        chunk_scalars(dtv, a, dts, cum, ev, dv, kv);
        if (q + 1 < nh) fetch_dt(dtv, g, b, h + 1, t0);
      }
      hop::mbar_wait(bars + st, (q >> 1) & 1);
      named_sync(1);  // the stage and the scalars are in; head q - 1 done
      if (tid == 0 && q + 1 < nh) {
        hop::mbar_expect(bars + (st ^ 1), Z::kStage);
        load_stage(st ^ 1, h + 1);
      }
      unsigned char* sp = stg + st * Z::kStage;
      const uint32_t xa = tc::smem_addr(sp), dya = xa + kBlk;
      const uint32_t gha = xa + 2 * kBlk, gla = gha + Z::kSt;
      if (q == 0) {  // S^T = B C^T, once for the run
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          hop::wgmma_ss_n64(sT, kmaj(bsa, kk), kmaj(csa, kk), kk > 0);
        }
        hop::wg_commit();
        hop::wg_wait_all();
        hop::hold(sT);
      }
      float qa[32];  // Q^T = x dy^T
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hop::wgmma_ss_n64(qa, kmaj(xa, kk), kmaj(dya, kk), kk > 0);
      }
      hop::wg_commit();
      hop::wg_wait_all();
      hop::hold(qa);

      // element e of the tile: row j = jr + 8 ((e >> 1) & 1), column i = 8
      // (e >> 2) + 2 tq + (e & 1); M^T in mt, dS^T summed into dsum; V =
      // Q S w and R = V dt_j (i > j, w's clip passing) summed by row and by
      // column (branch-free: w is taken for every element, then selected)
      float mt[32];
      float rowv[2] = {0.0f, 0.0f}, rowr[2] = {0.0f, 0.0f};
      float colr[8][2];
      float cj[2], dj[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        cj[hh] = cum[jr + 8 * hh];
        dj[hh] = dts[jr + 8 * hh];
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int i = 8 * nb + 2 * tq + cc;
          const float ci = cum[i];
          colr[nb][cc] = 0.0f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = jr + 8 * hh, e = 4 * nb + 2 * hh + cc;
            const float v = ci - cj[hh];
            const float w = clip_exp(v);
            const bool low = i >= j;
            const float sw = low ? sT[e] * w : 0.0f;
            const float qw = low ? qa[e] * w : 0.0f;
            const float vv = qa[e] * sw;
            const float rv = (i > j && passes(v)) ? vv * dj[hh] : 0.0f;
            rowv[hh] += vv;
            rowr[hh] += rv;
            colr[nb][cc] += rv;
            mt[e] = sw * dj[hh];
            dsum[e] += qw * dj[hh];
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = rowv[hh], r = rowr[hh];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        r += __shfl_xor_sync(kFull, r, 1);
        r += __shfl_xor_sync(kFull, r, 2);
        if (tq == 0) {
          sv[jr + 8 * hh] = v;
          sr[jr + 8 * hh] = r;
        }
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float v = colr[nb][cc];
          v += __shfl_xor_sync(kFull, v, 4);
          v += __shfl_xor_sync(kFull, v, 8);
          v += __shfl_xor_sync(kFull, v, 16);
          if (gq == 0) colR[warp * kL + 8 * nb + 2 * tq + cc] = v;
        }
      }
      uint32_t mhi[4][4], mlo[4][4];
      hop::split_a(mt, mhi, mlo);

      // dx = k o (B G) + M^T dy; d k_j = x_j . (B G)_j
      float acc[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        hop::wgmma_ss_n64<0, 1>(acc, kmaj(bsa, kk), mnmaj(gha, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        hop::wgmma_ss_n64<0, 1>(acc, kmaj(bsa, kk), mnmaj(gla, kk), 1);
      }
      hop::wg_commit();
      hop::wg_wait_all();
      hop::hold(acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = jr + 8 * hh;
        float part = 0.0f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 xv = ld_pair(sp + sw_off(j, nb, tq));
          part += xv.x * acc[4 * nb + 2 * hh] + xv.y * acc[4 * nb + 2 * hh + 1];
        }
        part += __shfl_xor_sync(kFull, part, 1);
        part += __shfl_xor_sync(kFull, part, 2);
        if (tq == 0) dkv[j] = part;
        const float kj = kv[j];
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          acc[4 * nb + 2 * hh] *= kj;
          acc[4 * nb + 2 * hh + 1] *= kj;
        }
      }
      hop::wg_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        hop::wgmma_rs_n64(acc, mhi[kq], mnmaj(dya, kq));
        hop::wgmma_rs_n64(acc, mlo[kq], mnmaj(dya, kq));
      }
      hop::wg_commit();
      hop::wg_wait_all();
      hop::hold(acc);
      hop::hold(mhi);
      hop::hold(mlo);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + jr + 8 * hh;
        if (t < s) {
          bf16* row = static_cast<bf16*>(g.dx) +
                      (((long long)b * s + t) * g.heads + h) * g.p;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int col = 8 * nb + 2 * tq;
            if (col < g.p) {
              *reinterpret_cast<__nv_bfloat162*>(row + col) =
                  __floats2bfloat162_rn(acc[4 * nb + 2 * hh],
                                        acc[4 * nb + 2 * hh + 1]);
            }
          }
        }
      }
      named_sync(2);  // every per-step sum of head q is in

      // warp 0, steps 2 lane and 2 lane + 1: d(dt) and d(cum), then the
      // reverse in-chunk sum d(dt A)_k = sum_{i >= k} d(cum)_i, d(dt) += A
      // d(dt A), dA's chunk partial sum_k dt_k d(dt A)_k
      if (warp == 0) {
        const float dE = gh[0] + gh[1] + gh[2] + gh[3];
        const float E = ev[kL - 1], cl = cum[kL - 1];
        float ddt_v[2], dcum_v[2], tsum = 0.0f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int r = 2 * lane + k;
          const float dk = dkv[r];
          ddt_v[k] = sv[r] + dv[r] * dk;
          const float tk = (r < kL - 1 && passes(cl - cum[r]))
                               ? dts[r] * dk * dv[r]
                               : 0.0f;
          tsum += tk;
          const float de = passes(cum[r]) ? dev[r] * ev[r] : 0.0f;
          const float rowR =
              colR[r] + colR[kL + r] + colR[2 * kL + r] + colR[3 * kL + r];
          dcum_v[k] = rowR - sr[r] + de - tk;
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
        for (int k = 0; k < 2; ++k) {
          const int t = t0 + 2 * lane + k;
          if (t < s) g.ddt[((long long)b * s + t) * g.heads + h] = ddt_v[k];
        }
        const float part =
            warp_sum(dts[2 * lane] * dda0 + dts[2 * lane + 1] * dda1);
        if (lane == 0) g.dA_part[((long long)b * nc + c) * g.heads + h] = part;
      }
    }
    // the run's sum of dS^T (rows j, columns i) into its tile, hi and lo
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * nb + 2 * hh;
        const uint32_t off = sw_off(jr + 8 * hh, nb, tq);
        const uint32_t hv = tc::pack_bf16(dsum[e], dsum[e + 1]);
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&hv);
        *reinterpret_cast<uint32_t*>(dsm + off) = hv;
        *reinterpret_cast<uint32_t*>(dsm + kBlk + off) = tc::pack_bf16(
            dsum[e] - __low2float(hb), dsum[e + 1] - __high2float(hb));
      }
    }
    hop::fence_proxy_async();
    named_sync(3);
  } else {
    // ---- warpgroup 1 ----
    const int wt = tid - kWg;
    float accB[kNH][32], accC[kNH][32];
#pragma unroll
    for (int m = 0; m < kNH; ++m) {
#pragma unroll
      for (int e = 0; e < 32; ++e) accB[m][e] = accC[m][e] = 0.0f;
    }
    for (int q = 0; q < nh; ++q) {
      const int st = q & 1;
      hop::mbar_wait(bars + st, (q >> 1) & 1);
      named_sync(1);
      unsigned char* sp = stg + st * Z::kStage;
      const uint32_t xa = tc::smem_addr(sp), dya = xa + kBlk;
      const uint32_t gha = xa + 2 * kBlk, gla = gha + Z::kSt;
      const uint32_t hha = gla + Z::kSt, hla = hha + Z::kSt;
      float dep[2] = {0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < kNH; ++m) {
        // dB += k o (x G^T) on columns [64 m, 64 m + 64) of N
        float tmp[32];
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::wgmma_ss_n64(tmp, kmaj(xa, kk), kmaj(gha + m * kBlk, kk),
                            kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::wgmma_ss_n64(tmp, kmaj(xa, kk), kmaj(gla + m * kBlk, kk), 1);
        }
        hop::wg_commit();
        hop::wg_wait_all();
        hop::hold(tmp);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float kj = kv[jr + 8 * hh];
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int e = 4 * nb + 2 * hh + cc;
              accB[m][e] = fmaf(tmp[e], kj, accB[m][e]);
            }
          }
        }
        // dC += e o (dy H^T); d e_i = C_i . (dy H^T)_i
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::wgmma_ss_n64(tmp, kmaj(dya, kk), kmaj(hha + m * kBlk, kk),
                            kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hop::wgmma_ss_n64(tmp, kmaj(dya, kk), kmaj(hla + m * kBlk, kk), 1);
        }
        hop::wg_commit();
        hop::wg_wait_all();
        hop::hold(tmp);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = jr + 8 * hh;
          const float ei = ev[i];
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int e = 4 * nb + 2 * hh;
            const float2 cv = ld_pair(csm + m * kBlk + sw_off(i, nb, tq));
            dep[hh] += cv.x * tmp[e] + cv.y * tmp[e + 1];
            accC[m][e] = fmaf(tmp[e], ei, accC[m][e]);
            accC[m][e + 1] = fmaf(tmp[e + 1], ei, accC[m][e + 1]);
          }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = dep[hh];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        if (tq == 0) dev[jr + 8 * hh] = v;
      }
      // <G, H>: the four halves share one layout, so chunk k of each holds
      // the same elements
      float ghp = 0.0f;
      const unsigned char* gp = sp + 2 * kBlk;
      for (int k = wt; k < NP * 8; k += kWg) {
        const uint4 q0 = *reinterpret_cast<const uint4*>(gp + 16 * k);
        const uint4 q1 =
            *reinterpret_cast<const uint4*>(gp + Z::kSt + 16 * k);
        const uint4 q2 =
            *reinterpret_cast<const uint4*>(gp + 2 * Z::kSt + 16 * k);
        const uint4 q3 =
            *reinterpret_cast<const uint4*>(gp + 3 * Z::kSt + 16 * k);
        const __nv_bfloat162* v0 =
            reinterpret_cast<const __nv_bfloat162*>(&q0);
        const __nv_bfloat162* v1 =
            reinterpret_cast<const __nv_bfloat162*>(&q1);
        const __nv_bfloat162* v2 =
            reinterpret_cast<const __nv_bfloat162*>(&q2);
        const __nv_bfloat162* v3 =
            reinterpret_cast<const __nv_bfloat162*>(&q3);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a0 = __bfloat1622float2(v0[i]);
          const float2 a1 = __bfloat1622float2(v1[i]);
          const float2 a2 = __bfloat1622float2(v2[i]);
          const float2 a3 = __bfloat1622float2(v3[i]);
          ghp += (a0.x + a1.x) * (a2.x + a3.x) + (a0.y + a1.y) * (a2.y + a3.y);
        }
      }
      ghp = warp_sum(ghp);
      if (lane == 0) gh[warp] = ghp;
      named_sync(2);
    }
    named_sync(3);  // the run's sum of dS^T is in its tile
    hop::wg_fence();
#pragma unroll
    for (int m = 0; m < kNH; ++m) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // dB += (sum dS^T) C: A K-major, C MN-major; dC += (sum dS) B: A the
        // same tile MN-major
        hop::wgmma_ss_n64<0, 1>(accB[m], kmaj(dsa, kk),
                                mnmaj(csa + m * kBlk, kk), 1);
        hop::wgmma_ss_n64<0, 1>(accB[m], kmaj(dsa + kBlk, kk),
                                mnmaj(csa + m * kBlk, kk), 1);
        hop::wgmma_ss_n64<1, 1>(accC[m], mnmaj(dsa, kk),
                                mnmaj(bsa + m * kBlk, kk), 1);
        hop::wgmma_ss_n64<1, 1>(accC[m], mnmaj(dsa + kBlk, kk),
                                mnmaj(bsa + m * kBlk, kk), 1);
      }
    }
    hop::wg_commit();
    hop::wg_wait_all();
#pragma unroll
    for (int m = 0; m < kNH; ++m) {
      hop::hold(accB[m]);
      hop::hold(accC[m]);
    }
    // the run's f32 partials: (batch, s, groups x rpg, n) each
    const long long rtot = (long long)g.groups * g.rpg;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + jr + 8 * hh;
      if (t < s) {
        const long long o = (((long long)b * s + t) * rtot + run) * g.n;
        float* pb = g.dB_part + o;
        float* pc = g.dC_part + o;
#pragma unroll
        for (int m = 0; m < kNH; ++m) {
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int nn = 64 * m + 8 * nb + 2 * tq + cc;
              const int e = 4 * nb + 2 * hh + cc;
              if (nn < g.n) {
                pb[nn] = accB[m][e];
                pc[nn] = accC[m][e];
              }
            }
          }
        }
      }
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

// dB and dC summed over the per-head partials and dA over the batch: the
// f32 path's finishing launch
template <typename T>
int launch_finish(const Args& g, int rep, int dA_rows, cudaStream_t stream) {
  const long long total =
      g.dB_part != nullptr ? (long long)g.batch * g.s * g.groups * g.n : 0;
  const long long blocks = total > 0 ? (total + kThreads - 1) / kThreads : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_scan_bwd_finish_kernel<T>
      <<<(int)blocks, kThreads, 0, stream>>>(g, total, rep, dA_rows);
  return (int)cudaGetLastError();
}

template <int NP, int P>
int launch_f32(const Args& g, cudaStream_t stream) {
  auto kernel = ssd_scan_bwd_kernel<float, NP, P>;
  const size_t smem = Smem<NP, P>::kBytes;
  static const int smem_rc = set_smem((const void*)kernel, smem);
  if (smem_rc) return smem_rc;
  kernel<<<g.batch * g.heads, kThreads, smem, stream>>>(g);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_finish<float>(g, g.heads / g.groups, g.batch, stream);
}

template <int P>
int launch_f32_p(const Args& g, cudaStream_t stream) {
  if (g.n <= 16) return launch_f32<16, P>(g, stream);
  if (g.n <= 32) return launch_f32<32, P>(g, stream);
  if (g.n <= 64) return launch_f32<64, P>(g, stream);
  return launch_f32<128, P>(g, stream);
}

// A 4-D bf16 map of rows of `cols` elements, (cols, k, steps, batch) with
// element strides sk, ss, sb, box 64 x 1 x 64 x 1, 128-byte swizzle. A
// dimension of size 1 takes the extent of the ones inside it as its
// stride (its own is never used).
bool rows_map(CUtensorMap* map, const void* base, int cols, int k, int steps,
              int batch, long long sk, long long ss, long long sb) {
  const auto encode = hop::encode_tiled();
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)k,
                              (cuuint64_t)steps, (cuuint64_t)batch};
  const long long st[3] = {sk, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t inner = (cuuint64_t)cols * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)st[i] * 2
                                 : (inner + 15) / 16 * 16;
    inner = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kL, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a state scratch, (rows, 64) bf16, box 64 x np.
bool state_map(CUtensorMap* map, const void* base, long long rows, int np) {
  const auto encode = hop::encode_tiled();
  const cuuint64_t dims[2] = {64, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, (cuuint32_t)np};
  const cuuint32_t unit[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 path: the states kernel, the gradient kernel, the finishing
// sums, on one stream in this order.
template <int NP>
int launch_bf16(const Args& g, cudaStream_t stream) {
  using Z = Bf<NP>;
  static const int smem_rc =
      set_smem((const void*)bwd_states_bf16_kernel<NP>, Z::kStatesBytes) |
      set_smem((const void*)bwd_grad_bf16_kernel<NP>, Z::kGradBytes);
  if (smem_rc) return smem_rc;
  const int nc = (g.s + kL - 1) / kL;
  if (nc > 0) {
    const long long rows = (long long)g.batch * g.heads * nc * 2 * NP;
    Maps maps;
    if (!rows_map(&maps.x, g.x, g.p, g.heads, g.s, g.batch, g.x_sh, g.x_ss,
                  g.x_sb) ||
        !rows_map(&maps.dy, g.dy, g.p, g.heads, g.s, g.batch, g.dy_sh,
                  g.dy_ss, g.dy_sb) ||
        !rows_map(&maps.b, g.B, g.n, g.groups, g.s, g.batch, g.b_sg, g.b_ss,
                  g.b_sb) ||
        !rows_map(&maps.c, g.C, g.n, g.groups, g.s, g.batch, g.c_sg, g.c_ss,
                  g.c_sb) ||
        !state_map(&maps.hs, g.hs, rows, NP) ||
        !state_map(&maps.gs, g.gs, rows, NP)) {
      return (int)cudaErrorInvalidValue;
    }
    bwd_states_bf16_kernel<NP><<<dim3(g.batch * g.heads, 2), kWg,
                                 Z::kStatesBytes, stream>>>(g, maps);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    bwd_grad_bf16_kernel<NP><<<dim3(g.groups * g.rpg, nc, g.batch), 2 * kWg,
                               Z::kGradBytes, stream>>>(g, maps);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return launch_finish<bf16>(g, g.rpg, g.batch * nc, stream);
}

}  // namespace

extern "C" {

// Launches K4's backward on `stream` in float32: the main kernel, batch x heads blocks, then the finishing sums. Inputs as the
// forward's entry takes them (x, B, C and dy by pointer and element
// strides, the last dimension contiguous; A indexed by head through a_sh)
// plus dy and dh (null: zero; else (batch, heads, n, p) f32 contiguous).
// Outputs and scratch are contiguous and allocated by the caller: dx
// (batch, s, heads, p) and dB, dC (batch, s, groups, n) in x's dtype; ddt
// (batch, s, heads), dA (heads), dA_part (batch, heads), states (batch,
// heads, max(nc - 1, 0), n, p) f32 (nc = ceil(s / 64)); dB_part, dC_part
// (batch, s, heads, n) f32 when groups < heads, else null. p 32 or 64, n
// in [1, 128], heads a multiple of groups. Returns cudaGetLastError() after
// the launches (0 on success) or cudaErrorInvalidValue for shapes it does
// not take. (bfloat16 takes ssd_scan_bwd_bf16_launch.)
int ssd_scan_bwd_launch(
    const void* x, long long x_sb, long long x_ss, long long x_sh,
    const void* dt, long long dt_sb, long long dt_ss, long long dt_sh,
    const void* A, long long a_sh, const void* B, long long b_sb,
    long long b_ss, long long b_sg, const void* C, long long c_sb,
    long long c_ss, long long c_sg, const void* dy, long long dy_sb,
    long long dy_ss, long long dy_sh, const void* dh, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dA_part, void* dB_part,
    void* dC_part, void* states, int batch, int s, int heads, int groups,
    int p, int n, void* stream) {
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
  Args g{x, (const float*)dt, (const float*)A, B, C, dy, (const float*)dh,
         dx, (float*)ddt, dB, dC, (float*)dA, (float*)dA_part,
         (float*)dB_part, (float*)dC_part, (float*)states, nullptr, nullptr,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, a_sh, b_sb, b_ss, b_sg,
         c_sb, c_ss, c_sg, dy_sb, dy_ss, dy_sh, batch, s, heads, groups, n,
         p, 0, 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (p == 32) return launch_f32_p<32>(g, st);
  if (p == 64) return launch_f32_p<64>(g, st);
  return (int)cudaErrorInvalidValue;
}

// Launches K4's backward on `stream` in bfloat16: the states kernel
// (batch x heads x 2 blocks), the gradient kernel (groups x rpg runs x nc
// chunks x batch blocks, a run `run` consecutive heads of one group, the
// last shorter; rpg = ceil(heads / groups / run)) and the finishing sums.
// Inputs as ssd_scan_bwd_launch's, x, B, C and dy 16-byte aligned with
// strides multiples of 8 elements. Outputs as its (dx, dB, dC bf16), and
// scratch allocated by the caller: dA_part (batch x nc, heads), dB_part and
// dC_part (batch, s, groups x rpg, n) f32; hs and gs (batch, heads, nc, 2,
// np, 64) bf16, np = 64 for n <= 64, else 128 (the states entering and the
// state gradients leaving each chunk, hi and lo halves). p 32 or 64, n in
// [1, 128], batch and nc at most 65,535 (grid dimensions). Returns
// cudaGetLastError() after the launches (0 on success) or
// cudaErrorInvalidValue for shapes it does not take.
int ssd_scan_bwd_bf16_launch(
    const void* x, long long x_sb, long long x_ss, long long x_sh,
    const void* dt, long long dt_sb, long long dt_ss, long long dt_sh,
    const void* A, long long a_sh, const void* B, long long b_sb,
    long long b_ss, long long b_sg, const void* C, long long c_sb,
    long long c_ss, long long c_sg, const void* dy, long long dy_sb,
    long long dy_ss, long long dy_sh, const void* dh, void* dx, void* ddt,
    void* dA, void* dB, void* dC, void* dA_part, void* dB_part,
    void* dC_part, void* hs, void* gs, int batch, int s, int heads,
    int groups, int p, int n, int run, int rpg, void* stream) {
  if (batch < 0 || batch > 65535 || s < 0 || heads < 1 || groups < 1 ||
      heads % groups || n < 1 || n > kMaxN || (p != 32 && p != 64) ||
      run < 1 || rpg < 1 || (long long)run * rpg < heads / groups ||
      (long long)run * (rpg - 1) >= heads / groups) {
    return (int)cudaErrorInvalidValue;
  }
  const int np = n <= 64 ? 64 : 128;
  const long long nc = (s + kL - 1) / kL;
  if (nc > 65535 || (long long)batch * heads * nc * 2 * np > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return 0;
  Args g{x, (const float*)dt, (const float*)A, B, C, dy, (const float*)dh,
         dx, (float*)ddt, dB, dC, (float*)dA, (float*)dA_part,
         (float*)dB_part, (float*)dC_part, nullptr, hs, gs,
         x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, a_sh, b_sb, b_ss, b_sg,
         c_sb, c_ss, c_sg, dy_sb, dy_ss, dy_sh, batch, s, heads, groups, n,
         p, run, rpg};
  cudaStream_t st = (cudaStream_t)stream;
  return np == 64 ? launch_bf16<64>(g, st) : launch_bf16<128>(g, st);
}

// The dynamic shared memory of the bf16 path's kernel (0 the states
// kernel, 1 the gradient kernel) at state size n; -1 for what it does not
// take.
int ssd_scan_bwd_bf16_smem_bytes(int n, int kernel) {
  if (n < 1 || n > kMaxN || (kernel != 0 && kernel != 1)) return -1;
  if (n <= 64) {
    return (int)(kernel ? Bf<64>::kGradBytes : Bf<64>::kStatesBytes);
  }
  return (int)(kernel ? Bf<128>::kGradBytes : Bf<128>::kStatesBytes);
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
