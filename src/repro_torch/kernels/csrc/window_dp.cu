// K1: the CHC window min-plus DP (paper Eq. 10) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/window_dp.py:_kernel (the Pallas
// `window_dp`). B independent rows; row b holds a cost table (w1, tn+1) and
// a gain vector (U+1), U = w1 * tn. For each slot tau,
//   C'[u] = min_k C[u-k] + cost[tau, k]   (out of range = BIG),
// then obj = max_u (gain[u] - C[u]) over C < BIG/2 with the first argmax
// u*, and the backtrack n_tot[tau] = the smallest k attaining the min at
// the path's unit, u -= n_tot[tau]. The result is bit-equal to the plain
// PyTorch DP (repro_torch/kernels/ref.py:window_dp_ref).
//
// Two entries, one kernel body:
// - window_dp_launch (table entry) reads slot_cost (B, w1, tn+1) and gain
//   (B, U+1) and writes n_tot (B, w1) and obj (B,);
// - window_dp_rows_launch (forecast entry, the selection path's launch)
//   reads each row's forecast and job fields (prices, avail (B, w1); z0,
//   slots_to_deadline and the job's seven fields (B,)), builds the row's
//   cost table and gain in registers exactly as
//   core/window_opt.py:_unit_cost_table does in torch ops (with
//   core/job.py:tilde_value), and writes the split plan n_o, n_s (B, w1)
//   and the un-biased objective (B,) as core/window_opt.py:split_plan does.
//   That module owns the arithmetic: a change starts there and is repeated
//   in ForecastRow and RowSlot below. Every f32 op of
//   that chain is one rounded intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn:
//   nvcc would otherwise contract a*b + c); the slot cost
//   n_sp * price + (k - n_sp) * p_o is one __fmaf_rn, the single rounding
//   the chain takes through an exact f64 sum.
//
// Design at the main path's shape (w1, tn) = (6, 16), U+1 = 97: a block of
// w1 + 1 = 7 warps over 32 rows, lane = row; warp s holds the strip of
// units [16 s, 16 s + 16) of its lane's state C in registers, w1 and tn
// template parameters so every loop over units and k unrolls.
// - Min only in the forward pass: each candidate is one FADD and one FMNMX
//   (min is exact and order-free, so every C equals the plain DP's
//   running-`<` result bit for bit). No candidate reads shared memory: once
//   a slot each warp loads the 16 states to its left (the strip to its
//   left's, kept for the backtrack anyway) and the slot's 17 costs.
// - Reachable region. Costs are >= 0 (every cost the unit-cost table builds
//   is: prices and p_o >= 0, infeasible k at BIG), so after slot tau no
//   unit above (tau+1)*tn holds a state below BIG. Candidates reading
//   C[u-k] with u-k > tau*tn are skipped (4,182 of 9,894 a row are kept).
//   With strips as wide as tn the region is warp-uniform: at slot tau warps
//   0..tau run their strips (warp 0 without the left pad, warp tau without
//   the candidates past the region), warp tau+1 computes its one reachable
//   unit, 16 (tau+1), and the rest wait at the slot's barrier.
//   This changes no output: by induction over slots, every state below
//   BIG/2 is the plain DP's, and every other state is >= BIG/2 in both (a
//   skipped candidate is >= BIG; f32 addition of a cost >= 0 never lowers a
//   state). The objective masks C >= BIG/2, and the backtrack from a u*
//   with C < BIG/2 only passes through states below BIG/2, whose minimal
//   candidates lie in the region. So the tie order is the plain DP's too.
//   Precondition (the table entry's caller): costs >= 0 and some u with
//   C < BIG/2 in every row, which a zero-unit column below BIG/(2 w1)
//   gives (the unit-cost table's is 0).
// - The argmin is not tracked. The backtrack recomputes the choice at the
//   one unit a slot that the path visits, from C_1..C_{w1-1} kept in shared
//   memory (only the reachable prefix, (tau+1)*tn + 1 units: 245 floats a
//   row), with the same f32 adds, taking the first strict minimum in k
//   order. Shared memory is laid out unit-major, row-minor: a warp's
//   stores and the backtrack's data-dependent loads hit 32 distinct banks.
// - Each warp takes the first max of the objective over its strip; warp 0
//   merges the strips in order and backtracks. The table (slot tau priced
//   by warp tau) and the stored states take 44,416 B a block (the merge
//   reuses slot 0's costs): four blocks, 28 warps, an SM, at 72 registers.
// Other shapes run the generic kernel: one warp per row, the units strided
// over the lanes, the state and the int8 choices in shared memory, the
// argmin tracked with a strict `<` (the port's first design).
//
// Bound at B = 105,000, (6, 16), on one H100 SXM (132 SMs): an FADD for
// every reachable candidate and an FMNMX for every one but a unit's first
// (the first is taken as it is), one issue slot each: 4,182 candidates and
// 342 reachable units a row, 2 x 4,182 - 342 = 8,022 instructions a row,
// 842.3 M a launch, at 128 f32 lanes a clock an SM and the card's maximum
// SM clock (1,980 MHz: 33.45 T lane-instructions a second), 25.2 us; bytes
// at 3.35 TB/s: the table entry moves 824 B a row (86.5 MB, 25.8 us, so
// its bound is by bytes), the forecast entry 136 B a row (14.3 MB, 4.3 us;
// its bound, 25.2 us, is by operations). The forecast entry's table build
// is left out of the count, so its bound is loose. chip_smoke.py computes
// both bounds from its run and reports each entry's time beside them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1.0e9f;
constexpr float kTieEps = 0.0009765625f;  // 2^-10, window_opt.TIE_EPS
constexpr int kMaxTableN = 127;           // generic choices are int8
constexpr int kWarpsPerBlock = 8;         // generic kernel
constexpr int kRows = 32;                 // strip kernel: rows a block
constexpr int kStripBlocksPerSM = 4;      // 28 warps an SM, 72 registers

// ---- where a row's tables come from and where its answer goes ----

struct TableArgs {
  const float* slot_cost;
  const float* gain;
  int* n_tot;
  float* obj;
  int w1, tn;
};

struct TableSlot {
  const float* c;
  __device__ float cost(int k) const { return __ldg(c + k); }
};

struct TableRow {
  const float* cost_row;
  const float* gain_row;
  int* n_tot;
  float* obj;
  int kw;

  __device__ TableRow(const TableArgs& a, long long row)
      : cost_row(a.slot_cost + row * (long long)(a.w1 * (a.tn + 1))),
        gain_row(a.gain + row * (long long)(a.w1 * a.tn + 1)),
        n_tot(a.n_tot + row * a.w1),
        obj(a.obj + row),
        kw(a.tn + 1) {}
  __device__ TableSlot slot(int tau) const { return {cost_row + tau * kw}; }
  __device__ float gain(int u) const { return __ldg(gain_row + u); }
  __device__ void put(int tau, int k) const { n_tot[tau] = k; }
  __device__ void put_obj(float o, int) const { *obj = o; }
};

struct RowArgs {
  const float* prices;   // (B, w1)
  const int* avail;      // (B, w1)
  const float* z0;       // (B,) each below
  const int* std_;       // slots to the deadline
  const float* workload;
  const int* deadline;
  const int* n_min;
  const int* n_max;
  const float* value;
  const float* gamma;
  const float* p_o;      // on-demand price, also the job's
  int* n_o;              // (B, w1)
  int* n_s;              // (B, w1)
  float* obj;            // (B,)
  float alpha, beta;
  int w1, tn;
};

// One slot of a forecast row: window_opt._unit_cost_table's slot_cost[tau, k].
struct RowSlot {
  float price, p_o;
  int spot, n_min, n_max;
  bool in_h;

  __device__ float cost(int k) const {
    const float kf = (float)k;
    const float n_sp = fminf(kf, (float)spot);
    const float c =
        __fmaf_rn(n_sp, price, __fmul_rn(__fsub_rn(kf, n_sp), p_o));
    const bool feasible = k == 0 || (k >= n_min && k <= n_max && in_h);
    return feasible ? c : kBig;
  }
};

struct ForecastRow {
  const float* price_row;
  const int* avail_row;
  int* n_o;
  int* n_s;
  float* obj;
  float z0, workload, value, p_o, alpha, d, rate, gm1d, pon;
  int std_, n_min, n_max;

  __device__ ForecastRow(const RowArgs& a, long long row)
      : price_row(a.prices + row * a.w1),
        avail_row(a.avail + row * a.w1),
        n_o(a.n_o + row * a.w1),
        n_s(a.n_s + row * a.w1),
        obj(a.obj + row),
        z0(__ldg(a.z0 + row)),
        workload(__ldg(a.workload + row)),
        value(__ldg(a.value + row)),
        p_o(__ldg(a.p_o + row)),
        alpha(a.alpha),
        d((float)__ldg(a.deadline + row)),
        std_(__ldg(a.std_ + row)),
        n_min(__ldg(a.n_min + row)),
        n_max(__ldg(a.n_max + row)) {
    // job.py:termination_time's rate = alpha * n_max + beta, value_fn's
    // (gamma - 1) * d and tilde_value's p_o * n_max, in torch's order
    rate = __fadd_rn(__fmul_rn((float)n_max, alpha), a.beta);
    gm1d = __fmul_rn(__fsub_rn(__ldg(a.gamma + row), 1.0f), d);
    pon = __fmul_rn(p_o, (float)n_max);
  }

  __device__ RowSlot slot(int tau) const {
    const float price = __ldg(price_row + tau);
    const bool in_h = tau < std_;
    const int cap = min(__ldg(avail_row + tau), n_max);
    const bool spot_ok = price <= p_o && in_h;
    return {price, p_o, spot_ok ? cap : 0, n_min, n_max, in_h};
  }

  // gain[u] = tilde_value(z0 + alpha * u) - TIE_EPS * u (job.py:31-55)
  __device__ float gain(int u) const {
    const float uf = (float)u;
    const float zs = __fadd_rn(z0, __fmul_rn(alpha, uf));
    const float rem = fmaxf(__fsub_rn(workload, zs), 0.0f);
    // 0 / rate is +0 for rate > 0: skip the division, which is slow for a
    // zero dividend (units past the workload)
    const float dt =
        rem == 0.0f && rate > 0.0f ? 0.0f : __fdiv_rn(rem, rate);
    const float t = __fadd_rn(d, dt);
    float val = value;
    if (!(t <= d)) {
      const float decay = __fmul_rn(
          value, __fsub_rn(1.0f, __fdiv_rn(__fsub_rn(t, d), gm1d)));
      val = fminf(fmaxf(decay, 0.0f), value);
    }
    return __fsub_rn(__fsub_rn(val, __fmul_rn(pon, dt)),
                     __fmul_rn(kTieEps, uf));
  }

  // the spot-first split and the TIE_EPS un-bias (window_opt.split_plan)
  __device__ void put(int tau, int k) const {
    const int s = min(k, slot(tau).spot);
    n_s[tau] = s;
    n_o[tau] = k - s;
  }
  __device__ void put_obj(float o, int total) const {
    *obj = __fadd_rn(o, __fmul_rn(kTieEps, (float)total));
  }
};

// ---- the strip kernel: (W1, TN) known; W1 + 1 warps over 32 rows ----

__host__ __device__ constexpr int hist_off(int s, int tn) {
  // C_{s+1}'s offset: the prefixes of C_1..C_s, (t+1)*tn + 1 units each
  return tn * s * (s + 1) / 2 + s;
}

// One slot of strip s (units s*TN + i, i < TN) in place, in registers:
// C'[u] = min_k C[u-k] + cost[k] over the reachable candidates. C[u-k] is
// this strip's previous value c[i-k] for i >= k, else the strip to the
// left's, left[TN+i-k]. FIRST (s == 0): skip u-k < 0. LAST (s == tau):
// skip u-k > tau*TN, i.e. k < i. Descending i: c[i-k], k >= 1, is still
// the previous slot's.
template <int TN, bool FIRST, bool LAST>
__device__ __forceinline__ void strip_step(float (&c)[TN],
                                           const float (&left)[TN],
                                           const float (&cost)[TN + 1]) {
#pragma unroll
  for (int i = TN - 1; i >= 0; --i) {
    const int klo = LAST ? i : 0;
    const int khi = FIRST ? i : TN;
    float best = 0.0f;
#pragma unroll
    for (int k = 0; k <= TN; ++k) {
      if (k >= klo && k <= khi) {
        float prev;
        if (i >= k) {
          prev = c[i - k];
        } else {
          prev = left[TN + i - k];
        }
        const float cand = __fadd_rn(prev, cost[k]);
        best = (k == klo) ? cand : fminf(best, cand);
      }
    }
    c[i] = best;
  }
}

template <int W1, int TN, class Args, class Row>
__global__ void __launch_bounds__((W1 + 1) * 32, kStripBlocksPerSM)
    window_dp_strips(Args args, long long b) {
  constexpr int U = W1 * TN;
  constexpr int KW = TN + 1;
  __shared__ float hist[hist_off(W1 - 1, TN) * kRows];  // C_1..C_{W1-1}
  __shared__ float s_cost[W1 * KW * kRows];
  // the strips' objective maxima, merged by warp 0, take slot 0's costs'
  // place (the backtrack reads slots 1..W1-1 only)
  static_assert(2 * (W1 + 1) <= KW, "slot 0's costs hold the merge");
  float* red_v = s_cost;
  int* red_i = reinterpret_cast<int*>(s_cost + (W1 + 1) * kRows);
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;  // this warp's strip
  const long long id = (long long)blockIdx.x * kRows + lane;
  const bool valid = id < b;  // rows past b compute row b-1, write nothing
  const Row r(args, valid ? id : b - 1);

  if (s < W1) {  // warp s prices slot s
    const auto sl = r.slot(s);
#pragma unroll
    for (int k = 0; k <= TN; ++k) {
      s_cost[(s * KW + k) * kRows + lane] = sl.cost(k);
    }
  }
  float c[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) c[i] = kBig;  // beyond the reach until set
  if (s == 0) c[0] = 0.0f;
  __syncthreads();

  for (int tau = 0; tau < W1; ++tau) {
    const float* cost_t = s_cost + tau * KW * kRows + lane;
    if (s <= tau) {
      float cost[KW], left[TN];
#pragma unroll
      for (int k = 0; k <= TN; ++k) cost[k] = cost_t[k * kRows];
      if (s > 0) {  // C_tau of the strip to the left (tau >= s >= 1)
        const float* prev =
            hist + (hist_off(tau - 1, TN) + (s - 1) * TN) * kRows + lane;
#pragma unroll
        for (int j = 0; j < TN; ++j) left[j] = prev[j * kRows];
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) left[j] = kBig;  // not read (FIRST)
      }
      if (s == 0) {
        if (tau == 0) {
          strip_step<TN, true, true>(c, left, cost);
        } else {
          strip_step<TN, true, false>(c, left, cost);
        }
      } else if (s == tau) {
        strip_step<TN, false, true>(c, left, cost);
      } else {
        strip_step<TN, false, false>(c, left, cost);
      }
    } else if (s == tau + 1) {
      // the frontier: only unit s*TN is reachable, from C[tau*TN] by k = TN
      const float base =
          tau == 0 ? 0.0f
                   : hist[(hist_off(tau - 1, TN) + tau * TN) * kRows + lane];
      c[0] = __fadd_rn(base, cost_t[TN * kRows]);
    }
    if (tau < W1 - 1) {  // keep C_{tau+1}'s reachable prefix
      float* out = hist + (hist_off(tau, TN) + s * TN) * kRows + lane;
      if (s <= tau) {
#pragma unroll
        for (int i = 0; i < TN; ++i) out[i * kRows] = c[i];
      } else if (s == tau + 1) {
        out[0] = c[0];
      }
      __syncthreads();
    }
  }

  // objective argmax over the prefix length u: first max in each strip,
  // then over the strips in order
  float bv = -INFINITY;
  int bi = 0;
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int u = s * TN + i;
    if (u <= U && c[i] < kBig * 0.5f) {
      const float o = __fsub_rn(r.gain(u), c[i]);
      if (o > bv) {
        bv = o;
        bi = u;
      }
    }
  }
  red_v[s * kRows + lane] = bv;
  red_i[s * kRows + lane] = bi;
  __syncthreads();
  if (s != 0 || !valid) return;  // no barrier below
  for (int t = 1; t <= W1; ++t) {
    const float v = red_v[t * kRows + lane];
    if (v > bv) {
      bv = v;
      bi = red_i[t * kRows + lane];
    }
  }

  // backtrack: the first k attaining the min at the path's unit
  int n_tot[W1];
  int u = bi;
#pragma unroll
  for (int tau = W1 - 1; tau >= 1; --tau) {
    const float* h = hist + hist_off(tau - 1, TN) * kRows + lane;
    const float* cost_t = s_cost + tau * KW * kRows + lane;
    const int reach = tau * TN;
    float best = INFINITY;
    int bk = 0;
#pragma unroll
    for (int k = 0; k <= TN; ++k) {
      const int j = u - k;
      if (j >= 0 && j <= reach) {
        const float cand = __fadd_rn(h[j * kRows], cost_t[k * kRows]);
        if (cand < best) {
          best = cand;
          bk = k;
        }
      }
    }
    n_tot[tau] = bk;
    u -= bk;
  }
  n_tot[0] = u;  // from C_0 = [0, BIG, ...] only k = u reaches below BIG
  int total = 0;
#pragma unroll
  for (int tau = 0; tau < W1; ++tau) {
    r.put(tau, n_tot[tau]);
    total += n_tot[tau];
  }
  r.put_obj(bv, total);
}

// ---- the generic kernel: any (w1, tn), one warp per row ----

// Bytes of shared memory one warp needs, rounded up to 16.
size_t warp_smem_bytes(int w1, int tn) {
  const size_t kw = tn + 1, u1 = (size_t)w1 * tn + 1, plen = tn + u1;
  const size_t bytes = (w1 * kw + 2 * plen) * sizeof(float) + w1 * u1;
  return (bytes + 15) & ~size_t(15);
}

template <class Args, class Row>
__global__ void window_dp_generic(Args args, long long b, int w1, int tn,
                                  int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= b) return;  // the whole warp leaves together
  const Row r(args, row);

  const int kw = tn + 1;
  const int u1 = w1 * tn + 1;
  const int plen = tn + u1;
  float* s_cost = reinterpret_cast<float*>(smem + (size_t)warp * warp_bytes);
  float* cur = s_cost + w1 * kw;
  float* nxt = cur + plen;
  int8_t* choice = reinterpret_cast<int8_t*>(nxt + plen);

  for (int i = lane; i < w1 * kw; i += 32) {
    const int tau = i / kw;
    s_cost[i] = r.slot(tau).cost(i - tau * kw);
  }
  // C = [BIG x tn | 0, BIG, ...]; the left pad of both buffers stays BIG
  for (int i = lane; i < plen; i += 32) {
    cur[i] = (i == tn) ? 0.0f : kBig;
    nxt[i] = kBig;
  }
  __syncwarp();

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

  float bv = -INFINITY;
  int bi = u1;  // sentinel: this lane has seen no unit yet
  for (int u = lane; u < u1; u += 32) {
    const float c = cur[tn + u];
    const float o = (c < kBig * 0.5f) ? __fsub_rn(r.gain(u), c) : -INFINITY;
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

  if (lane == 0) {
    int u = bi, total = 0;
    for (int tau = w1 - 1; tau >= 0; --tau) {
      const int k = choice[tau * u1 + u];
      r.put(tau, k);
      total += k;
      u -= k;
    }
    r.put_obj(bv, total);
  }
}

template <class Args, class Row>
int launch(const Args& args, long long b, int w1, int tn,
           cudaStream_t stream) {
  if (b < 0 || w1 < 1 || tn < 1 || tn > kMaxTableN) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  if (w1 == 6 && tn == 16) {  // the selection path's shape
    const long long blocks = (b + kRows - 1) / kRows;
    window_dp_strips<6, 16, Args, Row>
        <<<(unsigned)blocks, 7 * 32, 0, stream>>>(args, b);
    return (int)cudaGetLastError();
  }
  const size_t warp_bytes = warp_smem_bytes(w1, tn);
  const size_t smem = warp_bytes * kWarpsPerBlock;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;  // set once per size, not per launch
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_dp_generic<Args, Row>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long long blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  window_dp_generic<Args, Row>
      <<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, stream>>>(
          args, b, w1, tn, (int)warp_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Table entry: launches K1 on `stream` over b rows. Returns
// cudaGetLastError() after the launch (0 on success) or
// cudaErrorInvalidValue for shapes it does not take.
int window_dp_launch(const void* slot_cost, const void* gain, void* n_tot,
                     void* obj, long long b, int w1, int tn, void* stream) {
  const TableArgs args{(const float*)slot_cost, (const float*)gain,
                       (int*)n_tot, (float*)obj, w1, tn};
  return launch<TableArgs, TableRow>(args, b, w1, tn, (cudaStream_t)stream);
}

// Forecast entry: in[] holds the eleven input pointers in RowArgs' order
// (prices, avail, z0, slots_to_deadline, workload, deadline, n_min, n_max,
// value, gamma, p_o), out[] n_o, n_s and obj.
int window_dp_rows_launch(const void* const* in, void* const* out,
                          float alpha, float beta, long long b, int w1,
                          int tn, void* stream) {
  const RowArgs args{(const float*)in[0], (const int*)in[1],
                     (const float*)in[2], (const int*)in[3],
                     (const float*)in[4], (const int*)in[5],
                     (const int*)in[6],   (const int*)in[7],
                     (const float*)in[8], (const float*)in[9],
                     (const float*)in[10], (int*)out[0], (int*)out[1],
                     (float*)out[2], alpha, beta, w1, tn};
  return launch<RowArgs, ForecastRow>(args, b, w1, tn, (cudaStream_t)stream);
}

const char* window_dp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
