// The Mamba-2 mixer's depthwise causal conv + silu, forward and backward,
// for Hopper (sm_90a).
//
// No TPU kernel: the reference computes the conv as plain XLA
// (src/repro/models/ssm.py:_causal_conv), and the port's plain version is
// repro_torch/models/ssm.py:_causal_conv, a chain of torch ops over the
// cat of x, B and C (the cat, a pad, four f32 casts of shifted slices,
// their products and sums, the casts back, the bias and silu: about 15
// kernels, some over f32 (B, S, C) tensors). On an H100 that chain was the
// largest piece of mamba2-370m's training step, ~30x its byte bound.
//
// Function, for channel c of xbc = [x | B | C] (Bt, S, C) and wc taps:
//   y[t, c]   = sum_{i < wc} xbc[t - (wc - 1) + i, c] w[c, i]   (zero rows
//               before t = 0)
//   u[t, c]   = R(R(y[t, c]) + b[c])            R: round to the dtype
//   out[t, c] = R(u / (1 + exp(-u)))
// with the plain version's IEEE roundings one for one: each product and
// sum by __fmul_rn / __fadd_rn in order i = 0 .. wc - 1 (the eager ops are
// separate kernels, so nothing there contracts to an FMA), y rounded to
// the dtype, the bias added in f32 and rounded, silu in f32 (expf and an
// IEEE division, as PyTorch's silu) and rounded. So on the card the
// forward is bit-equal to the plain one.
//
// Backward, from the inputs alone (u recomputed as above):
//   g[t, c]  = dy[t, c] s (1 + u (1 - s)),  s = 1 / (1 + exp(-u))   (f32)
//   dx[t, c] = sum_i g[t + wc - 1 - i, c] w[c, i]   (f32, rounded once; i
//              from wc - 1 down, as autograd adds the slices' gradients)
//   dw[c, i] = sum_{b, t} g[t, c] xbc[t - (wc - 1) + i, c],
//   db[c]    = sum_{b, t} g[t, c]
// dx goes straight into the gradients of x, B and C (no cat to undo); dw
// and db as f32 partials, one set per thread's run of tokens, summed by a
// second kernel in a fixed order: no atomics, the same bits every run.
// The plain version of this formula is repro_torch/kernels/ref.py:
// causal_conv_bwd_ref.
//
// Bound: bytes (a few operations an element). The forward reads x, B and
// C once and writes xbc once; the backward reads them and dy and writes
// dx. A thread owns kVec = 8 channels (one 16-byte load of a bf16 row)
// and a run of kTokens tokens, which it walks with the last wc - 1 rows in
// registers, a few rows loaded ahead at a time: each row is read once,
// plus wc - 1 halo rows a run (the backward: wc - 1 more rows of x and of
// dy past the run). Neighbouring threads own neighbouring channel groups,
// so a warp reads 512 contiguous bytes of a bf16 row. x, B and C are read
// where they lie, through their own pointers and strides. A segment whose
// width is a multiple of 8 and whose rows start on 16-byte boundaries
// moves 16 bytes at a time; any other, element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 8;        // channels a thread
constexpr int kTokens = 32;    // tokens a thread
// rows loaded ahead; a thread's run is walked one block of kRows rows at a
// time, not unrolled (on an H100 at mamba2's training shape, 2 rows and
// the loop rolled took the least time of 1 to 8 rows and runs of 16 to 64
// tokens; unrolling the run took twice as long)
constexpr int kRows = 2;
constexpr int kThreads = 128;
constexpr int kMaxWidth = 4;
constexpr int kSegs = 3;       // x, B, C
constexpr int kSumRows = 8;    // the partials' sum: tile runs a column

struct Seg {
  const void* x;         // the input (batch, s, width), rows by strides
  long long x_sb, x_ss;
  const void* dy;        // backward: its part of the cotangent, or null
  long long dy_sb, dy_ss;
  void* dx;              // backward: its gradient (batch, s, width), or null
  int width;             // channels
  int off;               // its first channel in xbc
  int groups;            // ceil(width / kVec)
  int vec;               // 16-byte loads and stores
};

struct Args {
  Seg seg[kSegs];
  const void* w;         // (channels, wc) contiguous
  const void* b;         // (channels,)
  void* out;             // forward: xbc (batch, s, channels) contiguous
  float* part;           // backward: (tiles, wc + 1, channels) f32, or null
  int s, channels, groups, runs;   // runs: runs of kTokens a batch row
  long long tiles;       // batch * runs
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = a.x; v[4 * q + 1] = a.y; v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
};

// kVec bf16 values as one 16-byte load
static_assert(kVec == 8, "a bf16 row's kVec channels are one uint4");
using BF16Vec = uint4;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                                  float* v) {
    const BF16Vec r = __ldg(reinterpret_cast<const BF16Vec*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                                   const float* v) {
    BF16Vec r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    *reinterpret_cast<BF16Vec*>(p) = r;
  }
};

// the first n (<= kVec) channels of a row, zero past them; a null row
// (before t = 0, past S, or an absent cotangent) reads as zeros
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int n, bool vec,
                                         float* v) {
  if (row == nullptr) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = 0.f;
  } else if (vec) {
    Elem<T>::load_vec(row, v);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = k < n ? Elem<T>::load(row + k) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* row, int n, bool vec,
                                          const float* v) {
  if (vec) {
    Elem<T>::store_vec(row, v);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < n) Elem<T>::store(row + k, v[k]);
    }
  }
}

// silu's input u from the wc rows ending at the current one, with the
// forward's roundings
template <typename T, int WC>
__device__ __forceinline__ float pre_activation(float (*win)[kVec],
                                                float (*wt)[kVec], float bias,
                                                int k) {
  float y = __fmul_rn(win[0][k], wt[0][k]);
#pragma unroll
  for (int i = 1; i < WC; ++i) {
    y = __fadd_rn(y, __fmul_rn(win[i][k], wt[i][k]));
  }
  return Elem<T>::round(__fadd_rn(Elem<T>::round(y), bias));
}

// A thread's place: its segment, its channels and its run of tokens.
struct Place {
  Seg sg;
  int cl;        // first channel in the segment
  int c;         // first channel in xbc
  int n;         // channels it owns (kVec but at a ragged segment end)
  int bi, t0;    // batch row and first token
  long long tile;
};

__device__ __forceinline__ bool place(const Args& a, Place& p) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= a.tiles * a.groups) return false;
  int j = (int)(idx % a.groups);
  p.tile = idx / a.groups;
  p.bi = (int)(p.tile / a.runs);
  p.t0 = (int)(p.tile % a.runs) * kTokens;
  // selected field by field with constant indices, so the parameters are
  // not copied to local memory for a dynamic index
  const int g0 = a.seg[0].groups, g1 = a.seg[1].groups;
  const int si = j < g0 ? 0 : (j < g0 + g1 ? 1 : 2);
  j -= si == 0 ? 0 : (si == 1 ? g0 : g0 + g1);
  p.sg = si == 0 ? a.seg[0] : (si == 1 ? a.seg[1] : a.seg[2]);
  p.cl = j * kVec;
  p.c = p.sg.off + p.cl;
  p.n = min(kVec, p.sg.width - p.cl);
  return true;
}

template <typename T, int WC>
__device__ __forceinline__ void load_weights(const Args& a, const Place& p,
                                             float (*wt)[kVec], float* bs) {
  const T* w = static_cast<const T*>(a.w);
  const T* b = static_cast<const T*>(a.b);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const bool in = k < p.n;
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      wt[i][k] = in ? Elem<T>::load(w + (long long)(p.c + k) * WC + i) : 0.f;
    }
    bs[k] = in ? Elem<T>::load(b + p.c + k) : 0.f;
  }
}

template <typename T, int WC>
__global__ void __launch_bounds__(kThreads)
    causal_conv_fwd_kernel(const Args a) {
  Place p;
  if (!place(a, p)) return;
  const bool vec = p.sg.vec != 0;
  float wt[WC][kVec], bs[kVec];
  load_weights<T, WC>(a, p, wt, bs);
  const T* x = static_cast<const T*>(p.sg.x) + p.bi * p.sg.x_sb + p.cl;
  T* out = static_cast<T*>(a.out) + (long long)p.bi * a.s * a.channels + p.c;
  const int t1 = min(p.t0 + kTokens, a.s);

  // rows t - (wc - 1) .. t + R - 1 of the block of R rows at t
  constexpr int R = kRows;
  float win[WC - 1 + R][kVec];
#pragma unroll
  for (int i = 0; i < WC - 1; ++i) {
    const int t = p.t0 - (WC - 1) + i;
    load_row<T>(t >= 0 ? x + t * p.sg.x_ss : nullptr, p.n, vec, win[i]);
  }
#pragma unroll 1
  for (int c = 0; c < kTokens / R; ++c) {
    const int t = p.t0 + c * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_row<T>(t + r < t1 ? x + (t + r) * p.sg.x_ss : nullptr, p.n, vec,
                  win[WC - 1 + r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t + r < t1) {
        float o[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float u = pre_activation<T, WC>(win + r, wt, bs[k], k);
          o[k] = Elem<T>::round(__fdiv_rn(u, __fadd_rn(1.f, expf(-u))));
        }
        store_row<T>(out + (long long)(t + r) * a.channels, p.n, vec, o);
      }
    }
#pragma unroll
    for (int i = 0; i < WC - 1; ++i) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) win[i][k] = win[R + i][k];
    }
  }
}

// Steps t' = t0 .. t0 + kTokens + wc - 2: the row of x and of dy at t',
// g at t', then dx at t = t' - (wc - 1) (once t >= t0) and, for t' in the
// run, the dw / db partials.
template <typename T, int WC, bool DW>
__global__ void __launch_bounds__(kThreads)
    causal_conv_bwd_kernel(const Args a) {
  Place p;
  if (!place(a, p)) return;
  const bool vec = p.sg.vec != 0;
  float wt[WC][kVec], bs[kVec];
  load_weights<T, WC>(a, p, wt, bs);
  const T* x = static_cast<const T*>(p.sg.x) + p.bi * p.sg.x_sb + p.cl;
  const T* dy = p.sg.dy == nullptr
                    ? nullptr
                    : static_cast<const T*>(p.sg.dy) + p.bi * p.sg.dy_sb +
                          p.cl;
  T* dx = p.sg.dx == nullptr
              ? nullptr
              : static_cast<T*>(p.sg.dx) +
                    (long long)p.bi * a.s * p.sg.width + p.cl;
  const int t1 = min(p.t0 + kTokens, a.s);    // the run's dx and partials
  const int tend = min(t1 + WC - 1, a.s);     // the g it reads (zero past)

  constexpr int R = kRows;
  float xw[WC - 1 + R][kVec];   // x at t' - (wc - 1) .. t' + R - 1
  float gw[WC - 1 + R][kVec];   // g at the same steps
  float dwp[DW ? WC : 1][kVec], dbp[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    dbp[k] = 0.f;
#pragma unroll
    for (int i = 0; i < (DW ? WC : 1); ++i) dwp[i][k] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < WC - 1; ++i) {
    const int t = p.t0 - (WC - 1) + i;
    load_row<T>(t >= 0 ? x + t * p.sg.x_ss : nullptr, p.n, vec, xw[i]);
#pragma unroll
    for (int k = 0; k < kVec; ++k) gw[i][k] = 0.f;
  }
#pragma unroll 1
  for (int c = 0; c < (kTokens + WC - 1 + R - 1) / R; ++c) {
    const int t = p.t0 + c * R;
    float dyr[R][kVec];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = t + r < tend;
      load_row<T>(in ? x + (t + r) * p.sg.x_ss : nullptr, p.n, vec,
                  xw[WC - 1 + r]);
      load_row<T>(in && dy != nullptr ? dy + (t + r) * p.sg.dy_ss : nullptr,
                  p.n, vec, dyr[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tp = t + r;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        // the gradient's sigmoid needs no bits of the forward's: the fast
        // exp and division (~2 ulp) are far inside a bf16 rounding
        const float u = pre_activation<T, WC>(xw + r, wt, bs[k], k);
        const float s = __fdividef(1.f, 1.f + __expf(-u));
        gw[WC - 1 + r][k] = tp < tend ? dyr[r][k] * s * (1.f + u * (1.f - s))
                                      : 0.f;
      }
      if (tp < t1) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          dbp[k] += gw[WC - 1 + r][k];
          if (DW) {
#pragma unroll
            for (int i = 0; i < WC; ++i) {
              dwp[DW ? i : 0][k] += gw[WC - 1 + r][k] * xw[r + i][k];
            }
          }
        }
      }
      const int t = tp - (WC - 1);
      if (dx != nullptr && t >= p.t0 && t < t1) {
        float o[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          float v = gw[r][k] * wt[WC - 1][k];
#pragma unroll
          for (int i = WC - 2; i >= 0; --i) {
            v += gw[WC - 1 + r - i][k] * wt[i][k];
          }
          o[k] = v;
        }
        store_row<T>(dx + (long long)t * p.sg.width, p.n, vec, o);
      }
    }
#pragma unroll
    for (int i = 0; i < WC - 1; ++i) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        xw[i][k] = xw[R + i][k];
        gw[i][k] = gw[R + i][k];
      }
    }
  }
  if (a.part != nullptr) {
    float* part = a.part + p.tile * (WC + 1) * a.channels + p.c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < p.n) {
        if (DW) {
#pragma unroll
          for (int i = 0; i < WC; ++i) {
            part[(long long)i * a.channels + k] = dwp[DW ? i : 0][k];
          }
        }
        part[(long long)WC * a.channels + k] = dbp[k];
      }
    }
  }
}

// dw (channels, wc) and db (channels,) from the partials, column (i, c) =
// i * channels + c summed over the tiles: kSumRows threads a column take
// every kSumRows-th tile in order, then one adds their sums in order
template <typename T>
__global__ void __launch_bounds__(32 * kSumRows)
    causal_conv_dw_kernel(const float* part, long long tiles, int wc,
                          int channels, T* dw, T* db) {
  __shared__ float sums[kSumRows][32];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int cols = (wc + 1) * channels;
  float acc = 0.f;
  if (col < cols) {
    for (long long t = threadIdx.y; t < tiles; t += kSumRows) {
      acc += part[t * cols + col];
    }
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || col >= cols) return;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kSumRows; ++r) v += sums[r][threadIdx.x];
  const int i = col / channels, c = col % channels;
  if (i < wc) {
    if (dw != nullptr) Elem<T>::store(dw + (long long)c * wc + i, v);
  } else if (db != nullptr) {
    Elem<T>::store(db + c, v);
  }
}

int fill(Args& a, int batch, int s, int wc) {
  if (batch < 0 || s < 0 || wc < 1 || wc > kMaxWidth) return -1;
  a.channels = 0;
  a.groups = 0;
  for (int i = 0; i < kSegs; ++i) {
    Seg& sg = a.seg[i];
    if (sg.width < 0) return -1;
    sg.off = a.channels;
    sg.groups = (sg.width + kVec - 1) / kVec;
    a.channels += sg.width;
    a.groups += sg.groups;
  }
  a.s = s;
  a.runs = (s + kTokens - 1) / kTokens;
  a.tiles = (long long)batch * a.runs;
  return 0;
}

template <typename T, int WC>
cudaError_t launch_fwd(const Args& a, unsigned blocks, cudaStream_t st) {
  causal_conv_fwd_kernel<T, WC><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const Args& a, int wc, unsigned blocks,
                         cudaStream_t st) {
  switch (wc) {
    case 1: return launch_fwd<T, 1>(a, blocks, st);
    case 2: return launch_fwd<T, 2>(a, blocks, st);
    case 3: return launch_fwd<T, 3>(a, blocks, st);
    default: return launch_fwd<T, 4>(a, blocks, st);
  }
}

template <typename T, int WC>
cudaError_t launch_bwd(const Args& a, bool dw, unsigned blocks,
                       cudaStream_t st) {
  if (dw) {
    causal_conv_bwd_kernel<T, WC, true><<<blocks, kThreads, 0, st>>>(a);
  } else {
    causal_conv_bwd_kernel<T, WC, false><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const Args& a, int wc, bool dw, unsigned blocks,
                         cudaStream_t st, void* dwp, void* dbp) {
  cudaError_t e;
  switch (wc) {
    case 1: e = launch_bwd<T, 1>(a, dw, blocks, st); break;
    case 2: e = launch_bwd<T, 2>(a, dw, blocks, st); break;
    case 3: e = launch_bwd<T, 3>(a, dw, blocks, st); break;
    default: e = launch_bwd<T, 4>(a, dw, blocks, st); break;
  }
  if (e != cudaSuccess || a.part == nullptr) return e;
  const int cols = (wc + 1) * a.channels;
  causal_conv_dw_kernel<T><<<(cols + 31) / 32, dim3(32, kSumRows), 0, st>>>(
      a.part, a.tiles, wc, a.channels, static_cast<T*>(dwp),
      static_cast<T*>(dbp));
  return cudaGetLastError();
}

bool grid(const Args& a, unsigned& blocks) {
  const long long threads = a.tiles * a.groups;
  const long long n = (threads + kThreads - 1) / kThreads;
  if (n > 0x7fffffffLL) return false;
  blocks = (unsigned)n;
  return true;
}

}  // namespace

extern "C" {

// Launches the forward on `stream`: xbc (batch, s, channels) contiguous,
// channels the three widths' sum, from x, B and C (batch, s, width) each
// given by its pointer, its batch and sequence strides in elements (the
// last dimension contiguous), its width and whether its rows move 16
// bytes at a time (width a multiple of 8, rows 16-byte aligned, and in
// xbc too), w (channels, wc) and b (channels,) contiguous; one dtype, 0
// float32 or 1 bfloat16; wc in [1, 4]. Returns cudaGetLastError() after
// the launch (0 on success) or cudaErrorInvalidValue for what it does not
// take.
int causal_conv_fwd_launch(const void* x, long long x_sb, long long x_ss,
                           int x_w, int x_vec, const void* B, long long b_sb,
                           long long b_ss, int b_w, int b_vec, const void* C,
                           long long c_sb, long long c_ss, int c_w,
                           int c_vec, const void* w, const void* b,
                           void* out, int batch, int s, int wc, int dtype,
                           void* stream) {
  Args a{};
  a.seg[0] = Seg{x, x_sb, x_ss, nullptr, 0, 0, nullptr, x_w, 0, 0, x_vec};
  a.seg[1] = Seg{B, b_sb, b_ss, nullptr, 0, 0, nullptr, b_w, 0, 0, b_vec};
  a.seg[2] = Seg{C, c_sb, c_ss, nullptr, 0, 0, nullptr, c_w, 0, 0, c_vec};
  a.w = w;
  a.b = b;
  a.out = out;
  a.part = nullptr;
  unsigned blocks = 0;
  if (fill(a, batch, s, wc) != 0 || !grid(a, blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch_fwd<float>(a, wc, blocks, st);
  if (dtype == 1) return (int)dispatch_fwd<__nv_bfloat16>(a, wc, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// Launches the backward on `stream`. Per segment (x, B, C): the input as
// in the forward, its part of the output's cotangent (pointer and batch /
// sequence strides; null: zero) and its gradient (batch, s, width)
// contiguous (null: not wanted), its width and whether it moves 16 bytes
// at a time (its input's, cotangent's and gradient's rows). part, a
// (causal_conv_scratch_rows(batch, s), wc + 1, channels) f32 scratch
// (one row of partials a run of kTokens tokens), is null when
// neither dw (channels, wc) nor db (channels,) is wanted; either of those
// may be null alone.
int causal_conv_bwd_launch(
    const void* x, long long x_sb, long long x_ss, const void* dx_out,
    long long dxo_sb, long long dxo_ss, void* dx, int x_w, int x_vec,
    const void* B, long long b_sb, long long b_ss, const void* dB_out,
    long long dbo_sb, long long dbo_ss, void* dB, int b_w, int b_vec,
    const void* C, long long c_sb, long long c_ss, const void* dC_out,
    long long dco_sb, long long dco_ss, void* dC, int c_w, int c_vec,
    const void* w, const void* b, void* part, void* dw, void* db, int batch,
    int s, int wc, int dtype, void* stream) {
  Args a{};
  a.seg[0] = Seg{x, x_sb, x_ss, dx_out, dxo_sb, dxo_ss, dx, x_w, 0, 0, x_vec};
  a.seg[1] = Seg{B, b_sb, b_ss, dB_out, dbo_sb, dbo_ss, dB, b_w, 0, 0, b_vec};
  a.seg[2] = Seg{C, c_sb, c_ss, dC_out, dco_sb, dco_ss, dC, c_w, 0, 0, c_vec};
  a.w = w;
  a.b = b;
  a.out = nullptr;
  a.part = static_cast<float*>(part);
  unsigned blocks = 0;
  if (fill(a, batch, s, wc) != 0 || !grid(a, blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool want_dw = part != nullptr && dw != nullptr;
  if (dtype == 0) {
    return (int)dispatch_bwd<float>(a, wc, want_dw, blocks, st, dw, db);
  }
  if (dtype == 1) {
    return (int)dispatch_bwd<__nv_bfloat16>(a, wc, want_dw, blocks, st, dw,
                                            db);
  }
  return (int)cudaErrorInvalidValue;
}

// The rows of the backward's f32 scratch `part` for (batch, s): one a run
// of kTokens tokens of a batch row (-1 for what fill() does not take).
long long causal_conv_scratch_rows(int batch, int s) {
  Args a{};
  return fill(a, batch, s, 1) != 0 ? -1 : a.tiles;
}

const char* causal_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
