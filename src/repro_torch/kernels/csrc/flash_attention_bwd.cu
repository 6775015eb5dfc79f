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
// every tile. Every element evaluates the mask, but on the bf16 index path
// a tile pair that the mask and the edges leave whole. Keys past Sk and
// queries past Sq are zero-filled and get P = 0.
//
// - bfloat16 (the training path): Hopper's warpgroup MMA (wgmma.mma_async
//   m64nNk16, f32 += bf16 x bf16) at every D in {64, 80, 128}; no
//   mma.sync. A block is one warpgroup (128 threads) that owns 64 rows
//   (keys in dkdv, queries in rowdot and dq) and walks the other side 64
//   rows a step through a ring of 2 stages. Thread 0 fills the ring by TMA
//   (cp.async.bulk.tensor, one copy a column block, completing on an
//   mbarrier a stage; the tiles the index path skips are never fetched).
//   Per step:
//   - S (S^T in dkdv) and dP (dP^T) by m64n64k16 with both operands read
//     from shared memory, K-major (the walked tile is B; A is the block's
//     own q / dO or K / V tile), D / 16 instructions each;
//   - P and dS in the f32 accumulator layout (this thread: rows g, g + 8 of
//     its warp's 16, columns 8 j + 2 t, +1), then split into hi + lo bf16
//     halves (x_hi = bf16(x), x_lo = bf16(x - x_hi)), as the forward's p v
//     does, or one bf16 rounding of each would be summed over 1,024 keys
//     (the emulation's record: dq's worst share of GRAD_TOL 0.35 -> 0.83 at
//     D 80). The accumulator layout of 16 columns is the A fragment of
//     m64nDk16, so the halves stay in registers (FA3's register-sourced A).
//     A tile pair whose every pair exists and is kept (the index path's
//     interior) skips the mask; the exponential is branch-free (a
//     conditional expf compiled to a branch an element and tripled the
//     step);
//   - dV += P^T dO and dK += dS^T Q (dkdv), dQ += dS K (dq): m64nDk16, A the
//     hi and lo fragments, B the walked tile (dkdv) or the block's K tile
//     (dq) read MN-major (wgmma's transpose bit), 8 instructions a product.
//   Shared memory holds every tile in wgmma's canonical layout, as TMA
//   writes it: column blocks of 128 bytes with the 128-byte swizzle at D 64
//   and 128, of 32 bytes with the 32-byte swizzle at D 80 (160-byte rows,
//   not a multiple of 64 or 128 bytes), so one copy serves both the K-major
//   (S, dP) and the MN-major (dV, dK, dQ) reads. Six tiles and 1 KB of
//   alignment (+ 2 KB of row statistics in dkdv, which threads 0-63 load a
//   tile ahead into registers): 97 / 99 KB at D 128, 61 / 63 KB at D 80,
//   49 / 51 KB at D 64, at least two blocks an SM. Registers (-Xptxas -v
//   at sm_90a; chip_smoke.py prints them and the spills): dkdv 234-236 at
//   D 128, 189-199 at D 80, 170-172 at D 64 (dK and dV of 64 rows x D, S
//   and dP 32 each, the hi + lo fragments 32 a product); dq 156-168,
//   132-151, 122-128; rowdot 94-96; no spills. No warp specialisation and
//   no setmaxnreg: dkdv needs its 234 registers in all four warps, so a
//   producer warp would leave room for one block an SM, and two blocks an
//   SM already overlap one's tensor work with the other's elementwise
//   work. Two variants measured slower or no faster on the card: a pair of
//   blocks on adjacent row tiles sharing each walked tile by TMA multicast
//   (the cluster barrier a step put both in lockstep), and rowdot issuing
//   tile t + 1's S and dP before tile t's elementwise work. Each wgmma
//   group is waited for before its accumulator or fragments are touched.
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
// us. Bound by operations: 173.9 us. This design issues 24 D operations a
// pair (q k^T and dO V^T in all three passes: 12 D; P^T dO, dS^T Q and dS K
// on hi and lo halves: 12 D), 2.4 times the bound's count: 412.7 G
// operations at that shape, so the issued rate is 412.7 G over the
// kernel's time. What holds it there (clock64 phases on the card): the
// elementwise work of three passes (P from the exact expf in each, about
// 22 instructions an element in dkdv) with two warps a scheduler, and the
// S and dP products reading both operands from shared memory at N = 64.
// chip_smoke.py's `[time]` measures it; PERF.md keeps its times.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using namespace attn;
using namespace hop;
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
// a query past Sq). The exponential is taken whether or not the pair
// exists and the product selected after: a conditional expf compiles to a
// branch per element, which serialises a tile's elements.
__device__ __forceinline__ float prob(float s, bool keep, bool exists,
                                      float m, float inv_l) {
  const float e = expf((keep ? s : kMaskFill) - m);
  return exists ? e * inv_l : 0.0f;
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

// Whether every (query, key) pair of the 64 x 64 tile pair at (q0, k0)
// exists and is kept, so its elements may skip the mask: the index path
// only (the position path tests every element).
template <bool kPos>
__device__ __forceinline__ bool whole_tile(int q0, int k0, const Args& a) {
  return !kPos && q0 + kBQ <= a.sq && k0 + kBKV <= a.sk &&
         (!a.causal || k0 + kBKV - 1 <= q0) &&
         (a.window <= 0 || k0 + a.window > q0 + kBQ - 1);
}

// Sets the dynamic shared memory limit of each kernel that needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t smem_attrs(const Kernel (&kernels)[3], const size_t (&bytes)[3]) {
  for (int i = 0; i < 3; ++i) {
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
// bfloat16: warpgroup MMA
// ---------------------------------------------------------------------------

constexpr int kRows = 64;        // a block's own rows: one warpgroup's M
constexpr int kCols = 64;        // the walked tile's rows a step: S's N
constexpr int kStages = 2;       // the walked tiles' ring
constexpr int kWgThreads = 128;  // one warpgroup a block
// the tile ranges the index path visits are the f32 kernels' (key_tiles,
// query_tiles), whose tiles are the forward's
static_assert(kRows == kBQ && kCols == kBKV, "bf16 tiles");

// A 64-row bf16 tile of D columns in shared memory, in wgmma's canonical
// layout: column blocks of kSw bytes (kSw / 2 elements), each 64 rows of
// kSw bytes, the 16-byte chunks of every row permuted by the kSw-byte
// swizzle (chunk ^= (address >> 7) & (kSw / 16 - 1), as TMA writes it; the
// pattern is on the address, so every tile starts on a 1,024-byte
// boundary).
template <int D>
struct SwTile {
  static constexpr int kSw = D % 64 == 0 ? 128 : 32;
  static constexpr uint32_t kBlock = kRows * kSw;  // bytes a column block
  static constexpr uint32_t kBytes = kRows * D * 2;
  static constexpr uint64_t kMode = kSw == 128 ? 1 : 3;  // layout type
  static_assert(kBytes % 1024 == 0, "tiles keep the 1,024-byte alignment");

  // shared memory matrix descriptor: start address, leading and stride
  // byte offsets (16-byte units), swizzle mode
  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo,
                                  uint32_t sbo) {
    return hop::desc(addr, lbo, sbo, kMode);
  }
  // the tile as a K-major operand (its rows are M or N): columns [16 kk,
  // 16 kk + 16), 8-row groups kSw x 8 bytes apart (the leading offset is
  // unused by a swizzled K-major operand)
  __device__ static uint64_t k_major(uint32_t base, int kk) {
    const int col = kk * 16;
    return desc(base + (col / (kSw / 2)) * kBlock + (col % (kSw / 2)) * 2, 16,
                8 * kSw);
  }
  // the tile as an MN-major operand (its rows are K, its columns N): rows
  // [16 kr, 16 kr + 16), column blocks kBlock apart (leading), 8-row groups
  // kSw x 8 bytes apart (stride)
  __device__ static uint64_t mn_major(uint32_t base, int kr) {
    return desc(base + kr * 16 * kSw, kBlock, 8 * kSw);
  }
};

// The bf16 tensors as TMA tensor maps: (BH, rows, D) as a 3-D map whose box
// is one column block of 64 rows, swizzled as SwTile (the hardware writes
// the canonical layout); rows past the tensor's end are zero-filled.
struct Maps {
  CUtensorMap q, k, v, dout;
};

// Rows [row0, row0 + 64) of (bh, .., D) into a tile by TMA, one copy a
// column block, completing on the mbarrier bar (one thread issues it).
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap& map,
                                          uint64_t* bar, int row0, int bh) {
  using T = SwTile<D>;
#pragma unroll
  for (int cb = 0; cb < D / (T::kSw / 2); ++cb) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
            tc::smem_addr(dst + cb * T::kBlock)),
        "l"(&map), "r"(tc::smem_addr(bar)), "r"(cb * (T::kSw / 2)), "r"(row0),
        "r"(bh)
        : "memory");
  }
}

// The stage barriers, initialised by thread 0 before any TMA is issued.
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  __syncthreads();
}

// d (64 x 80, f32) += a b: A (64 x 16) in registers, B from shared memory,
// MN-major
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (64 x 128, f32) += a b: A (64 x 16) in registers, B from shared memory,
// MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

// d (64 x D) += a b, a in registers, b MN-major
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (D == 80) {
    wgmma_rs_n80(d, a, b);
  } else {
    static_assert(D == 128, "head dims 64, 80, 128");
    wgmma_rs_n128(d, a, b);
  }
}

template <int D>
__host__ __device__ constexpr size_t bf16_tiles_bytes() {
  // six tiles (rowdot and dq: q, dO and the ring of K and V; dkdv: K, V and
  // the ring of q and dO) and the 1 KB of alignment
  return 1024 + (2 + 2 * kStages) * (size_t)SwTile<D>::kBytes;
}

// dkdv's row statistics: m, 1 / l, D and the query position, a stage each
constexpr size_t kStatsBytes = kStages * 4 * kCols * sizeof(float);

// Stores a warpgroup's 64 x D accumulator (this thread: rows row_a and
// row_a + 8, columns 8 j + 2 t, +1 of n8 block j) to a (.., D) bf16
// matrix, rows below nrows.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 2],
                                           int row_a, int nrows, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    if (row < nrows) {
      bf16* out = dst + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// rowdot (kDq false: D_i = sum_j P_ij dP_ij into dsum) and dq (kDq true:
// dQ = sum_j dS_ij K_j), one warpgroup per (query tile, bh) walking the
// key tiles.
template <int D, bool kPos, bool kDq>
__global__ void __launch_bounds__(kWgThreads)
    bwd_q_bf16_kernel(Args a, const __grid_constant__ Maps maps) {
  using T = SwTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1k(smem_raw);
  unsigned char* dos = qs + T::kBytes;
  unsigned char* ks = dos + T::kBytes;            // kStages buffers
  unsigned char* vs = ks + kStages * T::kBytes;   // kStages buffers
  __shared__ uint64_t bars[kStages];  // stage s's K and V (stage 0: q, dO)
  const uint32_t qs_a = tc::smem_addr(qs), dos_a = tc::smem_addr(dos);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const int bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;

  int kt_begin, kt_end;
  key_tiles<kPos>(q0, sk, a.causal, a.window, kt_begin, kt_end);
  init_barriers(bars);
  if (kt_begin < kt_end && threadIdx.x == 0) {
    mbar_expect(bars, 4 * T::kBytes);
    load_tile<D>(qs, maps.q, bars, q0, bh);
    load_tile<D>(dos, maps.dout, bars, q0, bh);
    load_tile<D>(ks, maps.k, bars, kt_begin * kCols, bh);
    load_tile<D>(vs, maps.v, bars, kt_begin * kCols, bh);
  }

  // this thread's rows row_a (h = 0) and row_a + 8 (h = 1)
  const int row_a = q0 + warp * 16 + g;
  int qpos[2];
  bool row_ok[2];
  float m_row[2], inv_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_a + h * 8;
    const size_t i = (size_t)bh * sq + row;
    row_ok[h] = row < sq;
    qpos[h] = kPos ? (row_ok[h] ? __ldg(a.q_pos + row) : 0) : row;
    m_row[h] = row_ok[h] ? a.m[i] : 0.0f;
    inv_row[h] = row_ok[h] ? 1.0f / fmaxf(a.l[i], 1e-30f) : 0.0f;
    d_row[h] = kDq && row_ok[h] ? a.dsum[i] : 0.0f;
  }
  float acc[kDq ? D / 2 : 1];
#pragma unroll
  for (int j = 0; j < (kDq ? D / 2 : 1); ++j) acc[j] = 0.0f;
  float dsum_part[2] = {0.0f, 0.0f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) % kStages;
    // tile kt (and at first q, dO) has landed; every thread is past tile
    // kt - 1, whose stage the next tile refills
    mbar_wait(bars + buf, (kt - kt_begin) / kStages & 1);
    __syncthreads();
    if (kt + 1 < kt_end && threadIdx.x == 0) {
      const int nb = (buf + 1) % kStages;
      mbar_expect(bars + nb, 2 * T::kBytes);
      load_tile<D>(ks + nb * T::kBytes, maps.k, bars + nb, (kt + 1) * kCols,
                   bh);
      load_tile<D>(vs + nb * T::kBytes, maps.v, bars + nb, (kt + 1) * kCols,
                   bh);
    }
    const uint32_t k_a = tc::smem_addr(ks + buf * T::kBytes);
    const uint32_t v_a = tc::smem_addr(vs + buf * T::kBytes);
    const int k0 = kt * kCols;

    // s = q k^T and dp = dO v^T over the tile's 64 keys
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, T::k_major(qs_a, kk), T::k_major(k_a, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(dp, T::k_major(dos_a, kk), T::k_major(v_a, kk), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    hold(s);
    hold(dp);

    // element 4 j + e: row h = e >> 1, key k0 + 8 j + 2 t + (e & 1); P,
    // then D's terms or dS (in place of s); a whole tile skips the mask
    auto elementwise = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kidx = k0 + 8 * j + 2 * t + c;
          const int kp = kPos ? key_pos(a.k_pos, kidx, sk) : kidx;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + c;
            const bool keep =
                kWhole || kept(qpos[h], kp, a.causal, a.window);
            const bool exists = kWhole || (row_ok[h] && kidx < sk);
            const float p = prob(__fmul_rn(s[i], a.sm_scale), keep, exists,
                                 m_row[h], inv_row[h]);
            if (kDq) {
              s[i] = keep && exists ? p * (dp[i] - d_row[h]) * a.sm_scale
                                    : 0.0f;
            } else {
              dsum_part[h] += p * dp[i];
            }
          }
        }
      }
    };
    if (whole_tile<kPos>(q0, k0, a)) {
      elementwise(std::true_type{});
    } else {
      elementwise(std::false_type{});
    }
    if constexpr (kDq) {
      // dq += dS k over the 64 keys: k read MN-major
      uint32_t hi[4][4], lo[4][4];
      split_a(s, hi, lo);
      wg_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs<D>(acc, hi[kq], T::mn_major(k_a, kq));
        wgmma_rs<D>(acc, lo[kq], T::mn_major(k_a, kq));
      }
      wg_commit();
      wg_wait_all();
      hold(acc);
      hold(hi);
      hold(lo);
    }
  }

  if constexpr (kDq) {
    store_rows<D>(static_cast<bf16*>(a.dq) + (size_t)bh * sq * D, acc, row_a,
                  sq, t);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dsum_part[h];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t == 0 && row_ok[h]) a.dsum[(size_t)bh * sq + row_a + h * 8] = v;
    }
  }
}

// dkdv, one warpgroup per (key tile, bh): dK and dV of its 64 keys in
// registers, walking the query tiles.
template <int D, bool kPos>
__global__ void __launch_bounds__(kWgThreads)
    bwd_kv_bf16_kernel(Args a, const __grid_constant__ Maps maps) {
  using T = SwTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_1k(smem_raw);
  unsigned char* vs = ks + T::kBytes;
  unsigned char* qs = vs + T::kBytes;             // kStages buffers
  unsigned char* dos = qs + kStages * T::kBytes;  // kStages buffers
  // per stage: m, 1 / l, D, the query position of each of the 64 rows
  float* stats = reinterpret_cast<float*>(dos + kStages * T::kBytes);
  __shared__ uint64_t bars[kStages];  // stage s's q and dO (stage 0: K, V)
  const uint32_t ks_a = tc::smem_addr(ks), vs_a = tc::smem_addr(vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows;  // causal: the first have most queries
  const int bh = blockIdx.y;
  const int sq = a.sq, sk = a.sk;

  // the row statistics of a query tile: thread r < 64 loads row q0 + r's
  // m, l, D and position into registers a tile before it stores them (m,
  // 1 / l, D, position) into a stage, so the loads' latency is hidden
  // (plain loads: a row of m and l need not be 16-byte aligned)
  float st_m = 0.0f, st_l = 0.0f, st_d = 0.0f;
  int st_p = 0;
  bool st_ok = false;
  auto fetch_stats = [&](int q0) {
    if (threadIdx.x < kCols) {
      const int row = q0 + threadIdx.x;
      const size_t i = (size_t)bh * sq + row;
      st_ok = row < sq;
      st_m = st_ok ? a.m[i] : 0.0f;
      st_l = st_ok ? a.l[i] : 0.0f;
      st_d = st_ok ? a.dsum[i] : 0.0f;
      st_p = kPos ? (st_ok ? __ldg(a.q_pos + row) : 0) : row;
    }
  };
  auto store_stats = [&](int b) {
    if (threadIdx.x < kCols) {
      float* st = stats + b * 4 * kCols;
      st[threadIdx.x] = st_m;
      st[kCols + threadIdx.x] = st_ok ? 1.0f / fmaxf(st_l, 1e-30f) : 0.0f;
      st[2 * kCols + threadIdx.x] = st_d;
      reinterpret_cast<int*>(st)[3 * kCols + threadIdx.x] = st_p;
    }
  };

  int qt_begin, qt_end;
  query_tiles<kPos>(k0, sq, a.causal, a.window, qt_begin, qt_end);
  init_barriers(bars);
  if (qt_begin < qt_end) {
    if (threadIdx.x == 0) {
      mbar_expect(bars, 4 * T::kBytes);
      load_tile<D>(ks, maps.k, bars, k0, bh);
      load_tile<D>(vs, maps.v, bars, k0, bh);
      load_tile<D>(qs, maps.q, bars, qt_begin * kCols, bh);
      load_tile<D>(dos, maps.dout, bars, qt_begin * kCols, bh);
    }
    fetch_stats(qt_begin * kCols);
    store_stats(0);
  }
  if (qt_begin + 1 < qt_end) fetch_stats((qt_begin + 1) * kCols);

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
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.0f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) % kStages;
    // tile qt (and at first K, V) has landed, and its statistics are
    // stored; every thread is past tile qt - 1, whose stage the next fills
    mbar_wait(bars + buf, (qt - qt_begin) / kStages & 1);
    __syncthreads();
    if (qt + 1 < qt_end) {
      const int nb = (buf + 1) % kStages;
      if (threadIdx.x == 0) {
        mbar_expect(bars + nb, 2 * T::kBytes);
        load_tile<D>(qs + nb * T::kBytes, maps.q, bars + nb,
                     (qt + 1) * kCols, bh);
        load_tile<D>(dos + nb * T::kBytes, maps.dout, bars + nb,
                     (qt + 1) * kCols, bh);
      }
      store_stats(nb);
    }
    if (qt + 2 < qt_end) fetch_stats((qt + 2) * kCols);
    const uint32_t q_a = tc::smem_addr(qs + buf * T::kBytes);
    const uint32_t do_a = tc::smem_addr(dos + buf * T::kBytes);
    const float* st = stats + buf * 4 * kCols;
    const int q0 = qt * kCols;

    // s^T = k q^T and dp^T = v dO^T over the tile's 64 queries
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, T::k_major(ks_a, kk), T::k_major(q_a, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n64(dp, T::k_major(vs_a, kk), T::k_major(do_a, kk), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    hold(s);
    hold(dp);

    // element 4 j + e: key h = e >> 1, query 8 j + 2 t + (e & 1) of the
    // tile; P in place of s, dS in place of dp; a whole tile skips the mask
    auto elementwise = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ql = 8 * j + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(st + ql);
        const float2 l2 = *reinterpret_cast<const float2*>(st + kCols + ql);
        const float2 d2 =
            *reinterpret_cast<const float2*>(st + 2 * kCols + ql);
        const int2 p2 = *reinterpret_cast<const int2*>(st + 3 * kCols + ql);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float m = c ? m2.y : m2.x, inv_l = c ? l2.y : l2.x;
          const float dd = c ? d2.y : d2.x;
          const int qp = c ? p2.y : p2.x;
          const bool q_ok = q0 + ql + c < sq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + c;
            const bool keep = kWhole || kept(qp, kpos[h], a.causal, a.window);
            const bool exists = kWhole || (q_ok && key_ok[h]);
            const float p =
                prob(__fmul_rn(s[i], a.sm_scale), keep, exists, m, inv_l);
            s[i] = p;
            dp[i] = keep && exists ? p * (dp[i] - dd) * a.sm_scale : 0.0f;
          }
        }
      }
    };
    if (whole_tile<kPos>(q0, k0, a)) {
      elementwise(std::true_type{});
    } else {
      elementwise(std::false_type{});
    }
    // dv += P^T dO, then dk += dS^T q, over the 64 queries: dO and q read
    // MN-major; the P fragments stay live until the wait
    uint32_t ph[4][4], pl[4][4];
    split_a(s, ph, pl);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      wgmma_rs<D>(dv, ph[kq], T::mn_major(do_a, kq));
      wgmma_rs<D>(dv, pl[kq], T::mn_major(do_a, kq));
    }
    wg_commit();
    uint32_t sh[4][4], sl[4][4];
    split_a(dp, sh, sl);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      wgmma_rs<D>(dk, sh[kq], T::mn_major(q_a, kq));
      wgmma_rs<D>(dk, sl[kq], T::mn_major(q_a, kq));
    }
    wg_commit();
    wg_wait_all();
    hold(dk);
    hold(dv);
    hold(ph);
    hold(pl);
    hold(sh);
    hold(sl);
  }

  store_rows<D>(static_cast<bf16*>(a.dk) + (size_t)bh * sk * D, dk, key_a,
                sk, t);
  store_rows<D>(static_cast<bf16*>(a.dv) + (size_t)bh * sk * D, dv, key_a,
                sk, t);
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

// The tensor map of a (bh, rows, D) bf16 tensor for load_tile.
template <int D>
bool tile_map(CUtensorMap* map, const void* base, int bh, int rows) {
  using Tl = SwTile<D>;
  const auto encode = encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Tl::kSw / 2, (cuuint32_t)kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Tl::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the three kernels on `stream` in order: rowdot, dkdv, dq. Each
// kernel's shared memory limit is set once per instantiation, so no launch
// inside a CUDA graph capture sets a function attribute.
template <typename T, int D, bool kPos>
int launch(const Args& a, int bh, cudaStream_t stream) {
  const dim3 q_grid((a.sq + kBQ - 1) / kBQ, bh);
  const dim3 kv_grid((a.sk + kBKV - 1) / kBKV, bh);
  cudaError_t e;
  if constexpr (std::is_same_v<T, bf16>) {
    using Kernel = void (*)(Args, Maps);
    const Kernel kernels[3] = {bwd_q_bf16_kernel<D, kPos, false>,
                               bwd_q_bf16_kernel<D, kPos, true>,
                               bwd_kv_bf16_kernel<D, kPos>};
    constexpr size_t q_smem = bf16_tiles_bytes<D>();
    const size_t bytes[3] = {q_smem, q_smem, q_smem + kStatsBytes};
    static const cudaError_t attr = smem_attrs(kernels, bytes);
    if (attr != cudaSuccess) return (int)attr;
    Maps maps;
    if (!tile_map<D>(&maps.q, a.q, bh, a.sq) ||
        !tile_map<D>(&maps.k, a.k, bh, a.sk) ||
        !tile_map<D>(&maps.v, a.v, bh, a.sk) ||
        !tile_map<D>(&maps.dout, a.dout, bh, a.sq)) {
      return (int)cudaErrorInvalidValue;
    }
    kernels[0]<<<q_grid, kWgThreads, bytes[0], stream>>>(a, maps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    kernels[2]<<<kv_grid, kWgThreads, bytes[2], stream>>>(a, maps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    kernels[1]<<<q_grid, kWgThreads, bytes[1], stream>>>(a, maps);
  } else {
    using Kernel = void (*)(Args);
    const Kernel kernels[3] = {bwd_q_f32_kernel<D, kPos, false>,
                               bwd_q_f32_kernel<D, kPos, true>,
                               bwd_kv_f32_kernel<D, kPos>};
    const size_t bytes[3] = {f32_q_smem_bytes<D>(), f32_q_smem_bytes<D>(),
                             f32_kv_smem_bytes<D>()};
    static const cudaError_t attr = smem_attrs(kernels, bytes);
    if (attr != cudaSuccess) return (int)attr;
    kernels[0]<<<q_grid, kF32Threads, bytes[0], stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    kernels[2]<<<kv_grid, kF32Threads, bytes[2], stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    kernels[1]<<<q_grid, kF32Threads, bytes[1], stream>>>(a);
  }
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

// The dynamic shared memory bytes one launch gives each kernel (kernel 0:
// rowdot and dq, 1: dkdv) at head dim d and dtype (0 float32, 1
// bfloat16); -1 for what the launch does not take.
int flash_attention_bwd_smem_bytes(int d, int dtype, int kernel) {
  if (kernel != 0 && kernel != 1) return -1;
  if (dtype == 1) {
    const size_t extra = kernel == 1 ? kStatsBytes : 0;
    if (d == 64) return (int)(bf16_tiles_bytes<64>() + extra);
    if (d == 80) return (int)(bf16_tiles_bytes<80>() + extra);
    if (d == 128) return (int)(bf16_tiles_bytes<128>() + extra);
  } else if (dtype == 0) {
    if (d == 64) return (int)(kernel ? f32_kv_smem_bytes<64>() : f32_q_smem_bytes<64>());
    if (d == 80) return (int)(kernel ? f32_kv_smem_bytes<80>() : f32_q_smem_bytes<80>());
    if (d == 128) return (int)(kernel ? f32_kv_smem_bytes<128>() : f32_q_smem_bytes<128>());
  }
  return -1;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
