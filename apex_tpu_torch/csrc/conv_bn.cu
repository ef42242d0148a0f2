// The three conv+BN matmul kernels of RN50's 1x1 convolutions (a 1x1
// convolution in NHWC is a matmul over (N*H*W, C)): the matmul with a
// per-column stats epilogue, the same matmul with a BatchNorm (+ ReLU)
// prologue on its left operand, and the dual-output matmul backward.
//
// Replaces:
// - apex_tpu/ops/conv_bn.py::_matmul_stats_kernel (launched by
//   _matmul_stats_fwd) with apex_conv_bn_fwd and a null mean: y = x @ w
//   with fp32 accumulation, stored in x's dtype, and the per-column
//   sum(y) and sum(y*y) of the STORED (rounded) values, in fp32;
// - apex_tpu/ops/conv_bn.py::_bn_relu_matmul_kernel (launched by
//   _bn_relu_matmul_fwd) with apex_conv_bn_fwd and the BN parameters:
//   each left-operand element becomes (x - mean) * (rstd * gamma) + beta
//   in fp32 (the product rstd * gamma formed first, every parameter read
//   as fp32, as the wrapper casts them), then max(., 0) when relu is set,
//   then rounded to w's dtype before the product; the normalised tensor
//   never reaches device memory; same epilogue;
// - apex_tpu/ops/conv_bn.py::_matmul_bwd_dual_kernel (launched by
//   matmul_bwd_dual) with apex_matmul_bwd_dual: dx = dy @ w^T in x's
//   dtype and dw = x^T @ dy, always fp32.
//
// Two designs, picked by the wrapper (ops/conv_bn.py::_conv_bn_design)
// and passed in as a design code:
// - the Hopper kernels (second half of this file, hopper_gemm.cuh) for
//   bf16 matmul_stats, bf16 bn_relu_matmul (the same kernel with the BN
//   prologue applied in shared memory between the TMA load and the
//   wgmma) and the bf16 dual backward, whose matrices TMA can read
//   (16-byte aligned bases, rows a whole number of 16 bytes): wgmma fed
//   by a TMA/mbarrier ring, persistent blocks;
// - the mma.sync / FMA kernels (first half) for everything else: fp32
//   (wgmma has no exact fp32; the reference's fp32 dot is exact fp32),
//   mixed dtypes, and rows TMA cannot describe (with the BN prologue in
//   their operand loads for bn_relu_matmul).
//
// Products: bf16 operands go to the tensor cores (wgmma or mma.sync)
// with fp32 accumulation (what the MXU does with
// preferred_element_type=f32: exact products, fp32 sums); any fp32
// operand makes the product an fp32 one, done as fp32 FMAs on the CUDA
// cores in the mma.sync fragment layout.  Sums are taken in another
// order than the TPU's.  No float atomics anywhere: every partial is
// added in a fixed order, so y, the stats, dx and dw are the same bits
// on every run.
//
// Bound on the H100: bytes at every RN50 shape but the stage-4 ones.  At
// (401408, 256, 64) bf16 the forward moves 257 MB (0.077 ms at 3.35 TB/s)
// for 13.2 GFLOP (0.013 ms at 989 TFLOP/s); the dual backward reads x, dy
// and w and writes dx and an fp32 dw: 462 MB, 0.138 ms.
//
// The mma.sync / FMA design:
// - one block of 256 threads owns a 128 x 128 output tile and walks the
//   reduction in steps of 32 through shared memory; the next step's
//   operands are loaded into registers while the tensor cores work on the
//   current one.  Each operand is staged as S[line][reduction index] (a
//   row of the output tile or a column, and the summed index contiguous),
//   so the mma fragments come from shared memory by ldmatrix, four 8 x 8
//   matrices a load, conflict-free on 80-byte lines; global reads are
//   coalesced along whichever index is contiguous in memory, as 16-byte
//   vectors where that index's extent is a whole number of them, else
//   element by element.  Ragged edges are masked as they are loaded
//   (zeros), so any M, K and N work.
// - 8 warps in 2 x 4, each 64 x 32 of the tile: 16 mma per k16 step;
//   registers capped so that two blocks share an SM.
// - the stats epilogue sums the rounded stored values of each column of
//   the tile by warp shuffles and one fixed-order shared-memory step into
//   an fp32 (row blocks, 2, N) partials buffer; a second kernel adds the
//   partials of each column in row-block order.
// - the dual backward runs dx's tiles and dw's in one launch: dx tiles
//   reduce over N; dw is cut into a bounded number of row chunks (about
//   two blocks per SM in all), each block writing its chunk's fp32
//   (K, N) tile partial; a second kernel adds the chunks in order.  The
//   dw blocks come first and take every resident slot, so the dx blocks
//   run after them, not beside them (PERF.md §6).
//
// The Hopper designs are described where they start, below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper_gemm.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                        // output tile, both sides
constexpr int kStep = 32;                         // reduction per stage
constexpr int kLoads = kTile * kStep / kThreads;  // 16 per operand, thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Padded line length of a staged operand: bf16 lines of 40 (80 bytes)
// make the fragment loads of a warp hit 32 distinct banks.
template <typename CT> struct Ld;
template <> struct Ld<bf16> { static constexpr int v = kStep + 8; };
template <> struct Ld<float> { static constexpr int v = kStep + 1; };

// The BatchNorm prologue of the forward's left operand.
struct BnParams {
  const float* mean;  // null: no prologue
  const float* rstd;
  const float* gamma;
  const float* beta;
  int relu;
};

// One operand of a tile product: element (line i, reduction r) of the
// tile lives at src[(line0 + i) * s_line + (red0 + r) * s_red]; lines at
// or past n_lines and reduction indices at or past red_end read as 0.
template <typename T>
struct Operand {
  const T* src;
  long long n_lines, s_line, s_red, line0;
};

// Load the tile's 16 elements of this thread at reduction offset red0,
// converted (and, for BN, normalised) and rounded to the compute type.
// RC: the reduction index is the contiguous one in memory, so
// neighbouring threads take neighbouring reduction indices; otherwise
// neighbouring lines.
template <typename CT, typename T, bool RC, bool BN>
__device__ __forceinline__ void load_tile(CT (&reg)[kLoads],
                                          const Operand<T>& op,
                                          long long red0, long long red_end,
                                          const BnParams& bn) {
#pragma unroll
  for (int e = 0; e < kLoads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int i = RC ? idx / kStep : idx % kTile;
    const int r = RC ? idx % kStep : idx / kTile;
    const long long line = op.line0 + i;
    const long long red = red0 + r;
    float v = 0.f;
    if (line < op.n_lines && red < red_end) {
      v = to_f32(op.src[line * op.s_line + red * op.s_red]);
      if (BN) {
        // rstd * gamma first, then (x - mean) * that + beta, each
        // operation rounded once (no contraction into an FMA)
        const float scale = __fmul_rn(bn.rstd[red], bn.gamma[red]);
        v = __fadd_rn(__fmul_rn(__fsub_rn(v, bn.mean[red]), scale),
                      bn.beta[red]);
        if (bn.relu) v = fmaxf(v, 0.f);
      }
    }
    reg[e] = from_f32<CT>(v);
  }
}

template <typename CT, bool RC>
__device__ __forceinline__ void store_tile(CT (*s)[Ld<CT>::v],
                                           const CT (&reg)[kLoads]) {
#pragma unroll
  for (int e = 0; e < kLoads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int i = RC ? idx / kStep : idx % kTile;
    const int r = RC ? idx % kStep : idx / kTile;
    s[i][r] = reg[e];
  }
}

// The staging registers of one operand for one stage.  VEC: 16-byte
// vectors along the index that is contiguous in memory (the host checks
// that its extent is a multiple of the vector and the base 16-byte
// aligned), converted (and normalised) as they are written to shared
// memory; otherwise single elements, converted as they are loaded.
template <typename CT, typename T, bool RC, bool BN, bool VEC>
struct Stage {
  CT reg[kLoads];
  __device__ __forceinline__ void load(const Operand<T>& op, long long red0,
                                       long long red_end,
                                       const BnParams& bn) {
    load_tile<CT, T, RC, BN>(reg, op, red0, red_end, bn);
  }
  __device__ __forceinline__ void store(CT (*s)[Ld<CT>::v],
                                        const Operand<T>&, long long,
                                        long long, const BnParams&) const {
    store_tile<CT, RC>(s, reg);
  }
};

template <typename CT, typename T, bool RC, bool BN>
struct Stage<CT, T, RC, BN, true> {
  static constexpr int kV = 16 / sizeof(T);  // elements per vector
  static constexpr int kN = kTile * kStep / kV / kThreads;
  uint4 raw[kN];

  // vector e of this thread starts at (line i, reduction index r)
  __device__ __forceinline__ static void pos(int e, int& i, int& r) {
    const int v = threadIdx.x + e * kThreads;
    if (RC) {
      i = v / (kStep / kV);
      r = (v % (kStep / kV)) * kV;
    } else {
      r = v / (kTile / kV);
      i = (v % (kTile / kV)) * kV;
    }
  }
  __device__ __forceinline__ void load(const Operand<T>& op, long long red0,
                                       long long red_end, const BnParams&) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      int i, r;
      pos(e, i, r);
      const long long line = op.line0 + i, red = red0 + r;
      raw[e] = (line < op.n_lines && red < red_end)
                   ? __ldg(reinterpret_cast<const uint4*>(
                         op.src + line * op.s_line + red * op.s_red))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(CT (*s)[Ld<CT>::v],
                                        const Operand<T>& op, long long red0,
                                        long long red_end,
                                        const BnParams& bn) const {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      int i, r;
      pos(e, i, r);
      if (RC && !BN && std::is_same<CT, T>::value && sizeof(T) == 2) {
        // bf16 in, bf16 staged: the vector as it is (80-byte lines keep
        // every 8-element run 16-byte aligned)
        *reinterpret_cast<uint4*>(&s[i][r]) = raw[e];
        continue;
      }
      const T* vals = reinterpret_cast<const T*>(&raw[e]);
      const bool valid = op.line0 + i < op.n_lines && red0 + r < red_end;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        float v = to_f32(vals[j]);
        if (BN && valid) {  // RC: the reduction index runs along j
          const long long red = red0 + r + j;
          const float scale = __fmul_rn(bn.rstd[red], bn.gamma[red]);
          v = __fadd_rn(__fmul_rn(__fsub_rn(v, bn.mean[red]), scale),
                        bn.beta[red]);
          if (bn.relu) v = fmaxf(v, 0.f);
        }
        if (RC) {
          s[i][r + j] = from_f32<CT>(v);
        } else {
          s[i + j][r] = from_f32<CT>(v);
        }
      }
    }
  }
};

// acc[mi][ni][j] of warp (wm, wn) is the output element at row
// wm*64 + mi*16 + g + 8*(j >= 2), column wn*32 + ni*8 + 2*t + (j & 1),
// with g = lane / 4, t = lane % 4 (the mma.sync C fragment).
__device__ __forceinline__ void compute_step(float (&acc)[4][4][4],
                                             bf16 (*sa)[Ld<bf16>::v],
                                             bf16 (*sb)[Ld<bf16>::v]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane / 8, rr = lane % 8;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int ks = 0; ks < kStep; ks += 16) {
    uint32_t af[4][4], bfr[4][2];
    // A (rows x k): matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7,
    // 8-15), (8-15, 8-15) are the fragment's registers 0-3
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      ldmatrix_x4(af[mi], &sa[wm * 64 + mi * 16 + (q & 1) * 8 + rr]
                             [ks + (q >> 1) * 8]);
    }
    // B (columns x k): two n8 tiles a load, k 0-7 and 8-15 of each
#pragma unroll
    for (int np = 0; np < 4; np += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, &sb[wn * 32 + (np + (q >> 1)) * 8 + rr][ks + (q & 1) * 8]);
      bfr[np][0] = r[0];
      bfr[np][1] = r[1];
      bfr[np + 1][0] = r[2];
      bfr[np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
}

// The fp32 product in the same fragment layout, as fp32 FMAs in
// ascending reduction order.
__device__ __forceinline__ void compute_step(float (&acc)[4][4][4],
                                             float (*sa)[Ld<float>::v],
                                             float (*sb)[Ld<float>::v]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll 4
  for (int kk = 0; kk < kStep; ++kk) {
    float a[4][2], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = wm * 64 + mi * 16 + g;
      a[mi][0] = sa[row][kk];
      a[mi][1] = sa[row + 8][kk];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + 2 * t;
      b[ni][0] = sb[col][kk];
      b[ni][1] = sb[col + 1][kk];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][0] = fmaf(a[mi][0], b[ni][0], acc[mi][ni][0]);
        acc[mi][ni][1] = fmaf(a[mi][0], b[ni][1], acc[mi][ni][1]);
        acc[mi][ni][2] = fmaf(a[mi][1], b[ni][0], acc[mi][ni][2]);
        acc[mi][ni][3] = fmaf(a[mi][1], b[ni][1], acc[mi][ni][3]);
      }
    }
  }
}

// acc = A_tile . B_tile^T over reduction indices [red0, red_end): A's
// lines are the tile's rows, B's its columns.  The next stage's operands
// are in registers while the current one is multiplied.
template <typename CT, typename TA, typename TB, bool ARC, bool BRC, bool BN,
          bool VEC>
__device__ __forceinline__ void tile_product(
    float (&acc)[4][4][4], CT (*sa)[Ld<CT>::v], CT (*sb)[Ld<CT>::v],
    const Operand<TA>& a, const Operand<TB>& b, long long red0,
    long long red_end, const BnParams& bn) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
    }
  }
  Stage<CT, TA, ARC, BN, VEC> ra;
  Stage<CT, TB, BRC, false, VEC> rb;
  ra.load(a, red0, red_end, bn);
  rb.load(b, red0, red_end, bn);
  for (long long r = red0; r < red_end; r += kStep) {
    __syncthreads();  // every warp is done with the previous stage
    ra.store(sa, a, r, red_end, bn);
    rb.store(sb, b, r, red_end, bn);
    __syncthreads();
    if (r + kStep < red_end) {
      ra.load(a, r + kStep, red_end, bn);
      rb.load(b, r + kStep, red_end, bn);
    }
    compute_step(acc, sa, sb);
  }
}

// Store the tile (rows row0.., columns col0.. of a row-major (n_rows,
// n_cols) output with leading dimension ld), rounded to T.
template <typename T>
__device__ __forceinline__ void store_out(const float (&acc)[4][4][4], T* out,
                                          long long n_rows, long long n_cols,
                                          long long ld, long long row0,
                                          long long col0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long row = row0 + wm * 64 + mi * 16 + g + (j >= 2 ? 8 : 0);
        const long long col = col0 + wn * 32 + ni * 8 + 2 * t + (j & 1);
        if (row < n_rows && col < n_cols) {
          out[row * ld + col] = from_f32<T>(acc[mi][ni][j]);
        }
      }
    }
  }
}

// Forward: y = A @ w over K, A = x or its BN prologue, with the stats
// epilogue into part (null: no stats).  Grid: (row blocks, column blocks).
template <typename TX, typename TW, typename CT, bool BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const TX* __restrict__ x, const TW* __restrict__ w, BnParams bn,
           TX* __restrict__ y, float* __restrict__ part, long long m, int k,
           int n) {
  __shared__ __align__(16) CT sa[kTile][Ld<CT>::v];
  __shared__ __align__(16) CT sb[kTile][Ld<CT>::v];
  __shared__ float red[2][2][kTile];
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.y) * kTile;
  // A: lines are rows of x, the reduction index k contiguous; B: lines
  // are columns of w, whose reduction index k strides by n
  const Operand<TX> a{x, m, k, 1, row0};
  const Operand<TW> b{w, n, 1, n, col0};
  float acc[4][4][4];
  tile_product<CT, TX, TW, true, false, BN, VEC>(acc, sa, sb, a, b, 0, k,
                                                 bn);
  store_out<TX>(acc, y, m, n, n, row0, col0);
  if (part == nullptr) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const long long col = col0 + wn * 32 + ni * 8 + 2 * t + c;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + wm * 64 + mi * 16 + g + 8 * h;
          if (row < m && col < n) {
            // the stats of the STORED value: rounded to y's dtype first
            const float v = to_f32(from_f32<TX>(acc[mi][ni][2 * h + c]));
            s += v;
            ss += v * v;
          }
        }
      }
      // the 8 lanes of one t hold the same column: fixed-order tree
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (g == 0) {
        red[0][wm][wn * 32 + ni * 8 + 2 * t + c] = s;
        red[1][wm][wn * 32 + ni * 8 + 2 * t + c] = ss;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const long long col = col0 + threadIdx.x;
    if (col < n) {
      float* pr = part + static_cast<long long>(blockIdx.x) * 2 * n;
      pr[col] = red[0][0][threadIdx.x] + red[0][1][threadIdx.x];
      pr[n + col] = red[1][0][threadIdx.x] + red[1][1][threadIdx.x];
    }
  }
}

// sum and sum of squares from the (blocks, 2, n) partials: a block of 8
// warps owns 32 columns; warp w adds row blocks w, w + 8, ... in order,
// then warp 0 adds the eight warp sums in warp order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ part, int blocks, int n,
                    float* __restrict__ s_out, float* __restrict__ ss_out) {
  __shared__ float sa[8][32], sb[8][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (col < n) {
    for (int i = warp; i < blocks; i += 8) {
      const float* pr = part + static_cast<long long>(i) * 2 * n;
      a += pr[col];
      b += pr[n + col];
    }
  }
  sa[warp][lane] = a;
  sb[warp][lane] = b;
  __syncthreads();
  if (warp == 0 && col < n) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ta += sa[i][lane];
      tb += sb[i][lane];
    }
    s_out[col] = ta;
    ss_out[col] = tb;
  }
}

// Dual backward, one launch, a 1-D grid: the last dx_blocks blocks each
// own a 128 x 128 tile of dx = dy @ w^T (rows m, columns k; reduction
// over n); the others each own one (chunk, k tile, n tile) of the fp32
// dw partials, dw_p = x[chunk]^T @ dy[chunk] (rows k, columns n;
// reduction over the chunk's rows).
template <typename T, typename CT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
dual_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const T* __restrict__ w, T* __restrict__ dx,
            float* __restrict__ part, long long m, int k, int n,
            long long chunk_rows, long long dx_blocks) {
  __shared__ __align__(16) CT sa[kTile][Ld<CT>::v];
  __shared__ __align__(16) CT sb[kTile][Ld<CT>::v];
  const BnParams none{nullptr, nullptr, nullptr, nullptr, 0};
  const long long kt = (k + kTile - 1) / kTile;
  const long long nt = (n + kTile - 1) / kTile;
  const long long bid = blockIdx.x;
  // the long dw blocks come first, so the short dx blocks fill in
  // behind them instead of leaving them as a tail
  const long long dw_blocks = static_cast<long long>(gridDim.x) - dx_blocks;
  float acc[4][4][4];
  if (bid >= dw_blocks) {
    const long long t = bid - dw_blocks;
    const long long row0 = (t / kt) * kTile;
    const long long col0 = (t % kt) * kTile;
    // A: rows of dy, reduction index n contiguous; B: rows of w (one per
    // output column k), n contiguous
    const Operand<T> a{dy, m, n, 1, row0};
    const Operand<T> b{w, k, n, 1, col0};
    tile_product<CT, T, T, true, true, false, VEC>(acc, sa, sb, a, b, 0, n,
                                                   none);
    store_out<T>(acc, dx, m, k, k, row0, col0);
    return;
  }
  const long long d = bid;
  const long long chunk = d / (kt * nt);
  const long long row0 = ((d / nt) % kt) * kTile;  // a k tile
  const long long col0 = (d % nt) * kTile;         // an n tile
  const long long r0 = chunk * chunk_rows;
  const long long r1 = r0 + chunk_rows < m ? r0 + chunk_rows : m;
  // A: columns of x (one line per k), the reduction index (rows of x)
  // strides by k; B: columns of dy, strides by n
  const Operand<T> a{x, k, 1, k, row0};
  const Operand<T> b{dy, n, 1, n, col0};
  tile_product<CT, T, T, false, false, false, VEC>(acc, sa, sb, a, b, r0, r1,
                                                   none);
  store_out<float>(acc, part + chunk * static_cast<long long>(k) * n, k, n, n,
                   row0, col0);
}

// dw from the (chunks, k * n) partials, each element in chunk order.
__global__ void __launch_bounds__(kThreads)
dw_reduce_kernel(const float* __restrict__ part, int chunks, long long kn,
                 float* __restrict__ dw) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= kn) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[c * kn + i];
  dw[i] = s;
}

// 16-byte vectors along a contiguous extent: an aligned base and an
// extent that is a whole number of vectors
bool vec_ok(const void* p, long long extent, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         extent % (16 / elem_bytes) == 0;
}

template <typename TX, typename TW, typename CT, bool BN>
void launch_fwd(const void* x, const void* w, const BnParams& bn, void* y,
                float* part, long long m, int k, int n, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kTile - 1) / kTile),
                  static_cast<unsigned>((n + kTile - 1) / kTile));
  // x's reduction index k is contiguous, w's lines (columns n) are
  if (vec_ok(x, k, sizeof(TX)) && vec_ok(w, n, sizeof(TW))) {
    fwd_kernel<TX, TW, CT, BN, true><<<grid, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), bn,
        static_cast<TX*>(y), part, m, k, n);
  } else {
    fwd_kernel<TX, TW, CT, BN, false><<<grid, kThreads, 0, s>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), bn,
        static_cast<TX*>(y), part, m, k, n);
  }
}

template <typename T>
void launch_dual(const void* x, const void* dy, const void* w, void* dx,
                 float* part, long long m, int k, int n,
                 long long chunk_rows, long long dx_blocks, dim3 grid,
                 cudaStream_t s) {
  // contiguous: x along k, dy and w along n
  if (vec_ok(x, k, sizeof(T)) && vec_ok(dy, n, sizeof(T)) &&
      vec_ok(w, n, sizeof(T))) {
    dual_kernel<T, T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const T*>(w), static_cast<T*>(dx), part, m, k, n,
        chunk_rows, dx_blocks);
  } else {
    dual_kernel<T, T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const T*>(w), static_cast<T*>(dx), part, m, k, n,
        chunk_rows, dx_blocks);
  }
}

template <typename TX, typename TW>
void launch_fwd_bn(const void* x, const void* w, const BnParams& bn, void* y,
                   float* part, long long m, int k, int n, cudaStream_t s) {
  // the product is bf16 x bf16 only when both operands are bf16: with the
  // prologue the left operand is rounded to w's dtype
  constexpr bool kWBf16 = sizeof(TW) == 2;
  constexpr bool kXBf16 = sizeof(TX) == 2;
  if (bn.mean != nullptr) {
    if (kWBf16) {
      launch_fwd<TX, TW, bf16, true>(x, w, bn, y, part, m, k, n, s);
    } else {
      launch_fwd<TX, TW, float, true>(x, w, bn, y, part, m, k, n, s);
    }
  } else if (kWBf16 && kXBf16) {
    launch_fwd<TX, TW, bf16, false>(x, w, bn, y, part, m, k, n, s);
  } else {
    launch_fwd<TX, TW, float, false>(x, w, bn, y, part, m, k, n, s);
  }
}


// ---- the Hopper designs of the bf16 forwards and dual backward ---------
//
// Each block is a producer warpgroup (one thread issues every TMA load of
// a ring of shared-memory stages) and two consumer warpgroups that run
// wgmma on the stages as they arrive (hopper_gemm.cuh); the producer
// hands its registers to the consumers (setmaxnreg 40 / 232).  Stage s
// is "full" once its TMA bytes land and "empty" once the eight consumer
// warps have retired the products that read it.  Blocks are persistent:
// one an SM, each walking many output tiles, so one tile's epilogue
// overlaps the loads of the next.

constexpr int kTcThreads = 384;   // producer + two consumer warpgroups
constexpr int kBox = 8192;        // one 64 x 64 bf16 TMA box
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// (a, b) rounded to bf16 as they are stored: two neighbouring columns.
__device__ __forceinline__ __nv_bfloat162 round2(float a, float b) {
  return __floats2bfloat162_rn(a, b);
}

// matmul_stats: y = x @ w (bf16, fp32 accumulation), with each block's
// fp32 column sums and sums of squares of the rounded y.  A block owns
// column tile n0 = (block % nt) * BN for the whole launch and the row
// tiles g, g + groups, ... (g = block / nt), 128 rows each; w's (K, BN)
// panel is loaded once and stays in shared memory (kRes), or its 64-deep
// slices ride in the ring beside x's.  Products: A = x tile, K-major; B =
// w, MN-major.  The column tile BN is 64 or 128 wide, as the design code
// says (the wrapper picks it).  Each tile's column sums of its two rows
// a thread are reduced over the warp's eight lanes of one column by a
// reduce-scatter butterfly (fixed order), so a lane carries the running
// sums of only BN / 32 columns from tile to tile: a thread's own running
// sums of its BN / 4 columns, with the 128-wide tile's 64 accumulators,
// spilled.
//
// kBn: bn_relu_matmul on the same mainloop.  Once a stage's x tile has
// landed, each consumer warpgroup rewrites its own 64 x 64 box of it in
// place, a 16-byte chunk (8 consecutive k) at a time: each element
// becomes (x - mean) * scale + beta with scale = rstd * gamma, each
// operation rounded once (the mma.sync kernel's arithmetic, so the
// operand's bf16 bits are the same), max(., 0) under relu, rounded to
// bf16.  A thread keeps one chunk column (8 k) of the box, so it forms
// its 8 scales once a stage, from parameters it loaded a stage earlier
// (global loads that the L1 or L2 serves, issued after the previous
// stage's fence; nothing is added to shared memory, which the resident w
// panel fills).  Rows at or past m and k at or past K are set to 0:
// TMA's zero padding would otherwise become beta - mean * scale and put
// rows that do not exist into the stats (w's rows past K are TMA's zeros
// too, so the k mask only keeps the parameter reads in bounds).  Then fence.proxy.async, so that the
// generic stores are visible to wgmma's async proxy, and the
// warpgroup's barrier; the previous stage's products are still in
// flight meanwhile.  The pass costs most where matmul_stats is fastest
// for each byte (stages 3-4): it adds a read and a write of the tile to
// the shared-memory traffic that the wgmma reads already nearly fill,
// and its arithmetic runs on the warps whose accumulators the tensor
// cores are writing (PERF.md, PR 9: the variants timed).  Planted faults
// for the checks: 1 skips the products of each tile's last ring stage, 2
// the block's last row tile, 3 (kBn) leaves the padded rows and k
// unmasked (the parameters of k past K read at K - 8..K - 1).

// One step of the stats reduce-scatter: of the 2H values a lane holds, it
// keeps the half named by its lane bit O and adds its partner's copy of
// that half (lane ^ O), in that order.
template <int NC, int H, int O>
__device__ __forceinline__ void reduce_scatter_half(float (&ps)[NC],
                                                    float (&pss)[NC],
                                                    int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float ks = up ? ps[j + H] : ps[j];
    const float gs = up ? ps[j] : ps[j + H];
    const float kss = up ? pss[j + H] : pss[j];
    const float gss = up ? pss[j] : pss[j + H];
    ps[j] = ks + __shfl_xor_sync(0xffffffffu, gs, O);
    pss[j] = kss + __shfl_xor_sync(0xffffffffu, gss, O);
  }
}

template <int BN, bool kRes>
struct StatsTc {
  static constexpr int kStages = kRes ? 4 : 6;
  static constexpr int kX = 128 * 64 * 2;
  static constexpr int kW = 64 * BN * 2;
  static constexpr int kStage = kX + (kRes ? 0 : kW);
  // the y tile on its way out (TMA store boxes), then the column sums
  static constexpr int kOut = 128 * BN * 2;
  static size_t smem(int kt) {
    return 1024 + static_cast<size_t>(kStages) * kStage +
           (kRes ? static_cast<size_t>(kt) * kW : 0) + kOut + 256;
  }
};

// The BN parameters of 8 consecutive k from kc (a multiple of 8, so
// 32-byte aligned in the wrapper's 16-byte aligned fp32 vectors), as
// loaded (a stage ahead of their use), and as the prologue takes them:
// scale = rstd * gamma formed once for each k.
struct BnRaw {
  float4 mu[2], rs[2], ga[2], be[2];
};
struct BnChunk {
  float mu[8], sc[8], be[8];
};

__device__ __forceinline__ void load_bn_raw(const BnParams& bn, int kc,
                                            BnRaw& r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.mu[h] = __ldg(reinterpret_cast<const float4*>(bn.mean + kc) + h);
    r.rs[h] = __ldg(reinterpret_cast<const float4*>(bn.rstd + kc) + h);
    r.ga[h] = __ldg(reinterpret_cast<const float4*>(bn.gamma + kc) + h);
    r.be[h] = __ldg(reinterpret_cast<const float4*>(bn.beta + kc) + h);
  }
}

__device__ __forceinline__ void scale_bn(const BnRaw& r, BnChunk& p) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m4[4] = {r.mu[h].x, r.mu[h].y, r.mu[h].z, r.mu[h].w};
    const float r4[4] = {r.rs[h].x, r.rs[h].y, r.rs[h].z, r.rs[h].w};
    const float g4[4] = {r.ga[h].x, r.ga[h].y, r.ga[h].z, r.ga[h].w};
    const float b4[4] = {r.be[h].x, r.be[h].y, r.be[h].z, r.be[h].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.mu[4 * h + e] = m4[e];
      p.sc[4 * h + e] = __fmul_rn(r4[e], g4[e]);
      p.be[4 * h + e] = b4[e];
    }
  }
}

// Two neighbouring bf16 operands (k = 2 e and 2 e + 1 of the chunk, the
// low half first) through the prologue, each operation rounded once.
__device__ __forceinline__ uint32_t bn_pair(uint32_t v, const BnChunk& p,
                                            int e, int relu) {
  float a = __uint_as_float(v << 16);
  float b = __uint_as_float(v & 0xffff0000u);
  a = __fadd_rn(__fmul_rn(__fsub_rn(a, p.mu[e]), p.sc[e]), p.be[e]);
  b = __fadd_rn(__fmul_rn(__fsub_rn(b, p.mu[e + 1]), p.sc[e + 1]),
                p.be[e + 1]);
  if (relu) {
    a = fmaxf(a, 0.f);
    b = fmaxf(b, 0.f);
  }
  const __nv_bfloat162 o = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&o);
}

// 16 bytes of shared memory at a shared-window address.  Through a
// generic pointer (the ring's address is rounded as an integer) the
// compiler emits generic LD/ST, which cost the BN prologue a good part
// of its time.  Volatile, so that neither moves across the barrier waits
// around them (nor across each other: a caller issues its loads first).
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// A 16-byte chunk (8 consecutive k) of the x operand through the
// prologue; 0 where !keep (computed either way and then selected: a
// branch per chunk keeps the compiler from overlapping the chunks).
__device__ __forceinline__ uint4 bn_chunk(const uint4& v, const BnChunk& bp,
                                          int relu, bool keep) {
  const uint4 o = make_uint4(bn_pair(v.x, bp, 0, relu),
                             bn_pair(v.y, bp, 2, relu),
                             bn_pair(v.z, bp, 4, relu),
                             bn_pair(v.w, bp, 6, relu));
  return make_uint4(keep ? o.x : 0u, keep ? o.y : 0u, keep ? o.z : 0u,
                    keep ? o.w : 0u);
}

template <int BN, bool kRes, bool kBn>
__global__ void __launch_bounds__(kTcThreads, 1)
stats_tc_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ty,
                float* __restrict__ part, int m, int k, int n, int groups,
                BnParams bn, int fault) {
  using C = StatsTc<BN, kRes>;
  constexpr int S = C::kStages;
  constexpr int NC = BN / 4;   // columns of a thread in a tile
  constexpr int NR = NC / 8;   // of them, reduced and carried by a lane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = align1024(smem_raw);
  const int kt = (k + 63) / 64;
  uint8_t* const panel = ring + S * C::kStage;
  uint8_t* const out = panel + (kRes ? kt * C::kW : 0);
  float* const red = reinterpret_cast<float*>(out);
  uint64_t* const full = reinterpret_cast<uint64_t*>(out + C::kOut);
  uint64_t* const empty = full + S;
  uint64_t* const wbar = empty + S;
  const int nt = (n + BN - 1) / BN;
  const int mtiles = (m + 127) / 128;
  const int g = blockIdx.x / nt;
  const int n0 = (blockIdx.x % nt) * BN;
  int units = g < mtiles ? (mtiles - 1 - g) / groups + 1 : 0;
  if (fault == 2 && units > 0) --units;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init(wbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, through a shuffle so that the compiler knows it is
  // uniform (a branch it cannot prove uniform serialises the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      if (kRes) {
        hopper::mbar_expect_tx(wbar, kt * C::kW);
        for (int kb = 0; kb < kt; ++kb) {
          for (int j = 0; j < BN / 64; ++j)
            hopper::tma_load(panel + kb * C::kW + j * kBox, &tw, wbar,
                             n0 + 64 * j, 64 * kb);
        }
      }
      int s = 0;
      uint32_t ph = 0;
      for (int u = 0; u < units; ++u) {
        const int m0 = (g + u * groups) * 128;
        for (int kb = 0; kb < kt; ++kb) {
          hopper::mbar_wait(&empty[s], ph ^ 1);
          uint8_t* const st = ring + s * C::kStage;
          hopper::mbar_expect_tx(&full[s], C::kStage);
          hopper::tma_load(st, &tx, &full[s], 64 * kb, m0);
          if (!kRes) {
            for (int j = 0; j < BN / 64; ++j)
              hopper::tma_load(st + C::kX + j * kBox, &tw, &full[s],
                               n0 + 64 * j, 64 * kb);
          }
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x - 128;
  const int c = wg - 1;  // this warpgroup's 64 rows of each tile
  const int warp = tid / 32, q = warp % 4, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  float acc[BN / 2];
  // running sums of columns 8 (j / 2) + 2 t + j % 2, j = gq NR + r
  float cs[NR], css[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) cs[r] = css[r] = 0.f;
  const bool issuer = tid % 128 == 0;
  uint8_t* const mine = out + c * (C::kOut / 2);  // this warpgroup's rows
  // kBn: the parameters of this thread's chunk column, a stage ahead
  BnRaw nraw;
  if constexpr (kBn) load_bn_raw(bn, 8 * (tid % 8) < k ? 8 * (tid % 8) : k - 8,
                                 nraw);
  if (kRes) hopper::mbar_wait(wbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int u = 0; u < units; ++u) {
    const int m0 = (g + u * groups) * 128;
    hopper::zero_acc(acc);
    // one stage's products in flight while the next stage's are issued;
    // a stage goes back to the producer once its products retire
    int prev = 0;
    for (int kb = 0; kb < kt; ++kb) {
      if constexpr (kBn) {
        // the prologue, in place, on this warpgroup's box: chunk column
        // pj of rows pr + 16 i, its parameters loaded before the wait;
        // then every thread's stores before any of the products
        const int pj = tid % 8, pr = (tid % 128) / 8;
        const int kc = 64 * kb + 8 * pj;
        BnChunk bp;
        scale_bn(nraw, bp);
        hopper::mbar_wait(&full[s], ph);
        const uint32_t box = hopper::smem_u32(ring + s * C::kStage + c * kBox);
        const int rows_here = m - m0 - 64 * c;
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = lds128(box + hopper::swz(pr + 16 * i, 8 * pj));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = pr + 16 * i;
          sts128(box + hopper::swz(r, 8 * pj),
                 bn_chunk(v[i], bp, bn.relu,
                          fault == 3 || (kc < k && r < rows_here)));
        }
        hopper::fence_proxy_async();
        hopper::warpgroup_sync(c);
        // the next stage's parameters, in flight over this stage's
        // products (issued after the fence, which waits for the
        // thread's outstanding memory operations)
        const int kn = 64 * (kb + 1 < kt ? kb + 1 : 0) + 8 * pj;
        load_bn_raw(bn, kn < k ? kn : k - 8, nraw);
      } else {
        hopper::mbar_wait(&full[s], ph);
      }
      hopper::wgmma_fence();
      hopper::fence_acc(acc);
      if (!(fault == 1 && kb == kt - 1)) {
        const uint8_t* a = ring + s * C::kStage + c * kBox;
        const uint8_t* b =
            kRes ? panel + kb * C::kW : ring + s * C::kStage + C::kX;
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          hopper::wgmma<0, 1>(acc, hopper::make_desc(a + 32 * k16, 16, 1024),
                              hopper::make_desc(b + 2048 * k16, kBox, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(acc);
      if (kb > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);
    // the rounded tile into the out boxes (once the last tile's store
    // has read them), then one TMA store a box; sum what was stored
    // (rows past m hold TMA's zeros, or the prologue's, and add nothing)
    if (issuer) hopper::tma_store_wait<true>();
    hopper::warpgroup_sync(c);
    const int r0 = 16 * q + gq;
    float ps[NC], pss[NC];  // this tile's sums of the thread's two rows
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const __nv_bfloat162 v0 = round2(acc[4 * i], acc[4 * i + 1]);
      const __nv_bfloat162 v1 = round2(acc[4 * i + 2], acc[4 * i + 3]);
      uint8_t* const box = mine + (i / 8) * kBox;
      const int ci = (i % 8) * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(box + hopper::swz(r0, ci)) = v0;
      *reinterpret_cast<__nv_bfloat162*>(box + hopper::swz(r0 + 8, ci)) = v1;
      const float a0 = __low2float(v0), a1 = __high2float(v0);
      const float b0 = __low2float(v1), b1 = __high2float(v1);
      ps[2 * i] = a0 + b0;
      ps[2 * i + 1] = a1 + b1;
      pss[2 * i] = a0 * a0 + b0 * b0;
      pss[2 * i + 1] = a1 * a1 + b1 * b1;
    }
    // reduce-scatter over the lanes of one t (lane bits 4, 3, 2 = gq bits
    // 2, 1, 0): lane gq ends with columns j = gq NR + r summed over all
    // eight row pairs
    reduce_scatter_half<NC, NC / 2, 16>(ps, pss, lane);
    reduce_scatter_half<NC, NC / 4, 8>(ps, pss, lane);
    reduce_scatter_half<NC, NC / 8, 4>(ps, pss, lane);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      cs[r] += ps[r];
      css[r] += pss[r];
    }
    hopper::fence_proxy_async();
    hopper::warpgroup_sync(c);
    if (issuer) {
      for (int b = 0; b < BN / 64; ++b)
        hopper::tma_store(&ty, mine + b * kBox, n0 + 64 * b, m0 + 64 * c);
      hopper::tma_store_commit();
    }
  }
  // the block's partial: the 8 consumer warps' sums in order (through
  // the out boxes, once the last stores are done with them)
  if (issuer) hopper::tma_store_wait<false>();
  hopper::consumer_sync<256>();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int j = gq * NR + r;
    const int col = 8 * (j / 2) + 2 * t + j % 2;
    red[(warp * 2) * BN + col] = cs[r];
    red[(warp * 2 + 1) * BN + col] = css[r];
  }
  hopper::consumer_sync<256>();
  if (tid < BN && part != nullptr) {
    float a = 0.f, b = 0.f;
    for (int w8 = 0; w8 < 8; ++w8) {
      a += red[(w8 * 2) * BN + tid];
      b += red[(w8 * 2 + 1) * BN + tid];
    }
    const int col = n0 + tid;
    if (col < n) {
      part[(2LL * g) * n + col] = a;
      part[(2LL * g + 1) * n + col] = b;
    }
  }
}

// The dual backward in one pass over a slice of K columns (K here is the
// slice; K and N multiples of 64, K * N <= 16384; the whole K of the
// matrices is `slices` slices): the slice of w (K x N) stays in shared
// memory and the block keeps its slice's fp32 dw in registers, so x, w
// and dx are each moved once and dy is read from device memory once (its
// other slices' reads come from the L2, the slices of one row tile being
// in flight together).  Block b takes slice b % slices and the 64-row
// tiles c, c + grid / slices, ... (c = b / slices) of x and dy (one ring
// stage each).  Warpgroup 0 writes each dx tile = dy_tile @ w^T (A = dy,
// B = w, both K-major; up to 128 columns a product) through TMA stores;
// warpgroup 1 adds x_tile^T @ dy_tile into dw (both operands MN-major),
// as K / 64 blocks of 64 rows x N where N >= K, else as dw^T in N / 64
// blocks of 64 x K: the fewest, widest products.  Split so, dw's products
// go on while dx's tile is stored.  At the end warpgroup 1 writes its dw
// slice into partial c.  Faults: 1 skips the products of the block's
// first stage, 2 its last row tile.
template <int K, int N>
struct Fused {
  static constexpr int kStage = 64 * (K + N) * 2;
  static constexpr int kPanel = K * N * 2;
  static constexpr int kOut = 64 * K * 2;  // the dx tile on its way out
  static constexpr int kFit =
      (static_cast<int>(kSmemMax) - 1280 - kPanel - kOut) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr bool kT = N < K;                // dw kept transposed
  static constexpr int kBlocks = kT ? N / 64 : K / 64;
  static constexpr int kW = kT ? K : N;            // the blocks' width
  static size_t smem() {
    return 1024 + static_cast<size_t>(kStages) * kStage + kPanel + kOut +
           256;
  }
};

template <int K, int N>
__global__ void __launch_bounds__(kTcThreads, 1)
dual_fused_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tdx,
                  float* __restrict__ part, int m, int slices, int fault) {
  using C = Fused<K, N>;
  constexpr int S = C::kStages;
  static_assert(S >= 2, "two stages at least");
  static_assert(!C::kT || K * (N + 1) * 4 <= S * C::kStage,
                "the ring holds dw^T's transpose");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = align1024(smem_raw);
  uint8_t* const panel = ring + S * C::kStage;
  uint8_t* const out = panel + C::kPanel;
  uint64_t* const full = reinterpret_cast<uint64_t*>(out + C::kOut);
  uint64_t* const empty = full + S;
  uint64_t* const wbar = empty + S;
  const int mt = (m + 63) / 64;
  const int grid = static_cast<int>(gridDim.x) / slices;  // blocks a slice
  const int bid = static_cast<int>(blockIdx.x) / slices;
  const int k0 = (static_cast<int>(blockIdx.x) % slices) * K;
  int units = bid < mt ? (mt - 1 - bid) / grid + 1 : 0;
  if (fault == 2 && units > 0) --units;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init(wbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, through a shuffle so that the compiler knows it is
  // uniform (a branch it cannot prove uniform serialises the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // w as N / 64 column panels of K rows x 128 bytes
      hopper::mbar_expect_tx(wbar, C::kPanel);
      for (int j = 0; j < N / 64; ++j)
        hopper::tma_load(panel + j * K * 128, &tw, wbar, 64 * j, k0);
      int s = 0;
      uint32_t ph = 0;
      for (int u = 0; u < units; ++u) {
        const int r0 = (bid + u * grid) * 64;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        uint8_t* const st = ring + s * C::kStage;
        hopper::mbar_expect_tx(&full[s], C::kStage);
        for (int j = 0; j < K / 64; ++j)
          hopper::tma_load(st + j * kBox, &tx, &full[s], k0 + 64 * j, r0);
        for (int j = 0; j < N / 64; ++j)
          hopper::tma_load(st + K * 128 + j * kBox, &tdy, &full[s], 64 * j,
                           r0);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32, q = warp % 4, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  int s = 0;
  uint32_t ph = 0;
  if (wg == 1) {
    // consumer warpgroup 0: dx, in column chunks of at most 128 (64
    // accumulators a thread: a 256-wide chunk spilled)
    constexpr int DXC = K < 128 ? K : 128;
    float acc[DXC / 2];
    hopper::mbar_wait(wbar, 0);
    for (int u = 0; u < units; ++u) {
      const int r0 = (bid + u * grid) * 64;
      hopper::mbar_wait(&full[s], ph);
      const bool skip = fault == 1 && u == 0;
      const uint8_t* const ds = ring + s * C::kStage + K * 128;
      // the out boxes are free once the last tile's stores have read them
      if (tid == 0) hopper::tma_store_wait<true>();
      hopper::warpgroup_sync(0);
#pragma unroll
      for (int h = 0; h < K / DXC; ++h) {
        if (!skip) {
          hopper::zero_acc(acc);
          hopper::wgmma_fence();
          hopper::fence_acc(acc);
#pragma unroll
          for (int k16 = 0; k16 < N / 16; ++k16) {
            const int off = (k16 / 4) * kBox + 32 * (k16 % 4);
            hopper::wgmma<0, 0>(
                acc, hopper::make_desc(ds + off, 16, 1024),
                hopper::make_desc(panel + (k16 / 4) * K * 128 +
                                      h * DXC * 128 + 32 * (k16 % 4),
                                  16, 1024));
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_acc(acc);
        }
        if (h == K / DXC - 1) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[s]);
        }
        if (skip) continue;
        // the chunk into its out boxes, then one TMA store a box (rows
        // past m are not written)
        const int row = 16 * q + gq;
#pragma unroll
        for (int i = 0; i < DXC / 8; ++i) {
          uint8_t* const box = out + (h * DXC / 64 + i / 8) * kBox;
          const int ci = (i % 8) * 8 + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(box + hopper::swz(row, ci)) =
              round2(acc[4 * i], acc[4 * i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(box +
                                             hopper::swz(row + 8, ci)) =
              round2(acc[4 * i + 2], acc[4 * i + 3]);
        }
        hopper::fence_proxy_async();
        hopper::warpgroup_sync(0);
        if (tid == 0) {
          for (int b = h * DXC / 64; b < (h + 1) * DXC / 64; ++b)
            hopper::tma_store(&tdx, out + b * kBox, k0 + 64 * b, r0);
          hopper::tma_store_commit();
        }
      }
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    if (tid == 0) hopper::tma_store_wait<false>();
    // done with the ring: warpgroup 1 may reuse it (below)
    if (C::kT) hopper::consumer_sync<256>();
    return;
  }
  // consumer warpgroup 1: dw, one stage's products in flight while the
  // next stage's are issued
  float acc[C::kBlocks][C::kW / 2];
#pragma unroll
  for (int b = 0; b < C::kBlocks; ++b) hopper::zero_acc(acc[b]);
  int prev = -1;
  for (int u = 0; u < units; ++u) {
    hopper::mbar_wait(&full[s], ph);
    hopper::wgmma_fence();
#pragma unroll
    for (int b = 0; b < C::kBlocks; ++b) hopper::fence_acc(acc[b]);
    if (!(fault == 1 && u == 0)) {
      const uint8_t* const xs = ring + s * C::kStage;
      const uint8_t* const ds = xs + K * 128;
#pragma unroll
      for (int b = 0; b < C::kBlocks; ++b) {
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16) {
          const uint8_t* a = (C::kT ? ds : xs) + b * kBox + 2048 * k16;
          const uint8_t* bb = (C::kT ? xs : ds) + 2048 * k16;
          hopper::wgmma<1, 1>(acc[b], hopper::make_desc(a, kBox, 1024),
                              hopper::make_desc(bb, kBox, 1024));
        }
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
#pragma unroll
    for (int b = 0; b < C::kBlocks; ++b) hopper::fence_acc(acc[b]);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
    }
    prev = s;
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < C::kBlocks; ++b) hopper::fence_acc(acc[b]);
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);
  }
  float* const pb =
      part + (static_cast<long long>(bid) * slices * K + k0) * N;
  if (C::kT) {
    // dw^T to dw through the idle ring (every stage consumed, warpgroup 0
    // past its last product): scattered transposed stores from registers
    // spilled; rows of N + 1 floats keep the writes off one bank
    float* const sm = reinterpret_cast<float*>(ring);
    hopper::consumer_sync<256>();
    hopper::fence_proxy_async();
#pragma unroll
    for (int b = 0; b < C::kBlocks; ++b) {
      const int row = 64 * b + 16 * q + gq;  // of dw^T: n
#pragma unroll
      for (int i = 0; i < C::kW / 8; ++i) {
        const int col = 8 * i + 2 * t;  // k
        sm[col * (N + 1) + row] = acc[b][4 * i];
        sm[(col + 1) * (N + 1) + row] = acc[b][4 * i + 1];
        sm[col * (N + 1) + row + 8] = acc[b][4 * i + 2];
        sm[(col + 1) * (N + 1) + row + 8] = acc[b][4 * i + 3];
      }
    }
    hopper::warpgroup_sync(1);
    for (int e = tid - 128; e < K * N; e += 128)
      pb[e] = sm[(e / N) * (N + 1) + e % N];
    return;
  }
#pragma unroll
  for (int b = 0; b < C::kBlocks; ++b) {
    const int row = 64 * b + 16 * q + gq;
#pragma unroll
    for (int i = 0; i < C::kW / 8; ++i) {
      const int col = 8 * i + 2 * t;
      *reinterpret_cast<float2*>(pb + row * N + col) =
          make_float2(acc[b][4 * i], acc[b][4 * i + 1]);
      *reinterpret_cast<float2*>(pb + (row + 8) * N + col) =
          make_float2(acc[b][4 * i + 2], acc[b][4 * i + 3]);
    }
  }
}

// The dual backward elsewhere: two kinds of 128 x 128 tile on one ring,
// handed out by an integer ticket (sched[0]) to persistent blocks, the
// long dw tiles first so the short dx tiles fill in behind them and every
// block ends at about the same time.  dw tile (chunk, 128 rows of k, 128
// columns of n): partial `chunk` of dw = x[rows]^T dy[rows] over the
// chunk's rows (A = x^T, B = dy, MN-major); dx tile (128 rows of m, 128
// columns of k) = dy w^T over N (A = dy, B = w, K-major).  (128 x 256
// tiles were slower at every RN50 shape: PERF.md §6.)  The stages
// carry the tile they belong to; the producer ends with a stage holding
// -1.  The last block to finish takes sched[1]'s last
// ticket and sets both counters back to 0 for the next launch on the
// stream.  Faults: 1 skips the products of each tile's last stage, 2 the
// block's last tile.
struct DualTc {
  static constexpr int W = 128;  // tile width
  static constexpr int kStages = 6;
  static constexpr int kA = 128 * 64 * 2;
  static constexpr int kStage = kA + W * 64 * 2;
  static constexpr int kOut = 128 * W * 2;  // a dx tile on its way out
  static size_t smem() {
    return 1024 + static_cast<size_t>(kStages) * kStage + kOut + 256;
  }
};

__global__ void __launch_bounds__(kTcThreads, 1)
dual_tc_kernel(const __grid_constant__ CUtensorMap tdya,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tdyb,
               const __grid_constant__ CUtensorMap tdx,
               float* __restrict__ part, int m, int k, int n, int chunk_rows,
               int chunks, int* __restrict__ sched, int fault) {
  using C = DualTc;
  constexpr int W = C::W;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = align1024(smem_raw);
  uint8_t* const out = ring + S * C::kStage;
  uint64_t* const full = reinterpret_cast<uint64_t*>(out + C::kOut);
  uint64_t* const empty = full + S;
  int* const meta = reinterpret_cast<int*>(empty + S);
  // dw tiles: kr row tiles of k x nc column tiles of n; dx: kc of k
  const int kr = (k + 127) / 128, nc = (n + W - 1) / W, kc = (k + W - 1) / W;
  const int n_dw = chunks * kr * nc;
  const int total = n_dw + ((m + 127) / 128) * kc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, through a shuffle so that the compiler knows it is
  // uniform (a branch it cannot prove uniform serialises the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0;
      int cur = atomicAdd(&sched[0], 1);
      while (cur < total) {
        const int nxt = atomicAdd(&sched[0], 1);
        if (!(fault == 2 && nxt >= total)) {
          const bool is_dw = cur < n_dw;
          int steps, c0, c1, r0 = 0;
          if (is_dw) {
            const int rem = cur % (kr * nc);
            c0 = (rem / nc) * 128;  // k
            c1 = (rem % nc) * W;    // n
            r0 = (cur / (kr * nc)) * chunk_rows;
            const int rows = min(chunk_rows, m - r0);
            steps = (rows + 63) / 64;
          } else {
            const int v = cur - n_dw;
            c0 = (v / kc) * 128;  // m
            c1 = (v % kc) * W;    // k
            steps = (n + 63) / 64;
          }
          for (int ks = 0; ks < steps; ++ks) {
            hopper::mbar_wait(&empty[s], ph ^ 1);
            uint8_t* const st = ring + s * C::kStage;
            meta[s] = cur;
            hopper::mbar_expect_tx(&full[s], C::kStage);
            if (is_dw) {
              const int r = r0 + 64 * ks;
              hopper::tma_load(st, &tx, &full[s], c0, r);
              hopper::tma_load(st + kBox, &tx, &full[s], c0 + 64, r);
              for (int j = 0; j < W / 64; ++j)
                hopper::tma_load(st + C::kA + j * kBox, &tdyb, &full[s],
                                 c1 + 64 * j, r);
            } else {
              hopper::tma_load(st, &tdya, &full[s], 64 * ks, c0);
              hopper::tma_load(st + C::kA, &tw, &full[s], 64 * ks, c1);
            }
            if (++s == S) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        cur = nxt;
      }
      hopper::mbar_wait(&empty[s], ph ^ 1);
      meta[s] = -1;
      hopper::mbar_arrive(&full[s]);
      __threadfence();
      if (atomicAdd(&sched[1], 1) == static_cast<int>(gridDim.x) - 1) {
        atomicExch(&sched[0], 0);
        atomicExch(&sched[1], 0);
      }
    }
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x - 128;
  const int c = wg - 1;
  const int warp = tid / 32, q = warp % 4, lane = tid % 32;
  const int gq = lane / 4, t = lane % 4;
  float acc[W / 2];
  const bool issuer = tid % 128 == 0;
  uint8_t* const mine = out + c * (C::kOut / 2);
  int s = 0;
  uint32_t ph = 0;
  for (;;) {
    hopper::mbar_wait(&full[s], ph);
    // the tile, uniform across the warp as far as the compiler can see
    const int u = __shfl_sync(
        0xffffffffu, *reinterpret_cast<volatile int*>(&meta[s]), 0);
    if (u < 0) break;
    const bool is_dw = u < n_dw;
    int steps, c0, c1, chunk = 0;
    if (is_dw) {
      const int rem = u % (kr * nc);
      chunk = u / (kr * nc);
      c0 = (rem / nc) * 128;
      c1 = (rem % nc) * W;
      const int rows = min(chunk_rows, m - chunk * chunk_rows);
      steps = (rows + 63) / 64;
    } else {
      const int v = u - n_dw;
      c0 = (v / kc) * 128;
      c1 = (v % kc) * W;
      steps = (n + 63) / 64;
    }
    hopper::zero_acc(acc);
    // one stage's products in flight while the next stage's are issued
    int prev = 0;
    for (int ks = 0; ks < steps; ++ks) {
      if (ks > 0) hopper::mbar_wait(&full[s], ph);
      hopper::wgmma_fence();
      hopper::fence_acc(acc);
      if (!(fault == 1 && ks == steps - 1)) {
        const uint8_t* const a = ring + s * C::kStage + c * kBox;
        const uint8_t* const b = ring + s * C::kStage + C::kA;
        if (is_dw) {
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            hopper::wgmma<1, 1>(
                acc, hopper::make_desc(a + 2048 * k16, kBox, 1024),
                hopper::make_desc(b + 2048 * k16, kBox, 1024));
        } else {
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            hopper::wgmma<0, 0>(acc,
                                hopper::make_desc(a + 32 * k16, 16, 1024),
                                hopper::make_desc(b + 32 * k16, 16, 1024));
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_acc(acc);
      if (ks > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);
    if (is_dw) {
      const long long row = c0 + 64 * c + 16 * q + gq;
      float* const pc = part + static_cast<long long>(chunk) * k * n;
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        const int col = c1 + 8 * i + 2 * t;
        if (col < n) {
          if (row < k)
            *reinterpret_cast<float2*>(pc + row * n + col) =
                make_float2(acc[4 * i], acc[4 * i + 1]);
          if (row + 8 < k)
            *reinterpret_cast<float2*>(pc + (row + 8) * n + col) =
                make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        }
      }
    } else {
      // this warpgroup's 64 rows of the dx tile into its out boxes, then
      // one TMA store a box (past m and k nothing is written)
      if (issuer) hopper::tma_store_wait<true>();
      hopper::warpgroup_sync(c);
      const int row = 16 * q + gq;
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        uint8_t* const box = mine + (i / 8) * kBox;
        const int ci = (i % 8) * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(box + hopper::swz(row, ci)) =
            round2(acc[4 * i], acc[4 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(box + hopper::swz(row + 8, ci)) =
            round2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      hopper::fence_proxy_async();
      hopper::warpgroup_sync(c);
      if (issuer) {
        for (int j = 0; j < W / 64; ++j)
          hopper::tma_store(&tdx, mine + j * kBox, c1 + 64 * j, c0 + 64 * c);
        hopper::tma_store_commit();
      }
    }
  }
  if (issuer) hopper::tma_store_wait<false>();
}

// One 128 x 64 x 64 product D = A B through one TMA load and four k16
// wgmma steps, for the descriptor check: A is a (128, 64) matrix read
// K-major (TA = 0) or the transpose of a (64, 128) one read MN-major; B is
// the transpose of a (64, 64) matrix read K-major (TB = 0) or a (64, 64)
// one read MN-major.  D: (128, 64) fp32, row-major.
template <int TA, int TB>
__global__ void __launch_bounds__(256, 1)
tile_check_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const a = align1024(smem_raw);
  uint8_t* const b = a + 2 * kBox;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(b + kBox);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, 3 * kBox);
    hopper::tma_load(a, &ta, bar, 0, 0);
    if (TA) hopper::tma_load(a + kBox, &ta, bar, 64, 0);
    hopper::tma_load(b, &tb, bar, 0, 0);
  }
  hopper::mbar_wait(bar, 0);
  const int c = threadIdx.x / 128;
  const int q = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gq = lane / 4, t = lane % 4;
  float acc[32];
  hopper::zero_acc(acc);
  hopper::wgmma_fence();
  hopper::fence_acc(acc);
#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    const uint64_t da =
        TA ? hopper::make_desc(a + c * kBox + 2048 * k16, kBox, 1024)
           : hopper::make_desc(a + c * kBox + 32 * k16, 16, 1024);
    const uint64_t db = TB ? hopper::make_desc(b + 2048 * k16, kBox, 1024)
                           : hopper::make_desc(b + 32 * k16, 16, 1024);
    hopper::wgmma<TA, TB>(acc, da, db);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_acc(acc);
  const int row = 64 * c + 16 * q + gq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    d[row * 64 + col] = acc[4 * i];
    d[row * 64 + col + 1] = acc[4 * i + 1];
    d[(row + 8) * 64 + col] = acc[4 * i + 2];
    d[(row + 8) * 64 + col + 1] = acc[4 * i + 3];
  }
}

// ---- host side of the Hopper designs

int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return v;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Design codes, chosen by the wrapper (ops/conv_bn.py::_conv_bn_design,
// which holds the rule; this file only runs the instantiation a code
// names and refuses a call it cannot run).
constexpr int kPresent = 0;  // the mma.sync / FMA kernels above
// stats: w streamed or resident, 128-wide column tiles (1, 2) or 64 (3, 4)
constexpr int kStatsStreamed = 1, kStatsResident = 2;
constexpr int kStatsStreamed64 = 3, kStatsResident64 = 4;
constexpr int kDualTiles = 1, kDualFused = 2;

int stats_tile(int design) { return design >= kStatsStreamed64 ? 64 : 128; }

// Row-tile groups of the stats kernel: blocks per column tile, about
// one block an SM in all.
int stats_groups(long long m, int n, int bn) {
  const long long nt = cdiv(n, bn);
  long long g = sm_count() / nt;
  if (g < 1) g = 1;
  const long long mt = cdiv(m, 128);
  return static_cast<int>(g < mt ? g : mt);
}

// dw chunks of the tiled dual: a dw tile no longer than a block's share
// of the whole launch (dx and dw have the same number of products), so
// at least SMs / (2 * dw tiles) chunks, each a multiple of 64 rows.
long long dual_chunk_rows(long long m, int k, int n) {
  const long long tiles = cdiv(k, 128) * cdiv(n, 128);
  long long c = cdiv(sm_count(), 2 * tiles);
  if (c < 1) c = 1;
  if (c > cdiv(m, 64)) c = cdiv(m, 64);
  return cdiv(cdiv(m, c), 64) * 64;
}

// Blocks of a slice of the one-pass dual (and its dw partials): about
// one block an SM in all.
long long fused_blocks(long long m, long long slices) {
  const long long mt = cdiv(m, 64);
  long long p = sm_count() / slices;
  if (p < 1) p = 1;
  return mt < p ? mt : p;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int BN, bool kRes, bool kBn>
int launch_stats_tc(const void* x, const void* w, const BnParams& bn,
                    void* y, float* part, long long m, int k, int n,
                    int fault, cudaStream_t st) {
  CUtensorMap tx, tw, ty;
  if (!hopper::make_tmap(&tx, x, m, k, k, 64, 128) ||
      !hopper::make_tmap(&tw, w, k, n, n, 64, 64) ||
      !hopper::make_tmap(&ty, y, m, n, n, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kt = static_cast<int>(cdiv(k, 64));
  const size_t smem = StatsTc<BN, kRes>::smem(kt);
  cudaError_t e = allow_smem(stats_tc_kernel<BN, kRes, kBn>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = stats_groups(m, n, BN);
  const int nt = static_cast<int>(cdiv(n, BN));
  stats_tc_kernel<BN, kRes, kBn><<<groups * nt, kTcThreads, smem, st>>>(
      tx, tw, ty, part, static_cast<int>(m), k, n, groups, bn, fault);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBn>
int launch_stats_variant(int design, const void* x, const void* w,
                         const BnParams& bn, void* y, float* part,
                         long long m, int k, int n, int fault,
                         cudaStream_t st) {
  switch (design) {
    case kStatsStreamed:
      return launch_stats_tc<128, false, kBn>(x, w, bn, y, part, m, k, n,
                                              fault, st);
    case kStatsResident:
      return launch_stats_tc<128, true, kBn>(x, w, bn, y, part, m, k, n,
                                             fault, st);
    case kStatsStreamed64:
      return launch_stats_tc<64, false, kBn>(x, w, bn, y, part, m, k, n,
                                             fault, st);
    case kStatsResident64:
      return launch_stats_tc<64, true, kBn>(x, w, bn, y, part, m, k, n,
                                            fault, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma stats kernel a code names, with the BN prologue where bn has
// parameters.  (A resident w too large for shared memory is refused by
// allow_smem.)
int launch_stats_design(int design, const void* x, const void* w,
                        const BnParams& bn, void* y, float* part,
                        long long m, int k, int n, int fault,
                        cudaStream_t st) {
  if (bn.mean != nullptr)
    return launch_stats_variant<true>(design, x, w, bn, y, part, m, k, n,
                                      fault, st);
  return launch_stats_variant<false>(design, x, w, bn, y, part, m, k, n,
                                     fault, st);
}

// The one-pass dual over slices of KS columns of K.
template <int KS, int N>
int launch_fused(const void* x, const void* dy, const void* w, void* dx,
                 float* part, long long m, int k, int fault,
                 cudaStream_t st) {
  CUtensorMap tx, tdy, tw, tdx;
  if (!hopper::make_tmap(&tx, x, m, k, k, 64, 64) ||
      !hopper::make_tmap(&tdy, dy, m, N, N, 64, 64) ||
      !hopper::make_tmap(&tw, w, k, N, N, 64, KS) ||
      !hopper::make_tmap(&tdx, dx, m, k, k, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Fused<KS, N>::smem();
  cudaError_t e = allow_smem(dual_fused_kernel<KS, N>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slices = k / KS;
  dual_fused_kernel<KS, N><<<static_cast<unsigned>(fused_blocks(m, slices) *
                                                   slices),
                             kTcThreads, smem, st>>>(
      tx, tdy, tw, tdx, part, static_cast<int>(m), slices, fault);
  return static_cast<int>(cudaGetLastError());
}

// The slice of K the one-pass dual is built for at n (the instantiations
// (slice, n) = (256, 64), (128, 128), (64, 256)), or 0 where none is; a
// call whose k is not a whole number of slices is refused.
int fused_ks(int k, int n) {
  const int ks = n == 64 ? 256 : n == 128 ? 128 : n == 256 ? 64 : 0;
  return ks != 0 && k % ks == 0 ? ks : 0;
}

int launch_fused_shape(const void* x, const void* dy, const void* w,
                       void* dx, float* part, long long m, int k, int n,
                       int fault, cudaStream_t st) {
  if (fused_ks(k, n) == 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 64:
      return launch_fused<256, 64>(x, dy, w, dx, part, m, k, fault, st);
    case 128:
      return launch_fused<128, 128>(x, dy, w, dx, part, m, k, fault, st);
    default:
      return launch_fused<64, 256>(x, dy, w, dx, part, m, k, fault, st);
  }
}

int launch_dual_tc(const void* x, const void* dy, const void* w, void* dx,
                   float* part, long long m, int k, int n,
                   long long chunk_rows, int* sched, int fault,
                   cudaStream_t st) {
  CUtensorMap tdya, tw, tx, tdyb, tdx;
  if (!hopper::make_tmap(&tdya, dy, m, n, n, 64, 128) ||
      !hopper::make_tmap(&tw, w, k, n, n, 64, 128) ||
      !hopper::make_tmap(&tx, x, m, k, k, 64, 64) ||
      !hopper::make_tmap(&tdyb, dy, m, n, n, 64, 64) ||
      !hopper::make_tmap(&tdx, dx, m, k, k, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = DualTc::smem();
  cudaError_t e = allow_smem(dual_tc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long chunks = cdiv(m, chunk_rows);
  const long long units =
      chunks * cdiv(k, 128) * cdiv(n, 128) + cdiv(m, 128) * cdiv(k, 128);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long p = sm_count() < units ? sm_count() : units;
  dual_tc_kernel<<<static_cast<unsigned>(p), kTcThreads, smem, st>>>(
      tdya, tw, tx, tdyb, tdx, part, static_cast<int>(m), k, n,
      static_cast<int>(chunk_rows), static_cast<int>(chunks), sched, fault);
  return static_cast<int>(cudaGetLastError());
}

// [shared memory a block, resident blocks per SM, registers a thread,
// local (spilled) bytes a thread] of one kernel, as the runtime reports
// them.
template <typename Kern>
int kernel_info(Kern kern, int threads, size_t smem, int* out) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>(attr.sharedSizeBytes) +
           attr.maxDynamicSharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, kern, threads, smem));
}

}  // namespace

// Rows of one forward block of the present design: the stats partials
// buffer of apex_conv_bn_fwd holds ceil(m / rows) x 2 x n floats there.
extern "C" int apex_conv_bn_rows_per_block() { return kTile; }

// Tile sizes of the present dual backward: chunk_rows must be a multiple
// of apex_conv_bn_step() (the reduction stage) and the k and n tiles are
// apex_conv_bn_rows_per_block() wide.
extern "C" int apex_conv_bn_step() { return kStep; }

// Stats partials of apex_conv_bn_fwd under `design`: its part buffer
// holds this many x 2 x n floats.
extern "C" long long apex_conv_bn_stats_parts(long long m, int k, int n,
                                              int design) {
  (void)k;
  if (m <= 0 || n <= 0) return 0;
  return design == kPresent ? cdiv(m, kTile)
                            : stats_groups(m, n, stats_tile(design));
}

// dw partials of apex_matmul_bwd_dual under `design` (chunk_rows is the
// present design's): its part buffer holds this many x k x n floats.
extern "C" long long apex_conv_bn_dual_parts(long long m, int k, int n,
                                             long long chunk_rows,
                                             int design) {
  if (m <= 0 || k <= 0 || n <= 0) return 0;
  if (design == kDualFused) {
    const int ks = fused_ks(k, n);
    return ks == 0 ? 0 : fused_blocks(m, k / ks);
  }
  if (design == kDualTiles) return cdiv(m, dual_chunk_rows(m, k, n));
  return chunk_rows > 0 ? cdiv(m, chunk_rows) : 0;
}

// Forward.  x: (m, k) of x_dtype, w: (k, n) of w_dtype, y: (m, n) of
// x_dtype, all contiguous; dtype 0 = float32, 1 = bfloat16.  mean, rstd,
// gamma, beta: (k,) fp32 (16-byte aligned for the wgmma designs), or all
// null for the plain matmul_stats.  part: fp32 scratch of
// apex_conv_bn_stats_parts(...) * 2 * n, s and ss: (n,) fp32; all three
// null for no stats.  design: 0 the mma.sync / FMA kernel (any input); 1
// or 2 the wgmma kernel with 128-wide column tiles and w streamed or kept
// in shared memory, 3 or 4 the same with 64-wide tiles (bf16 x and w,
// rows whole 16-byte multiples, 16-byte aligned bases; with the BN
// prologue where mean is given).  fault: a planted error of the wgmma
// kernel for the checks (0: none; 3 only with the prologue).  m, k, n >=
// 1.  Returns a CUDA error code.
extern "C" int apex_conv_bn_fwd(const void* x, const void* w,
                                const float* mean, const float* rstd,
                                const float* gamma, const float* beta,
                                int relu, void* y, float* part, float* s,
                                float* ss, long long m, int k, int n,
                                int x_dtype, int w_dtype, int design,
                                int fault, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BnParams bn{mean, rstd, gamma, beta, relu};
  long long blocks = cdiv(m, kTile);
  if (design != kPresent) {
    const bool with_bn = mean != nullptr;
    if (x_dtype != 1 || w_dtype != 1 || m > 0x7fffffffLL || fault < 0 ||
        fault > (with_bn ? 3 : 2))
      return static_cast<int>(cudaErrorInvalidValue);
    // the prologue reads the parameters as 16-byte vectors
    if (with_bn) {
      for (const float* p : {mean, rstd, gamma, beta}) {
        if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0)
          return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    const int err = launch_stats_design(design, x, w, bn, y, part, m, k, n,
                                        fault, st);
    if (err != 0) return err;
    blocks = stats_groups(m, n, stats_tile(design));
  } else if (fault != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (x_dtype == 0 && w_dtype == 0) {
    launch_fwd_bn<float, float>(x, w, bn, y, part, m, k, n, st);
  } else if (x_dtype == 0 && w_dtype == 1) {
    launch_fwd_bn<float, bf16>(x, w, bn, y, part, m, k, n, st);
  } else if (x_dtype == 1 && w_dtype == 0) {
    launch_fwd_bn<bf16, float>(x, w, bn, y, part, m, k, n, st);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch_fwd_bn<bf16, bf16>(x, w, bn, y, part, m, k, n, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (part != nullptr) {
    stats_reduce_kernel<<<dim3(static_cast<unsigned>((n + 31) / 32)),
                          kThreads, 0, st>>>(part, static_cast<int>(blocks),
                                             n, s, ss);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dual backward.  x: (m, k), dy: (m, n), w: (k, n), dx: (m, k), all of
// dtype (0 = float32, 1 = bfloat16) and contiguous; dw: (k, n) fp32;
// part: fp32 scratch of apex_conv_bn_dual_parts(...) * k * n.  design: 0
// the mma.sync / FMA kernel (chunk_rows its dw chunk, a multiple of
// apex_conv_bn_step()); 1 the wgmma tiles of dx and dw (sched: two int
// counters at 0, which the kernel leaves at 0; one pair per stream); 2
// the one-pass wgmma kernel (n 64, 128 or 256 and k a multiple of the
// slice built for it: 256, 128, 64).  Designs 1 and 2 take bf16 with rows
// whole 16-byte multiples and 16-byte aligned bases.  fault: a planted
// error of the wgmma kernels (0: none).  m, k, n >= 1.  Returns a CUDA
// error code.
extern "C" int apex_matmul_bwd_dual(const void* x, const void* dy,
                                    const void* w, void* dx, float* part,
                                    float* dw, long long m, int k, int n,
                                    long long chunk_rows, int dtype,
                                    int design, int* sched, int fault,
                                    void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long chunks;
  if (design == kDualFused || design == kDualTiles) {
    if (dtype != 1 || m > 0x7fffffffLL || fault < 0 || fault > 2)
      return static_cast<int>(cudaErrorInvalidValue);
    int err;
    if (design == kDualFused) {
      const int ks = fused_ks(k, n);
      if (ks == 0) return static_cast<int>(cudaErrorInvalidValue);
      chunks = fused_blocks(m, k / ks);
      err = launch_fused_shape(x, dy, w, dx, part, m, k, n, fault, st);
    } else {
      if (sched == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const long long rows = dual_chunk_rows(m, k, n);
      chunks = cdiv(m, rows);
      err = launch_dual_tc(x, dy, w, dx, part, m, k, n, rows, sched, fault,
                           st);
    }
    if (err != 0) return err;
  } else {
    if (design != kPresent || fault != 0 || chunk_rows <= 0 ||
        chunk_rows % kStep)
      return static_cast<int>(cudaErrorInvalidValue);
    chunks = cdiv(m, chunk_rows);
    const long long kt = cdiv(k, kTile), nt = cdiv(n, kTile);
    const long long dx_blocks = cdiv(m, kTile) * kt;
    const long long blocks = dx_blocks + chunks * kt * nt;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    if (dtype == 0) {
      launch_dual<float>(x, dy, w, dx, part, m, k, n, chunk_rows, dx_blocks,
                         grid, st);
    } else if (dtype == 1) {
      launch_dual<bf16>(x, dy, w, dx, part, m, k, n, chunk_rows, dx_blocks,
                        grid, st);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const long long kn = static_cast<long long>(k) * n;
  dw_reduce_kernel<<<dim3(static_cast<unsigned>((kn + kThreads - 1) /
                                                kThreads)),
                     kThreads, 0, st>>>(part, static_cast<int>(chunks), kn,
                                        dw);
  return static_cast<int>(cudaGetLastError());
}

// The resources of a wgmma stats kernel (the BN variant where kBn),
// its shared memory sized for w_bytes of w where it keeps w.
template <int BN, bool kRes, bool kBn>
int stats_info(int w_bytes, int* out) {
  using C = StatsTc<BN, kRes>;
  return kernel_info(stats_tc_kernel<BN, kRes, kBn>, kTcThreads,
                     C::smem(kRes ? w_bytes / C::kW : 0), out);
}

// The wgmma kernels' resources: kernel 0 and 1 matmul_stats with 64-wide
// tiles, w resident (shared memory sized for w_bytes of w) or streamed;
// 2 the tiled dual; 3-5 the one-pass dual at (slice, n) = (256, 64),
// (64, 256), (128, 128); 6 and 7 matmul_stats with 128-wide tiles, w
// resident or streamed; 8-11 bn_relu_matmul's, as 0, 1, 6 and 7.  out =
// [shared memory bytes a block, resident blocks per SM, registers a
// thread, local (spilled) bytes a thread].  Returns a CUDA error code.
extern "C" int apex_conv_bn_tc_info(int kernel, int w_bytes, int* out) {
  switch (kernel) {
    case 0:
      return stats_info<64, true, false>(w_bytes, out);
    case 1:
      return stats_info<64, false, false>(w_bytes, out);
    case 2:
      return kernel_info(dual_tc_kernel, kTcThreads, DualTc::smem(), out);
    case 3:
      return kernel_info(dual_fused_kernel<256, 64>, kTcThreads,
                         Fused<256, 64>::smem(), out);
    case 4:
      return kernel_info(dual_fused_kernel<64, 256>, kTcThreads,
                         Fused<64, 256>::smem(), out);
    case 5:
      return kernel_info(dual_fused_kernel<128, 128>, kTcThreads,
                         Fused<128, 128>::smem(), out);
    case 6:
      return stats_info<128, true, false>(w_bytes, out);
    case 7:
      return stats_info<128, false, false>(w_bytes, out);
    case 8:
      return stats_info<64, true, true>(w_bytes, out);
    case 9:
      return stats_info<64, false, true>(w_bytes, out);
    case 10:
      return stats_info<128, true, true>(w_bytes, out);
    case 11:
      return stats_info<128, false, true>(w_bytes, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The descriptor check: d (128, 64) fp32 = A B for one tile, with A read
// K-major from a (128, 64) bf16 matrix (a_mn 0) or MN-major as the
// transpose of a (64, 128) one (a_mn 1), and B MN-major from a (64, 64)
// matrix (b_mn 1) or K-major as the transpose of one (b_mn 0).  Returns
// a CUDA error code.
extern "C" int apex_conv_bn_tile_check(const void* a, const void* b,
                                       float* d, int a_mn, int b_mn,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  const bool ok = a_mn ? hopper::make_tmap(&ta, a, 64, 128, 128, 64, 64)
                       : hopper::make_tmap(&ta, a, 128, 64, 64, 64, 128);
  if (!ok || !hopper::make_tmap(&tb, b, 64, 64, 64, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 1024 + 3 * kBox + 64;
  if (a_mn && b_mn) {
    tile_check_kernel<1, 1><<<1, 256, smem, st>>>(ta, tb, d);
  } else if (a_mn) {
    tile_check_kernel<1, 0><<<1, 256, smem, st>>>(ta, tb, d);
  } else if (b_mn) {
    tile_check_kernel<0, 1><<<1, 256, smem, st>>>(ta, tb, d);
  } else {
    tile_check_kernel<0, 0><<<1, 256, smem, st>>>(ta, tb, d);
  }
  return static_cast<int>(cudaGetLastError());
}
