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
// Products: bf16 operands go to the tensor cores through mma.sync
// m16n8k16 with fp32 accumulation (what the MXU does with
// preferred_element_type=f32: exact products, fp32 sums); any fp32
// operand makes the product an fp32 one, done as fp32 FMAs on the CUDA
// cores in the same fragment layout (the reference's fp32 dot is exact
// fp32).  Sums are taken in another order than the TPU's.
//
// Bound on the H100: bytes at every RN50 shape but the stage-4 ones.  At
// (401408, 256, 64) bf16 the forward moves 257 MB (0.077 ms at 3.35 TB/s)
// for 13.2 GFLOP (0.013 ms at 989 TFLOP/s); the dual backward reads x, dy
// and w and writes dx and an fp32 dw: 462 MB, 0.138 ms.
//
// Design, simple first (wgmma, TMA and persistent blocks are later work):
// - one block of 256 threads owns a 128 x 128 output tile and walks the
//   reduction in steps of 32 through shared memory; the next step's
//   operands are loaded into registers while the tensor cores work on the
//   current one.  Each operand is staged as S[line][reduction index] (a
//   row of the output tile or a column, and the summed index contiguous),
//   so the mma fragments come from shared memory by ldmatrix, four 8 x 8
//   matrices a load, conflict-free on 80-byte lines; global reads are
//   coalesced along whichever index is contiguous in memory, as 16-byte
//   vectors where that index's extent is a whole number of them (every
//   RN50 shape), else element by element.  Ragged edges are masked as
//   they are loaded (zeros), so any M, K and N work.
// - 8 warps in 2 x 4, each 64 x 32 of the tile: 16 mma per k16 step;
//   registers capped so that two blocks share an SM.
// - the stats epilogue sums the rounded stored values of each column of
//   the tile by warp shuffles and one fixed-order shared-memory step into
//   an fp32 (row blocks, 2, N) partials buffer; a second kernel adds the
//   partials of each column in row-block order.  No float atomics: the
//   stats are the same bits on every run.
// - the dual backward runs dx's tiles and dw's in one launch: dx tiles
//   reduce over N; dw is cut into a bounded number of row chunks (about
//   two blocks per SM in all), each block writing its chunk's fp32
//   (K, N) tile partial; a second kernel adds the chunks in order.  The
//   TPU kernel keeps the whole (K, N) fp32 dw in VMEM while it streams
//   row blocks once; at RN50's widths that is up to 4 MB, more than an
//   SM holds, so here dy is read by both kinds of block (the second read
//   mostly from the 50 MB L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

}  // namespace

// Rows of one forward block: the stats partials buffer of
// apex_conv_bn_fwd holds ceil(m / rows) x 2 x n floats.
extern "C" int apex_conv_bn_rows_per_block() { return kTile; }

// Tile sizes of the dual backward: chunk_rows must be a multiple of
// apex_conv_bn_step() (the reduction stage) and the k and n tiles are
// apex_conv_bn_rows_per_block() wide.
extern "C" int apex_conv_bn_step() { return kStep; }

// Forward.  x: (m, k) of x_dtype, w: (k, n) of w_dtype, y: (m, n) of
// x_dtype, all contiguous; dtype 0 = float32, 1 = bfloat16.  mean, rstd,
// gamma, beta: (k,) fp32, or all null for the plain matmul_stats.
// part: fp32 scratch of ceil(m / 128) * 2 * n, s and ss: (n,) fp32; all
// three null for no stats.  m, k, n >= 1.  Returns cudaGetLastError().
extern "C" int apex_conv_bn_fwd(const void* x, const void* w,
                                const float* mean, const float* rstd,
                                const float* gamma, const float* beta,
                                int relu, void* y, float* part, float* s,
                                float* ss, long long m, int k, int n,
                                int x_dtype, int w_dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BnParams bn{mean, rstd, gamma, beta, relu};
  if (x_dtype == 0 && w_dtype == 0) {
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
    const int blocks = static_cast<int>((m + kTile - 1) / kTile);
    stats_reduce_kernel<<<dim3(static_cast<unsigned>((n + 31) / 32)),
                          kThreads, 0, st>>>(part, blocks, n, s, ss);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dual backward.  x: (m, k), dy: (m, n), w: (k, n), dx: (m, k), all of
// dtype (0 = float32, 1 = bfloat16) and contiguous; part: fp32 scratch of
// chunks * k * n with chunks = ceil(m / chunk_rows); dw: (k, n) fp32.
// m, k, n >= 1.  Returns cudaGetLastError().
extern "C" int apex_matmul_bwd_dual(const void* x, const void* dy,
                                    const void* w, void* dx, float* part,
                                    float* dw, long long m, int k, int n,
                                    long long chunk_rows, int dtype,
                                    void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || chunk_rows <= 0 || chunk_rows % kStep)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (m + chunk_rows - 1) / chunk_rows;
  const long long kt = (k + kTile - 1) / kTile, nt = (n + kTile - 1) / kTile;
  const long long dx_blocks = ((m + kTile - 1) / kTile) * kt;
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
  const long long kn = static_cast<long long>(k) * n;
  dw_reduce_kernel<<<dim3(static_cast<unsigned>((kn + kThreads - 1) /
                                                kThreads)),
                     kThreads, 0, st>>>(part, static_cast<int>(chunks), kn,
                                        dw);
  return static_cast<int>(cudaGetLastError());
}
