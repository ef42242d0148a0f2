// Flash attention, forward and combined backward, with an optional
// additive bias and its gradient: bf16 inputs on the tensor cores at
// head_dim 64 and 128, fp32 inputs as fp32 FMAs at head_dim 64.
//
// Replaces:
// - apex_tpu/ops/attention.py::_fwd_kernel (and _fwd_kernel_nobias,
//   launched by _flash_fwd) with apex_flash_fwd;
// - apex_tpu/ops/attention.py::_bwd_fused_kernel and _bwd_fused_nobias
//   (body _bwd_dkv_body with the per-tile dq output, launched by
//   _flash_bwd) with apex_flash_bwd;
// - apex_tpu/ops/attention.py::_bwd_fused_acc_kernel and
//   _bwd_fused_acc_nobias (the same body with dq accumulated in one fp32
//   (BH, Sq, D) buffer instead of (nk, BH, Sq, D) partials) with
//   apex_flash_bwd_acc;
// - the two-pass backward that bias_grad=True takes there
//   (_bwd_dkv_kernel, then _bwd_dq_kernel with its per-tile dbias output,
//   or _bwd_dq_bias/_bwd_dq_nobias past four key blocks): the combined
//   backward here takes any length and writes dbias itself.
//
// Semantics, as the reference's: s = (q . k) * scale with fp32
// accumulation, plus the bias in fp32 (read as fp32 or bf16 at
// bias[bh / h], through its batch and row strides: a key-padding mask
// broadcast over queries has row stride 0 and is never copied); causal
// keys (col > row, local coordinates) get -1e30; an online softmax in
// fp32 (m, l, acc) over 64-key tiles; dropout after the l sum, from the
// murmur3-fmix32 counter hash of (seed, batch*head, global row, global
// col) (_keep_mask), normaliser l * (1 - rate); p.V is a product of fp32
// p with V.  The forward writes O in the input dtype and lse = m + log(l)
// in fp32.  The backward recomputes p = exp(s - lse) and, with delta =
// rowsum(dO * O) from the wrapper: dp = dO . V^T; pd and dp masked and
// scaled by 1 / (1 - rate); dV = pd^T . dO; ds = p * (dp - delta) *
// scale; dK = ds^T . Q; dQ = ds . K, all accumulated in fp32, outputs in
// the input dtype.  With a dbias buffer, the backward also writes
// p * (dp - delta) for every (bh, row, col), without the scale factor
// (the bias enters after it), as fp32 (BH, sq, sk), unrounded; the
// caller sums it over heads.
//
// probs_bf16 (the reference's opt-in half-precision probabilities): the
// forward rounds each key tile's p = exp(s - m_running), after the
// dropout mask and before p.V, to the input dtype; the backward rounds pd
// (before pd^T . dO) and ds (before ds^T . Q and ds . K) to it, while
// dbias keeps the unrounded p * (dp - delta).  Every product is then one
// of bf16 values with an fp32 sum; for fp32 inputs the rounding is the
// identity.  The forward's rounding depends on the 64-key tile (the
// running max m changes from tile to tile), as the reference's does on
// its block_k; the backward's p = exp(s - lse) does not.
//
// Which kernel takes a call: bf16 q, k, v at head_dim 64 or 128 take the
// tensor-core kernels (flash_fwd_tc, flash_bwd_tc); fp32 q, k, v at
// head_dim 64 take the fp32 FMA kernels (flash_fwd_kernel,
// flash_bwd_kernel), the card-vs-CPU parity path.  Anything else is
// refused (cudaErrorInvalidValue); nothing falls back.
//
// Tensor-core design (bf16).  Every product is mma.sync m16n8k16 with
// bf16 operands and fp32 accumulation, operands from shared memory by
// ldmatrix (mma_sync.cuh); wgmma and TMA are later work.
// - Products of the inputs (q . k^T, dO . v^T, and pd^T . dO, ds^T . q,
//   ds . k on their q, dO, k side) take the bf16 values as they are:
//   exact products, fp32 sums, the reference's bf16 dots with fp32
//   accumulation up to summation order.
// - Products with fp32 p, pd or ds (p.V in the forward, the three
//   products of pd and ds in the backward) split it into bf16 parts,
//   x = hi + lo with hi = bf16(x) and lo = bf16(x - hi), and run two
//   products, both accumulated in fp32.  The other operand's bf16 values
//   are exact, so the only error is the dropped residual of lo, at most
//   2^-16 of |x| (the rounding of x - hi, itself at most 2^-8 of |x|; on
//   average about 2^-18): far below the bf16 rounding of the outputs (2^-8
//   relative).  With probs_bf16 the rounded value is hi itself, and the
//   lo product is not run; dropping it on the default path is the planted
//   fault chip_smoke holds these kernels to (about 2^-9 of each term).
// - Tiles: 64 queries x 64 keys a step, 4 warps of 16 rows each, so the
//   probs_bf16 rounding keeps the reference's 64-key tiles.  Staged tiles
//   are bf16 rows of D + 8 elements (16 bytes of padding: the 8 rows one
//   ldmatrix reads fall in distinct banks), loaded by cp.async 16 bytes a
//   thread, rows past Sq or Sk zero-filled (a copy of 0 source bytes),
//   so any Sq and Sk work.  Fault code 3 stages those rows as NaN
//   instead (what a stage left unfilled can hold), which the checks must
//   reject.
// Forward (flash_fwd_tc): one block per (64-query tile, batch*head) keeps
// its q fragments in registers and walks the key tiles up to the
// diagonal (fully masked tiles are skipped) through a two-stage
// cp.async ring of K and V: tile kb + 1 loads while tile kb's products
// run.  Each warp holds s for its 16 rows x 64 keys as mma accumulators;
// scale, bias, causal mask, the online softmax (row max and sum over the
// 4 lanes that share a row, by shuffles), the dropout hash and the
// rounding run on those registers, and the accumulators, packed to bf16
// pairs, are the A operand of p.V: p never goes through shared memory.
// Backward (flash_bwd_tc): one block per (64-key tile, batch*head) walks
// the query tiles from the diagonal down through a two-stage ring of q,
// dO, lse and delta, and keeps its dK and dV in fp32 registers.  Layout:
// it computes s^T = k . q^T and dp^T = v . dO^T, each warp 16 keys x 64
// queries, so pd^T and ds^T are in registers in the layout of the A
// operand of dV += pd^T . dO and dK += ds^T . q.  dQ = ds . k needs ds
// with queries as rows: each block writes ds^T as bf16 (hi and lo) into
// shared memory, over the stage's q and dO tiles once every warp is done
// with them, and each warp reads its 16 queries' A fragments back with
// ldmatrix.trans.  dq then leaves the block as before (below).
// - The elementwise step runs as passes over a thread's 32 elements:
//   what holds for the whole tile (a mask needed at all, a bias,
//   dropout, dbias) is tested once per pass, and each element's mask and
//   dropout decisions are bits of a 32-bit word, so the passes without a
//   bias read or a dbias write have no branch per element (one per
//   element cost the scheduler its overlap of the elements' latencies,
//   about a third of the backward's time).  exp is the SFU's ex2 of the
//   argument times log2(e), so p is within a few fp32 ulps of the
//   reference's exp (subnormal p flushed to 0).
// Shared memory per block and resident blocks per SM (chip_smoke reports
// both, with the registers and spills, from the CUDA runtime; "phase
// flash_tc_info"):
// - forward: q + 2 stages of k and v = 5 tiles: 46,080 B at D 64 (4
//   blocks an SM, 128 registers), 87,040 B at D 128 (2 blocks);
// - backward: k, v + 2 stages of q and dO = 6 tiles + lse and delta,
//   1 KB: 56,320 B at D 64 (3 blocks: the registers are capped at 168 a
//   thread for it; the shared memory would allow 4), 105,472 B at D 128
//   (2 blocks), 16 B more in the acc backward (its static ticket),
//   against the FMA kernel's 174 KB (one block).  More
//   resident blocks are this design's answer to the acc backward's
//   stall: while one block waits on its turn and its L2
//   read-modify-write, another runs its products.
// Bound on the H100: operations at bf16's 989 TFLOP/s.  At GPT-2 small's
// training shape (B 16, H 12, S 1024, D 64, causal) each product is
// 2 * B*H*S(S+1)/2 * D = 12.9 GFLOP: the forward's q.k^T and its split
// p.V (two products) bound it at 0.039 ms, above its 101 MB of bytes
// (0.030 ms); the backward's two products of the inputs and three split
// ones (eight in all) at 0.104 ms, above its 203 MB (0.061 ms).  With
// probs_bf16 the splits are single products.  What holds these kernels
// above the bound: mma.sync's rate (below wgmma's), the elementwise step
// (exp, the dropout hash: about 10^8 elements at GPT-2 small) on the
// CUDA cores between the products, 8-12 warps an SM to hide the
// latencies with, and, in the partials backward, the dq partials'
// 428 MB written and read back.
//
// FMA design (fp32, head_dim 64).  Both kernels work on 64 x 64 tiles
// with 256 threads, each thread owning a 4 x 4 micro-tile of every
// product, fed by float4 reads from shared memory (one operand stored
// transposed, so a thread's four rows are one float4): per step 2 float4
// reads feed 16 FMAs, which keeps the FMA pipes, not shared memory, the
// limit.  The reference's fp32 products are exact fp32, so these stay on
// the CUDA cores (67 TFLOP/s): at GPT-2 small's shape in fp32 the
// forward's bound is 0.385 ms, the backward's 0.962 ms.
// Forward: one block per (64-query tile, batch*head) walks the key tiles
// up to the diagonal, keeps m, l and the 4 x 4 accumulator of its rows in
// registers, and stages p^T in shared memory for the p.V product.  Row
// max and row sum reduce over the 16 threads of a half-warp that share
// the rows, by shuffles.  Backward: one block per (64-key tile,
// batch*head) walks the query tiles from the diagonal down and keeps its
// dK and dV tiles in registers (174 KB of shared memory, one block an
// SM).
//
// Where dq goes, in both designs.  The dQ contribution of each visited
// (query tile, key tile), an fp32 64 x D tile, goes one of two ways:
// - partials (apex_flash_bwd): to its own slot of an fp32 partials
//   buffer, which a second small kernel adds in key order.  The buffer
//   holds only the visited tiles, q*(q+1)/2 + k for causal, q*nk + k
//   otherwise: bh x 136 x 64 x D floats at S 1024 causal.
// - accumulated (apex_flash_bwd_acc): into one running fp32 64 x D block
//   per (bh, query tile), in key order.  Each (bh, query tile) has a turn
//   counter holding the place in the key order whose add is next; a block
//   waits (thread 0 spinning on an acquire load) until the turn is its
//   own, reads the running block through L2 (ld.global.cg: L1 is not
//   coherent across SMs), adds its tile, writes it back, fences, and
//   releases the turn with a release store.  The first contributor writes
//   0 + its tile without reading (the buffer may hold anything), the last
//   writes dq in q's dtype, so no second pass runs; a causally skipped
//   tile is never visited and neither waits nor advances the turn.  Both
//   ways add the same fp32 tiles from zero in key order, so dq (and dk,
//   dv) are bit for bit the same, and neither uses float atomics.  A
//   block takes its key tile and batch*head from an atomic ticket, key
//   tile major, at its start, not from blockIdx: the block whose turn it
//   waits for has a smaller ticket and so has started, whatever order the
//   hardware launches blocks in, and a waiting block never holds an SM
//   that its predecessor needs.  A wait of several seconds traps
//   (__trap) instead of hanging the card.  The running buffer is
//   bh x nq x 64 x D floats, and the traffic of the two ways is about the
//   same: the running block is read and written once per visited tile,
//   where the partials are written once and read back once.
// dbias needs no such care: the block of a key tile is the only writer
// of that tile's columns, so each element is written once, directly, and
// the causally skipped tiles (the rows above the diagonal block) are
// zero-filled by the same block.  The bias is read straight from device
// memory in the elementwise step; at BERT-large's shape it adds 12.6 MB
// to the forward's reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kD = 64;        // head_dim of the fp32 FMA kernels
constexpr int kB = 64;        // query and key tile
constexpr int kLd = kB + 4;   // padded row of a shared-memory tile
constexpr int kThreads = 256;
constexpr int kTile = kB * kLd;  // floats per shared-memory tile
constexpr float kNegInf = -1e30f;
// polls of a turn counter before the kernel traps instead of hanging
// (each poll sleeps at least 64 ns: several seconds in all)
constexpr long long kMaxPolls = 1LL << 27;

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// apex_tpu/ops/attention.py::_keep_mask for one element: keep iff the
// hash of (seed, bh, row, col) is below thresh = (1 - rate) * 2^32.
// The hash's multipliers of row, col and bh: the counter it mixes is
// (row * kHashRow + col * kHashCol + bh * kHashBh) ^ seed, mod 2^32.
constexpr uint32_t kHashRow = 0x9E3779B1u, kHashCol = 0x85EBCA77u,
                   kHashBh = 0xC2B2AE3Du;

// murmur3's fmix32 of the counter x: keep iff below thresh.
__device__ __forceinline__ bool keep_mixed(uint32_t x, uint32_t thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < thresh;
}

__device__ __forceinline__ bool keep_elem(uint32_t seed, uint32_t bh,
                                          uint32_t row, uint32_t col,
                                          uint32_t thresh) {
  return keep_mixed((row * kHashRow + col * kHashCol + bh * kHashBh) ^ seed,
                    thresh);
}

// The dropout stream's coordinates: seed_pack = [seed, row offset, col
// offset, head offset] on the device (_pack_seed); the batch*head index
// the hash is keyed on maps the local bh through (h_local, h_total).
struct DropCtx {
  uint32_t seed, bh;
  int row_off, col_off;
};

__device__ __forceinline__ DropCtx drop_ctx(const int* seed_pack, int bh,
                                            int h_local, int h_total) {
  DropCtx c;
  c.seed = static_cast<uint32_t>(seed_pack[0]);
  c.row_off = seed_pack[1];
  c.col_off = seed_pack[2];
  c.bh = static_cast<uint32_t>((bh / h_local) * h_total + seed_pack[3] +
                               bh % h_local);
  return c;
}

// The additive bias: logically (B, sq, sk) with a unit column stride,
// read at batch bh / h through the batch and row strides (in elements).
struct Bias {
  const void* p;  // null: no bias
  int bf16;       // 0: fp32, 1: bf16
  int h;          // batch*heads per bias batch
  long long sb, sr;
};

__device__ __forceinline__ int64_t bias_base(const Bias& b, int bh) {
  return b.p == nullptr ? 0 : (int64_t)(bh / b.h) * b.sb;
}

__device__ __forceinline__ float bias_at(const Bias& b, int64_t base, int row,
                                         int col) {
  const int64_t i = base + (int64_t)row * b.sr + col;
  return b.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(b.p)[i])
                : static_cast<const float*>(b.p)[i];
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + 64) of a (rows, 64) matrix into shared memory as fp32:
// to `nat` as [row][d] and/or to `tr` as [d][row] (either may be null).
// Rows past `rows` read as 0.
__device__ __forceinline__ void load_tile(const float* __restrict__ g, int r0,
                                          int rows, float* nat, float* tr) {
  for (int e = threadIdx.x; e < kB * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    const float v = r0 + r < rows ? g[(int64_t)(r0 + r) * kD + d] : 0.f;
    if (nat != nullptr) nat[r * kLd + d] = v;
    if (tr != nullptr) tr[d * kLd + r] = v;
  }
}

// acc[i][j] += sum_t a[t][ra + i] * b[t][cb + j] over t < 64, with a and
// b shared-memory tiles whose rows are kLd floats.
__device__ __forceinline__ void mma_4x4(const float* a, int ra,
                                        const float* b, int cb,
                                        float (&acc)[4][4]) {
#pragma unroll 8
  for (int t = 0; t < kB; ++t) {
    const float4 x = *reinterpret_cast<const float4*>(a + t * kLd + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + t * kLd + cb);
    const float xa[4] = {x.x, x.y, x.z, x.w};
    const float yb[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], yb[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ seed_pack,
                 const Bias bias, int sq, int sk, int h_local, int h_total,
                 float scale, int causal, float rate, uint32_t thresh) {
  extern __shared__ float smem[];
  float* qt = smem;            // [d][q]
  float* kt = qt + kTile;      // [d][k]
  float* vs = kt + kTile;      // [k][d]
  float* pt = vs + kTile;      // [k][q]
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t base_q = (int64_t)bh * sq * kD;
  const int64_t base_k = (int64_t)bh * sk * kD;
  const DropCtx dc = drop_ctx(seed_pack, bh, h_local, h_total);
  const int64_t base_b = bias_base(bias, bh);

  load_tile(q + base_q, q0, sq, nullptr, qt);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int nk = (sk + kB - 1) / kB;
  // tiles with a key at or left of the block's last row
  const int kend = causal ? min(nk, static_cast<int>(blockIdx.x) + 1) : nk;
  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();  // the previous tile's p^T and V are consumed
    load_tile(k + base_k, k0, sk, nullptr, kt);
    load_tile(v + base_k, k0, sk, vs, nullptr);
    __syncthreads();
    float s[4][4] = {};
    mma_4x4(qt, ty * 4, kt, tx * 4, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (col >= sk || (causal && col > row))
          x = kNegInf;
        else if (bias.p != nullptr && row < sq)
          x += bias_at(bias, base_b, row, col);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha;
        float p = s[i][j];
        if (rate > 0.f &&
            !keep_elem(dc.seed, dc.bh, static_cast<uint32_t>(dc.row_off + row),
                       static_cast<uint32_t>(dc.col_off + k0 + tx * 4 + j),
                       thresh))
          p = 0.f;
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = p;
      }
    }
    __syncthreads();
    mma_4x4(pt, ty * 4, vs, tx * 4, acc);
  }
  float* ob = o + base_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float denom = rate > 0.f ? l_safe * (1.f - rate) : l_safe;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_f32(ob + (int64_t)row * kD + tx * 4 + j, acc[i][j] / denom);
    if (tx == 0) lse[(int64_t)bh * sq + row] = m[i] + logf(l_safe);
  }
}

__device__ __forceinline__ int64_t tile_index(int qb, int kb, int nk,
                                              int causal) {
  return causal ? (int64_t)qb * (qb + 1) / 2 + kb : (int64_t)qb * nk + kb;
}

// Where the backward's dq goes.  Partials (kAcc false): `dq_part` holds
// tiles_per_bh fp32 tiles per batch*head.  Accumulated (kAcc true):
// `dq_run` holds one running fp32 tile per (bh, query tile), `turns` one
// counter per (bh, query tile) followed by the ticket, all zero at launch,
// and the last contributor writes `dq`.  `fault` plants an error for the
// checks (0: none; 1: key tile 1's contribution dropped; 2: the
// contributions added in reverse key order).
template <bool kAcc>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ seed_pack, const Bias bias,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dq_part, int64_t tiles_per_bh,
                 float* __restrict__ dq_run, int* __restrict__ turns,
                 float* __restrict__ dq, int fault, float* __restrict__ dbias,
                 int sq, int sk, int h_local, int h_total, float scale,
                 int causal, float rate, uint32_t thresh) {
  extern __shared__ float smem[];
  float* kt = smem;             // [d][k]   s = q . k
  float* ks = kt + kTile;       // [k][d]   dq = ds . k
  float* vt = ks + kTile;       // [d][k]   dp = do . v
  float* qt = vt + kTile;       // [d][q]
  float* qs = qt + kTile;       // [q][d]   dk = ds^T . q
  float* dot_ = qs + kTile;     // [d][q]
  float* dos = dot_ + kTile;    // [q][d]   dv = pd^T . do
  float* pds = dos + kTile;     // [q][k]
  float* dss = pds + kTile;     // [q][k]
  float* dst = dss + kTile;     // [k][q]
  float* lse_s = dst + kTile;   // [q]
  float* delta_s = lse_s + kB;  // [q]
  int bh = blockIdx.y, kb = blockIdx.x;
  if (kAcc) {
    // this block's (key tile, batch*head) from the ticket, key tile major
    // (reversed for the planted reverse-order fault, whose waits run the
    // other way); the ticket follows the turn counters
    __shared__ int ticket;
    if (threadIdx.x == 0)
      ticket = atomicAdd(turns + (int64_t)gridDim.y * ((sq + kB - 1) / kB), 1);
    __syncthreads();
    bh = ticket % gridDim.y;
    kb = ticket / gridDim.y;
    if (fault == 2) kb = gridDim.x - 1 - kb;
  }
  const int k0 = kb * kB;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t base_q = (int64_t)bh * sq * kD;
  const int64_t base_k = (int64_t)bh * sk * kD;
  const DropCtx dc = drop_ctx(seed_pack, bh, h_local, h_total);
  const float inv_keep = rate > 0.f ? 1.f / (1.f - rate) : 1.f;
  const int64_t base_b = bias_base(bias, bh);
  float* const db = dbias == nullptr ? nullptr : dbias + (int64_t)bh * sq * sk;

  if (db != nullptr && causal) {
    // the query tiles above this key tile's diagonal are never visited:
    // their dbias is zero
    const int rows = min(kb * kB, sq);
    for (int e = threadIdx.x; e < rows * kB; e += kThreads) {
      const int col = k0 + e % kB;
      if (col < sk) db[(int64_t)(e / kB) * sk + col] = 0.f;
    }
  }
  load_tile(k + base_k, k0, sk, ks, kt);
  load_tile(v + base_k, k0, sk, nullptr, vt);
  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  const int nq = (sq + kB - 1) / kB;
  const int nk = (sk + kB - 1) / kB;
  for (int qb = causal ? kb : 0; qb < nq; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();  // the previous q tile's operands are consumed
    load_tile(q + base_q, q0, sq, qs, qt);
    load_tile(dout + base_q, q0, sq, dos, dot_);
    if (threadIdx.x < kB) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < sq ? lse[(int64_t)bh * sq + row] : 0.f;
      delta_s[threadIdx.x] = row < sq ? delta[(int64_t)bh * sq + row] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_4x4(qt, ty * 4, kt, tx * 4, s);
    mma_4x4(dot_, ty * 4, vt, tx * 4, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int col = k0 + c;
        const bool vis = row < sq && col < sk && !(causal && col > row);
        float x = s[i][j] * scale;
        if (vis && bias.p != nullptr) x += bias_at(bias, base_b, row, col);
        const float p = vis ? expf(x - lse_s[r]) : 0.f;
        float pd = p, dpv = dp[i][j];
        if (rate > 0.f) {
          const bool keep = keep_elem(
              dc.seed, dc.bh, static_cast<uint32_t>(dc.row_off + row),
              static_cast<uint32_t>(dc.col_off + col), thresh);
          pd = keep ? p * inv_keep : 0.f;
          dpv = keep ? dpv * inv_keep : 0.f;
        }
        const float dsb = p * (dpv - delta_s[r]);  // dL/dbias
        float ds = dsb * scale;
        if (db != nullptr && row < sq && col < sk)
          db[(int64_t)row * sk + col] = dsb;
        pds[r * kLd + c] = pd;
        dss[r * kLd + c] = ds;
        dst[c * kLd + r] = ds;
      }
    }
    __syncthreads();
    mma_4x4(pds, ty * 4, dos, tx * 4, dv_acc);
    mma_4x4(dss, ty * 4, qs, tx * 4, dk_acc);
    float dqp[4][4] = {};
    mma_4x4(dst, ty * 4, ks, tx * 4, dqp);
    if (!kAcc) {
      float* part = dq_part + ((int64_t)bh * tiles_per_bh +
                               tile_index(qb, kb, nk, causal)) * (kB * kD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(part + (ty * 4 + i) * kD + tx * 4) =
            make_float4(dqp[i][0], dqp[i][1], dqp[i][2], dqp[i][3]);
      continue;
    }
    // this tile's place in the key order of query tile qb, and the last
    // place (the key tiles 0..last visit qb)
    const int last = causal ? min(qb, nk - 1) : nk - 1;
    const int pos = fault == 2 ? last - kb : kb;
    int* const turn = turns + (int64_t)bh * nq + qb;
    if (threadIdx.x == 0) {
      long long polls = 0;
      while (ld_acquire(turn) != pos) {
        __nanosleep(64);
        if (++polls > kMaxPolls) __trap();
      }
    }
    __syncthreads();
    float* const run = dq_run + ((int64_t)bh * nq + qb) * (kB * kD);
    const bool dropped = fault == 1 && kb == 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float4* const cell = reinterpret_cast<float4*>(run + r * kD + tx * 4);
      const float4 prev = pos == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                   : __ldcg(cell);
      const float4 sum =
          dropped ? prev
                  : make_float4(prev.x + dqp[i][0], prev.y + dqp[i][1],
                                prev.z + dqp[i][2], prev.w + dqp[i][3]);
      if (pos < last) {
        __stcg(cell, sum);
      } else if (q0 + r < sq) {
        float* const out = dq + ((int64_t)bh * sq + q0 + r) * kD + tx * 4;
        store_f32(out, sum.x);
        store_f32(out + 1, sum.y);
        store_f32(out + 2, sum.z);
        store_f32(out + 3, sum.w);
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(turn, pos + 1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store_f32(dk + base_k + (int64_t)row * kD + tx * 4 + j, dk_acc[i][j]);
      store_f32(dv + base_k + (int64_t)row * kD + tx * 4 + j, dv_acc[i][j]);
    }
  }
}

// dQ of one (64-query tile, batch*head): the visited key tiles' partials
// (64 x d fp32 tiles) added in key order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                int sq, int sk, int causal, int64_t tiles_per_bh, int d) {
  const int bh = blockIdx.y;
  const int qb = blockIdx.x;
  const int nk = (sk + kB - 1) / kB;
  const int kend = causal ? min(nk, qb + 1) : nk;
  const float* base = dq_part + (int64_t)bh * tiles_per_bh * (kB * d);
  for (int e = threadIdx.x; e < kB * d; e += kThreads) {
    const int row = qb * kB + e / d;
    if (row >= sq) break;
    float acc = 0.f;
    for (int kb = 0; kb < kend; ++kb)
      acc += base[tile_index(qb, kb, nk, causal) * (kB * d) + e];
    store_f32(dq + ((int64_t)bh * sq + row) * d + e % d, acc);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16 q, k, v at head_dim D = 64 or 128
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int kFaultNan = 3;     // planted: rows past the end staged as NaN

// A staged 64 x D bf16 tile: rows of D + 8 elements (16 bytes of padding,
// so the 8 rows an ldmatrix reads fall in distinct banks).
template <int D>
struct Tc {
  static constexpr int kLd = D + 8;
  static constexpr int kTile = kB * kLd;  // elements
  static constexpr int kChunks = D / 8;   // 16-byte copies a row
  // forward: q, then two stages of k and v
  static constexpr size_t kFwdSmem = 5 * kTile * sizeof(bf16);
  // backward: k, v, two stages of (q, dO), then lse and delta per stage
  static constexpr size_t kBwdSmem =
      6 * kTile * sizeof(bf16) + 4 * kB * sizeof(float);
  // resident backward blocks an SM the registers are capped for (the
  // shared memory allows 4 at D 64, 2 at D 128)
  static constexpr int kBwdBlocks = D == 64 ? 3 : 2;
};
constexpr int kLdS = kB + 8;  // row of the staged ds^T tile [key][query]

// Rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a staged tile by
// cp.async; rows past `rows` are zero-filled, or with `nan_fill` (the
// planted fault) set to NaN.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* __restrict__ g,
                                           int r0, int rows, bool nan_fill) {
#pragma unroll
  for (int e = threadIdx.x; e < kB * Tc<D>::kChunks; e += kTcThreads) {
    const int r = e / Tc<D>::kChunks, c = (e % Tc<D>::kChunks) * 8;
    bf16* const dst = s + r * Tc<D>::kLd + c;
    const bool valid = r0 + r < rows;
    if (!valid && nan_fill)
      *reinterpret_cast<uint4*>(dst) = make_uint4(~0u, ~0u, ~0u, ~0u);
    else
      cp_async16(dst, g + (valid ? (int64_t)(r0 + r) * D + c : 0), valid);
  }
}


template <int D, bool kProbs>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, const int* __restrict__ seed_pack,
             const Bias bias, int sq, int sk, int h_local, int h_total,
             float scale, int causal, float rate, uint32_t thresh,
             int fault) {
  constexpr int kT = Tc<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const ks = qs + kT;      // two stages
  bf16* const vs = ks + 2 * kT;  // two stages
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t base_q = (int64_t)bh * sq * D;
  const int64_t base_k = (int64_t)bh * sk * D;
  const DropCtx dc = drop_ctx(seed_pack, bh, h_local, h_total);
  const int64_t base_b = bias_base(bias, bh);
  const bool has_bias = bias.p != nullptr;
  const bool nan_fill = fault == kFaultNan;
  const int nk = (sk + kB - 1) / kB;
  // tiles with a key at or left of the block's last row
  const int kend = causal ? min(nk, static_cast<int>(blockIdx.x) + 1) : nk;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  stage_rows<D>(qs, q + base_q, q0, sq, nan_fill);
  stage_rows<D>(ks, k + base_k, 0, sk, nan_fill);
  stage_rows<D>(vs, v + base_k, 0, sk, nan_fill);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < kend; ++kb) {
    const int k0 = kb * kB;
    const bf16* const kst = ks + (kb & 1) * kT;
    const bf16* const vst = vs + (kb & 1) * kT;
    __syncthreads();  // the stage refilled below (tile kb - 1's) is consumed
    if (kb + 1 < kend) {
      stage_rows<D>(ks + ((kb + 1) & 1) * kT, k + base_k, k0 + kB, sk,
                    nan_fill);
      stage_rows<D>(vs + ((kb + 1) & 1) * kT, v + base_k, k0 + kB, sk,
                    nan_fill);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed: tile kb
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) a_rows<D>(qf[kk], qs, warp * 16, kk);
    }
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_scores<D>(s, qf[kk], kst, kk);
    // s[n][2 h + j] is row rows[h], column k0 + 8 n + 2 t + j; bit
    // 4 n + 2 h + j of `vis` is its.  The mask and the bias are passes
    // that branch only on what holds for the whole tile; only a tile on
    // the diagonal or past Sk has masked elements.
    const bool edge = k0 + kB > sk || (causal && k0 + kB - 1 > q0);
    uint32_t vis = ~0u;
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + n * 8 + 2 * t + (i & 1);
          if (col >= sk || (causal && col > rows[i >> 1]))
            vis &= ~(1u << (4 * n + i));
        }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= scale;
    if (has_bias) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((vis >> (4 * n + i) & 1) && rows[i >> 1] < sq)
            s[n][i] += bias_at(bias, base_b, rows[i >> 1],
                               k0 + n * 8 + 2 * t + (i & 1));
    }
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!(vis >> (4 * n + i) & 1)) s[n][i] = kNegInf;
    }
    const uint32_t col_hash =
        static_cast<uint32_t>(dc.col_off + k0 + 2 * t) * kHashCol;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows[h];
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) mx = fmaxf(mx, s[n][2 * h + j]);
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float alpha = exp2_ftz((m[h] - m_new) * kLog2e);
      const float m_l2 = m_new * kLog2e;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = exp2_ftz(fmaf(s[n][2 * h + j], kLog2e, -m_l2));
          s[n][2 * h + j] = p;
          rs += p;
        }
      l[h] = alpha * l[h] + quad_sum(rs);
      m[h] = m_new;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][2 * h] *= alpha;
        acc[i][2 * h + 1] *= alpha;
      }
      if (rate > 0.f) {
        const uint32_t base =
            (static_cast<uint32_t>(dc.row_off + row) * kHashRow +
             dc.bh * kHashBh + col_hash);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (!keep_mixed((base + static_cast<uint32_t>(n * 8 + j) *
                                        kHashCol) ^ dc.seed,
                            thresh))
              s[n][2 * h + j] = 0.f;
      }
    }
    // o += p . v with p from the accumulators: rounded (probs_bf16) or
    // split into hi + lo
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t ph[4], pl[4];
      a_frag<!kProbs>(s, kk, ph, pl);
      mma_rows<D, !kProbs>(acc, ph, pl, vst, kk);
    }
  }
  bf16* const ob = o + base_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= sq) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const float denom = rate > 0.f ? l_safe * (1.f - rate) : l_safe;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * D + i * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[i][2 * h] / denom,
                                acc[i][2 * h + 1] / denom);
    if (t == 0) lse[(int64_t)bh * sq + row] = m[h] + logf(l_safe);
  }
}

// q and dO rows [q0, q0 + 64), and their lse and delta, into one stage.
template <int D>
__device__ __forceinline__ void stage_queries(
    bf16* st, float* lse_st, float* delta_st, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int q0, int sq, bool nan_fill) {
  stage_rows<D>(st, q, q0, sq, nan_fill);
  stage_rows<D>(st + Tc<D>::kTile, dout, q0, sq, nan_fill);
  const int i = threadIdx.x % kB;
  const bool valid = q0 + i < sq;
  const int src = valid ? q0 + i : 0;
  if (threadIdx.x < kB)
    cp_async4(lse_st + i, lse + src, valid);
  else
    cp_async4(delta_st + i, delta + src, valid);
}

// Arguments as flash_bwd_kernel's.
template <int D, bool kProbs, bool kAcc>
__global__ void __launch_bounds__(kTcThreads, Tc<D>::kBwdBlocks)
flash_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ seed_pack, const Bias bias,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ dq_part, int64_t tiles_per_bh,
             float* __restrict__ dq_run, int* __restrict__ turns,
             bf16* __restrict__ dq, int fault, float* __restrict__ dbias,
             int sq, int sk, int h_local, int h_total, float scale,
             int causal, float rate, uint32_t thresh) {
  constexpr int kT = Tc<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // [key][d]
  bf16* const vs = ks + kT;                             // [key][d]
  bf16* const stages = vs + kT;  // per stage: q [query][d], dO [query][d]
  float* const lse_s = reinterpret_cast<float*>(stages + 4 * kT);  // [2][64]
  float* const delta_s = lse_s + 2 * kB;                            // [2][64]
  int bh = blockIdx.y, kb = blockIdx.x;
  if (kAcc) {
    // this block's (key tile, batch*head) from the ticket, key tile major
    // (reversed for the planted reverse-order fault, whose waits run the
    // other way); the ticket follows the turn counters
    __shared__ int ticket;
    if (threadIdx.x == 0)
      ticket = atomicAdd(turns + (int64_t)gridDim.y * ((sq + kB - 1) / kB), 1);
    __syncthreads();
    bh = ticket % gridDim.y;
    kb = ticket / gridDim.y;
    if (fault == 2) kb = gridDim.x - 1 - kb;
  }
  const int k0 = kb * kB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lm = lane / 8, lr = lane % 8;
  const int64_t base_q = (int64_t)bh * sq * D;
  const int64_t base_k = (int64_t)bh * sk * D;
  const DropCtx dc = drop_ctx(seed_pack, bh, h_local, h_total);
  const float inv_keep = rate > 0.f ? 1.f / (1.f - rate) : 1.f;
  const int64_t base_b = bias_base(bias, bh);
  const bool has_bias = bias.p != nullptr;
  float* const db = dbias == nullptr ? nullptr : dbias + (int64_t)bh * sq * sk;
  const bool nan_fill = fault == kFaultNan;
  const int nq = (sq + kB - 1) / kB;
  const int nk = (sk + kB - 1) / kB;
  const int qb0 = causal ? kb : 0;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  // the dropout hash's terms of this thread's keys and of batch*head
  const uint32_t key_hash[2] = {
      static_cast<uint32_t>(dc.col_off + keys[0]) * kHashCol +
          dc.bh * kHashBh,
      static_cast<uint32_t>(dc.col_off + keys[1]) * kHashCol +
          dc.bh * kHashBh};

  if (db != nullptr && causal) {
    // the query tiles above this key tile's diagonal are never visited:
    // their dbias is zero
    const int rows = min(kb * kB, sq);
    for (int e = threadIdx.x; e < rows * kB; e += kTcThreads) {
      const int col = k0 + e % kB;
      if (col < sk) db[(int64_t)(e / kB) * sk + col] = 0.f;
    }
  }
  stage_rows<D>(ks, k + base_k, k0, sk, nan_fill);
  stage_rows<D>(vs, v + base_k, k0, sk, nan_fill);
  if (qb0 < nq)
    stage_queries<D>(stages, lse_s, delta_s, q + base_q, dout + base_q,
                     lse + (int64_t)bh * sq, delta + (int64_t)bh * sq,
                     qb0 * kB, sq, nan_fill);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qb = qb0; qb < nq; ++qb) {
    const int q0 = qb * kB;
    const int st = (qb - qb0) & 1;
    bf16* const qst = stages + st * 2 * kT;
    bf16* const dost = qst + kT;
    const float* const lse_st = lse_s + st * kB;
    const float* const delta_st = delta_s + st * kB;
    // the stage refilled below (tile qb - 1's, its ds^T included) is
    // consumed
    __syncthreads();
    if (qb + 1 < nq)
      stage_queries<D>(stages + (st ^ 1) * 2 * kT, lse_s + (st ^ 1) * kB,
                       delta_s + (st ^ 1) * kB, q + base_q, dout + base_q,
                       lse + (int64_t)bh * sq, delta + (int64_t)bh * sq,
                       q0 + kB, sq, nan_fill);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just committed: tile qb
    __syncthreads();

    // s^T = k . q^T and dp^T = v . dO^T: this warp's 16 keys x 64 queries;
    // s[n][2 h + j] is key keys[h], query q0 + 8 n + 2 t + j
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      a_rows<D>(af, ks, warp * 16, kk);
      mma_scores<D>(s, af, qst, kk);
      a_rows<D>(af, vs, warp * 16, kk);
      mma_scores<D>(dp, af, dost, kk);
    }
    // s -> pd, dp -> ds, in passes over the 32 elements that branch only
    // on what holds for the whole tile; bit 4 n + j of `vis` and `keep`
    // belongs to s[n][j].  Only a tile on the diagonal or past Sq or Sk
    // has masked elements.
    const bool edge =
        q0 + kB > sq || k0 + kB > sk || (causal && qb == kb);
    const uint32_t row_hash =
        static_cast<uint32_t>(dc.row_off + q0 + 2 * t) * kHashRow;
    uint32_t vis = ~0u, keep = ~0u;
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = keys[j >> 1], row = q0 + n * 8 + 2 * t + (j & 1);
          if (row >= sq || key >= sk || (causal && key > row))
            vis &= ~(1u << (4 * n + j));
        }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] *= scale;
    if (has_bias) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (vis >> (4 * n + j) & 1)
            s[n][j] += bias_at(bias, base_b, q0 + n * 8 + 2 * t + (j & 1),
                               keys[j >> 1]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            exp2_ftz((s[n][j] - lse_st[n * 8 + 2 * t + (j & 1)]) * kLog2e);
        s[n][j] = vis >> (4 * n + j) & 1 ? p : 0.f;
      }
    if (rate > 0.f) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!keep_mixed(
                  (row_hash + static_cast<uint32_t>(n * 8 + (j & 1)) *
                                  kHashRow +
                   key_hash[j >> 1]) ^ dc.seed,
                  thresh))
            keep &= ~(1u << (4 * n + j));
    }
    // dbias = p * (dp - delta), the dropped dp zeroed and the kept scaled
    // by 1 / (1 - rate); ds = dbias * scale; pd likewise from p
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dpv = keep >> (4 * n + j) & 1 ? dp[n][j] * inv_keep : 0.f;
        dp[n][j] = s[n][j] * (dpv - delta_st[n * 8 + 2 * t + (j & 1)]);
      }
    if (db != nullptr) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = keys[j >> 1], row = q0 + n * 8 + 2 * t + (j & 1);
          if (row < sq && key < sk) db[(int64_t)row * sk + key] = dp[n][j];
        }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = keep >> (4 * n + j) & 1 ? s[n][j] * inv_keep : 0.f;
        dp[n][j] *= scale;
      }
    // dV += pd^T . dO and dK += ds^T . q, the A operands from registers
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t hi[4], lo[4];
      a_frag<!kProbs>(s, kk, hi, lo);
      mma_rows<D, !kProbs>(dv_acc, hi, lo, dost, kk);
      a_frag<!kProbs>(dp, kk, hi, lo);
      mma_rows<D, !kProbs>(dk_acc, hi, lo, qst, kk);
    }
    // ds^T as bf16 hi (and lo) over this stage's q and dO, for dQ
    bf16* const dsh = qst;
    bf16* const dsl = qst + kB * kLdS;
    __syncthreads();  // every warp is done with this stage's q and dO
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (warp * 16 + g + 8 * h) * kLdS + n * 8 + 2 * t;
        uint32_t hi, lo;
        if (kProbs) {
          hi = pack_bf16(dp[n][2 * h], dp[n][2 * h + 1]);
        } else {
          split_bf16(dp[n][2 * h], dp[n][2 * h + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(dsl + off) = lo;
        }
        *reinterpret_cast<uint32_t*>(dsh + off) = hi;
      }
    __syncthreads();
    // dQ tile = ds . k: this warp's 16 queries x D;
    // dqp[i][2 h + j] is query q0 + warp * 16 + g + 8 h, column 8 i + 2 t + j
    float dqp[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dqp[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      const int off = (kk * 16 + (lm >> 1) * 8 + lr) * kLdS + warp * 16 +
                      (lm & 1) * 8;
      uint32_t hi[4], lo[4];
      ldmatrix_x4_trans(hi, dsh + off);
      if (!kProbs) ldmatrix_x4_trans(lo, dsl + off);
      mma_rows<D, !kProbs>(dqp, hi, lo, ks, kk);
    }
    const int qr[2] = {warp * 16 + g, warp * 16 + g + 8};  // in the tile
    if (!kAcc) {
      float* part = dq_part + ((int64_t)bh * tiles_per_bh +
                               tile_index(qb, kb, nk, causal)) * (kB * D);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<float2*>(part + qr[h] * D + i * 8 + 2 * t) =
              make_float2(dqp[i][2 * h], dqp[i][2 * h + 1]);
      continue;
    }
    // this tile's place in the key order of query tile qb, and the last
    // place (the key tiles 0..last visit qb)
    const int last = causal ? min(qb, nk - 1) : nk - 1;
    const int pos = fault == 2 ? last - kb : kb;
    int* const turn = turns + (int64_t)bh * nq + qb;
    if (threadIdx.x == 0) {
      long long polls = 0;
      while (ld_acquire(turn) != pos) {
        __nanosleep(64);
        if (++polls > kMaxPolls) __trap();
      }
    }
    __syncthreads();
    float* const run = dq_run + ((int64_t)bh * nq + qb) * (kB * D);
    const bool dropped = fault == 1 && kb == 1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        float2* const cell =
            reinterpret_cast<float2*>(run + qr[h] * D + i * 8 + 2 * t);
        const float2 prev = pos == 0 ? make_float2(0.f, 0.f) : __ldcg(cell);
        const float2 sum =
            dropped ? prev
                    : make_float2(prev.x + dqp[i][2 * h],
                                  prev.y + dqp[i][2 * h + 1]);
        if (pos < last)
          __stcg(cell, sum);
        else if (q0 + qr[h] < sq)
          *reinterpret_cast<__nv_bfloat162*>(
              dq + ((int64_t)bh * sq + q0 + qr[h]) * D + i * 8 + 2 * t) =
              __floats2bfloat162_rn(sum.x, sum.y);
      }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(turn, pos + 1);
  }
  cp_async_wait<0>();  // a block that visits no query tile staged k and v
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= sk) continue;
    const int64_t at = base_k + (int64_t)keys[h] * D + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + i * 8) =
          __floats2bfloat162_rn(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + i * 8) =
          __floats2bfloat162_rn(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

constexpr size_t kFwdSmem = 4 * kTile * sizeof(float);
constexpr size_t kBwdSmem = (10 * kTile + 2 * kB) * sizeof(float);

// The fp32 FMA forward (head_dim 64).
int launch_fwd_fma(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* seed, const Bias& bias, int bh,
                   int sq, int sk, int h_local, int h_total, float scale,
                   int causal, float rate, uint32_t thresh, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kB - 1) / kB, bh);
  flash_fwd_kernel<<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seed, bias,
      sq, sk, h_local, h_total, scale, causal, rate, thresh);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tensor-core forward; probs_bf16 is a template argument, so the
// option costs the kernel without it nothing.
template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, const int* seed, const Bias& bias, int bh,
                  int sq, int sk, int h_local, int h_total, float scale,
                  int causal, float rate, uint32_t thresh, int probs,
                  int fault, cudaStream_t s) {
  decltype(&flash_fwd_tc<D, false>) kern =
      probs ? &flash_fwd_tc<D, true> : &flash_fwd_tc<D, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tc<D>::kFwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kB - 1) / kB, bh);
  kern<<<grid, kTcThreads, Tc<D>::kFwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, seed, bias, sq,
      sk, h_local, h_total, scale, causal, rate, thresh, fault);
  return static_cast<int>(cudaGetLastError());
}

// The backward's inputs and outputs, for both designs: dq_part and
// tiles_per_bh for the partials backward, dq_run and turns for the acc
// one (null and 0 otherwise); fault as for apex_flash_bwd_acc.
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* seed;
  void *dq, *dk, *dv;
  float* dq_part;
  long long tiles_per_bh;
  float* dq_run;
  int* turns;
  int fault;
  float* dbias;
};

// Before a backward launch: the kernel's shared memory and, for the acc
// backward, the turn counters and the ticket set to 0.
template <bool kAcc, typename Kern>
cudaError_t bwd_prologue(Kern kern, size_t smem, const BwdArgs& a, int bh,
                         int sq, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess || !kAcc) return e;
  const size_t nq = (sq + kB - 1) / kB;
  return cudaMemsetAsync(a.turns, 0, ((size_t)bh * nq + 1) * sizeof(int), s);
}

// After the partials backward: the key-order dq sum.
template <typename T>
int dq_epilogue(const BwdArgs& a, int bh, int sq, int sk, int causal, int d,
                cudaStream_t s) {
  const dim3 grid_q((sq + kB - 1) / kB, bh);
  flash_dq_kernel<T><<<grid_q, kThreads, 0, s>>>(
      a.dq_part, static_cast<T*>(a.dq), sq, sk, causal, a.tiles_per_bh, d);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 FMA backward (head_dim 64).
template <bool kAcc>
int launch_bwd_fma(const BwdArgs& a, const Bias& bias, int bh, int sq,
                   int sk, int h_local, int h_total, float scale, int causal,
                   float rate, uint32_t thresh, cudaStream_t s) {
  cudaError_t e =
      bwd_prologue<kAcc>(flash_bwd_kernel<kAcc>, kBwdSmem, a, bh, sq, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k((sk + kB - 1) / kB, bh);
  flash_bwd_kernel<kAcc><<<grid_k, kThreads, kBwdSmem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.seed, bias, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.dq_part, a.tiles_per_bh, a.dq_run, a.turns,
      static_cast<float*>(a.dq), a.fault, a.dbias, sq, sk, h_local, h_total,
      scale, causal, rate, thresh);
  e = cudaGetLastError();
  if (e != cudaSuccess || kAcc) return static_cast<int>(e);
  return dq_epilogue<float>(a, bh, sq, sk, causal, kD, s);
}

// The bf16 tensor-core backward at head_dim D.
template <int D, bool kAcc>
int launch_bwd_tc(const BwdArgs& a, const Bias& bias, int bh, int sq, int sk,
                  int h_local, int h_total, float scale, int causal,
                  float rate, uint32_t thresh, int probs, cudaStream_t s) {
  decltype(&flash_bwd_tc<D, false, kAcc>) kern =
      probs ? &flash_bwd_tc<D, true, kAcc> : &flash_bwd_tc<D, false, kAcc>;
  cudaError_t e = bwd_prologue<kAcc>(kern, Tc<D>::kBwdSmem, a, bh, sq, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_k((sk + kB - 1) / kB, bh);
  kern<<<grid_k, kTcThreads, Tc<D>::kBwdSmem, s>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.seed, bias, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.dq_part, a.tiles_per_bh, a.dq_run, a.turns,
      static_cast<bf16*>(a.dq), a.fault, a.dbias, sq, sk, h_local, h_total,
      scale, causal, rate, thresh);
  e = cudaGetLastError();
  if (e != cudaSuccess || kAcc) return static_cast<int>(e);
  return dq_epilogue<bf16>(a, bh, sq, sk, causal, D, s);
}

// Either design's backward for the dtype code and head_dim, or
// cudaErrorInvalidValue for a pair no kernel takes (fault 3 is the
// tensor-core kernels' only).
template <bool kAcc>
int dispatch_bwd(const BwdArgs& a, const Bias& bias, int bh, int sq, int sk,
                 int h_local, int h_total, float scale, int causal, float rate,
                 uint32_t thresh, int probs, int d, int dtype, cudaStream_t s) {
  if (dtype == 0 && d == kD && a.fault != kFaultNan)
    return launch_bwd_fma<kAcc>(a, bias, bh, sq, sk, h_local, h_total, scale,
                                causal, rate, thresh, s);
  if (dtype == 1 && d == 64)
    return launch_bwd_tc<64, kAcc>(a, bias, bh, sq, sk, h_local, h_total,
                                   scale, causal, rate, thresh, probs, s);
  if (dtype == 1 && d == 128)
    return launch_bwd_tc<128, kAcc>(a, bias, bh, sq, sk, h_local, h_total,
                                    scale, causal, rate, thresh, probs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory a block (the static size plus the dynamic size the
// runtime now allows it), resident blocks per SM, registers a thread and
// local (spilled) bytes a thread of one kernel, into out[4], as the
// runtime reports them.
template <typename Kern>
int kernel_info(Kern kern, int threads, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>(attr.sharedSizeBytes) +
           attr.maxDynamicSharedSizeBytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kern, threads,
                                                    smem));
}

template <int D, bool kProbs>
int tc_info(int kernel, int* out) {
  if (kernel == 0)
    return kernel_info(flash_fwd_tc<D, kProbs>, kTcThreads, Tc<D>::kFwdSmem,
                       out);
  if (kernel == 1)
    return kernel_info(flash_bwd_tc<D, kProbs, false>, kTcThreads,
                       Tc<D>::kBwdSmem, out);
  return kernel_info(flash_bwd_tc<D, kProbs, true>, kTcThreads,
                     Tc<D>::kBwdSmem, out);
}

}  // namespace

// Tiles of the dq partials buffer per batch*head: the buffer holds
// bh * tiles * 64 * head_dim floats.
extern "C" long long apex_flash_dq_tiles(int sq, int sk, int causal) {
  const long long nq = (sq + kB - 1) / kB, nk = (sk + kB - 1) / kB;
  return causal ? nq * (nq + 1) / 2 : nq * nk;
}

// The bias arguments: bias null for none, else bias_dtype 0 = float32,
// 1 = bfloat16, logically (bh / bias_h, sq, sk) with a unit column stride
// and batch/row strides bias_sb/bias_sr in elements (bias_sr may be 0).
static Bias make_bias(const void* bias, int bias_dtype, int bias_h,
                      long long bias_sb, long long bias_sr) {
  Bias b;
  b.p = bias;
  b.bf16 = bias_dtype;
  b.h = bias_h > 0 ? bias_h : 1;
  b.sb = bias_sb;
  b.sr = bias_sr;
  return b;
}

// q: (bh, sq, d), k/v: (bh, sk, d), o like q, lse: (bh, sq) fp32;
// dtype 0 = float32 (d 64: the FMA kernel), 1 = bfloat16 (d 64 or 128:
// the tensor-core kernel).  seed: device int32[4] = [seed, row offset,
// col offset, head offset]; thresh = (1 - rate) * 2^32 clamped;
// probs_bf16 1 rounds each tile's probabilities to the input dtype before
// p.V; fault: 0, or 3 (bf16 only) to stage the rows past the end as NaN
// (a planted error for the checks).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments no kernel takes.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int* seed,
                              const void* bias, int bias_dtype, int bias_h,
                              long long bias_sb, long long bias_sr, int bh,
                              int sq, int sk, int h_local, int h_total,
                              float scale, int causal, float rate,
                              unsigned int thresh, int probs_bf16, int fault,
                              int d, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if ((bias != nullptr && (bias_dtype < 0 || bias_dtype > 1)) ||
      (fault != 0 && fault != kFaultNan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias b = make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr);
  if (dtype == 0 && d == kD && fault == 0)
    return launch_fwd_fma(q, k, v, o, lse, seed, b, bh, sq, sk, h_local,
                          h_total, scale, causal, rate, thresh, s);
  if (dtype == 1 && d == 64)
    return launch_fwd_tc<64>(q, k, v, o, lse, seed, b, bh, sq, sk, h_local,
                             h_total, scale, causal, rate, thresh, probs_bf16,
                             fault, s);
  if (dtype == 1 && d == 128)
    return launch_fwd_tc<128>(q, k, v, o, lse, seed, b, bh, sq, sk, h_local,
                              h_total, scale, causal, rate, thresh,
                              probs_bf16, fault, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout like q; lse, delta: (bh, sq) fp32 (delta = rowsum(dout * o));
// the bias, probs_bf16, fault, d and dtype as for apex_flash_fwd; dq, dk,
// dv like q, k, v; dq_part: fp32 scratch of bh * apex_flash_dq_tiles(...)
// * 64 * d; dbias: null, or an fp32 (bh, sq, sk) output that every
// element of is written.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue.
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const int* seed,
                              const void* bias, int bias_dtype, int bias_h,
                              long long bias_sb, long long bias_sr, void* dq,
                              void* dk, void* dv, float* dq_part,
                              float* dbias, int bh, int sq, int sk,
                              int h_local, int h_total, float scale,
                              int causal, float rate, unsigned int thresh,
                              int probs_bf16, int fault, int d, int dtype,
                              void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if ((bias != nullptr && (bias_dtype < 0 || bias_dtype > 1)) ||
      (fault != 0 && fault != kFaultNan))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {q,  k,  v,  dout,
                     lse, delta, seed, dq,
                     dk, dv, dq_part, apex_flash_dq_tiles(sq, sk, causal),
                     nullptr, nullptr, fault, dbias};
  return dispatch_bwd<false>(
      a, make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr), bh, sq, sk,
      h_local, h_total, scale, causal, rate, thresh, probs_bf16, d, dtype,
      static_cast<cudaStream_t>(stream));
}

// Floats of the running dq buffer of apex_flash_bwd_acc (one 64 x d tile
// per (bh, query tile)) and ints of its turn counters (one per
// (bh, query tile), then the ticket).
extern "C" long long apex_flash_acc_floats(int bh, int sq, int d) {
  return (long long)bh * ((sq + kB - 1) / kB) * kB * d;
}
extern "C" long long apex_flash_acc_turns(int bh, int sq) {
  return (long long)bh * ((sq + kB - 1) / kB) + 1;
}

// The combined backward with dq accumulated in key order: arguments as
// for apex_flash_bwd without dq_part and dbias; dq_run: fp32 scratch of
// apex_flash_acc_floats(bh, sq, d) (any contents: it is written before it
// is read); turns: int32 scratch of apex_flash_acc_turns(bh, sq), zeroed
// here on the stream; fault: 0, or a planted error for the checks (1: key
// tile 1's contribution dropped, 2: key order reversed, 3: as for
// apex_flash_fwd).  Returns cudaGetLastError(), or cudaErrorInvalidValue.
extern "C" int apex_flash_bwd_acc(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* seed,
                                  const void* bias, int bias_dtype,
                                  int bias_h, long long bias_sb,
                                  long long bias_sr, void* dq, void* dk,
                                  void* dv, float* dq_run, int* turns, int bh,
                                  int sq, int sk, int h_local, int h_total,
                                  float scale, int causal, float rate,
                                  unsigned int thresh, int probs_bf16,
                                  int fault, int d, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if ((bias != nullptr && (bias_dtype < 0 || bias_dtype > 1)) || fault < 0 ||
      fault > kFaultNan)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {q,  k,  v,      dout,  lse,   delta, seed,  dq,
                     dk, dv, nullptr, 0,    dq_run, turns, fault, nullptr};
  return dispatch_bwd<true>(
      a, make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr), bh, sq, sk,
      h_local, h_total, scale, causal, rate, thresh, probs_bf16, d, dtype,
      static_cast<cudaStream_t>(stream));
}

// The records of a tensor-core kernel (kernel 0: forward, 1: partials
// backward, 2: acc backward) at head_dim d (64 or 128), the instantiation
// with probs_bf16 when probs is nonzero: out = [shared memory bytes a
// block, resident blocks per SM, registers a thread, local (spilled)
// bytes a thread].  Returns a CUDA error code.
extern "C" int apex_flash_tc_info(int kernel, int d, int probs, int* out) {
  if (kernel < 0 || kernel > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return probs ? tc_info<64, true>(kernel, out)
                 : tc_info<64, false>(kernel, out);
  if (d == 128)
    return probs ? tc_info<128, true>(kernel, out)
                 : tc_info<128, false>(kernel, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
