// Flash attention, forward and combined backward, with an optional
// additive bias and its gradient, head_dim 64.
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
// keys (col > row, local coordinates) get -1e30; an
// online softmax in fp32 (m, l, acc); dropout after the l sum, from the
// murmur3-fmix32 counter hash of (seed, batch*head, global row, global
// col) (_keep_mask), normaliser l * (1 - rate); p.V is an fp32 product
// (V upcast).  The forward writes O in the input dtype and lse = m +
// log(l) in fp32.  The backward recomputes p = exp(s - lse) and, with
// delta = rowsum(dO * O) from the wrapper: dp = dO . V^T; pd and dp masked
// and scaled by 1 / (1 - rate); dV = pd^T . dO; ds = p * (dp - delta) *
// scale; dK = ds^T . Q; dQ = ds . K, all in fp32, outputs in the input
// dtype.  With a dbias buffer, the backward also writes
// p * (dp - delta) for every (bh, row, col), without the scale factor
// (the bias enters after it), as fp32 (BH, sq, sk); the caller sums it
// over heads.  The products of bf16 inputs are exact in fp32, so the QK^T and
// dO.V^T products done here in fp32 FMAs are the reference's bf16 MXU dots
// with fp32 accumulation up to summation order.
//
// probs_bf16 (the reference's opt-in half-precision probabilities): the
// forward rounds each key tile's p = exp(s - m_running), after the
// dropout mask and before p.V, to the input dtype; the backward rounds pd
// (before pd^T . dO) and ds (before ds^T . Q and ds . K) to it, while
// dbias keeps the unrounded p * (dp - delta).  q, k, v and dO are used as
// they are and every product still accumulates in fp32, so each product
// is one of bf16 values with an fp32 sum; for fp32 inputs the rounding is
// the identity.  The forward's rounding depends on the 64-key tile (the
// running max m changes from tile to tile), as the reference's does on
// its block_k; the backward's p = exp(s - lse) does not.
//
// Bound on the H100: operations.  At the training shape (B 16, H 12,
// S 1024, causal) each product is B*H*S^2*D = 12.9 GFLOP.  The forward's
// fp32 p.V alone takes 0.19 ms at 67 TFLOP/s (QK^T at the bf16 tensor-core
// rate 13 us; its 101 MB of bytes 30 us); the backward's three fp32
// products and two bf16 ones about 0.6 ms.  At BERT-large's shape (B 12,
// H 16, S 512, no causal mask, key-padding bias) each product is 6.44
// GFLOP: the forward's bound is 0.103 ms, the backward's 0.301 ms.
// With probs_bf16 every product is one of bf16 values, so the bound is
// the tensor cores' (about 15x less); the products here still run as fp32
// FMAs on the CUDA cores, so the option changes the numbers, not the time.
//
// Design.  Both kernels work on 64 x 64 tiles with 256 threads, each
// thread owning a 4 x 4 micro-tile of every product, fed by float4 reads
// from shared memory (one operand stored transposed, so a thread's four
// rows are one float4): per step 2 float4 reads feed 16 FMAs, which keeps
// the FMA pipes, not shared memory, the limit.  All products run on the
// CUDA cores in fp32; moving QK^T onto the tensor cores (mma on bf16) and
// the fp32 products onto them by splitting p into bf16 parts is later
// work.
// Forward: one block per (64-query tile, batch*head) walks the key tiles
// up to the diagonal (fully masked tiles are skipped), keeps m, l and the
// 4 x 4 accumulator of its rows in registers, and stages p^T in shared
// memory for the p.V product.  Row max and row sum reduce over the 16
// threads of a half-warp that share the rows, by shuffles.
// Backward: one block per (64-key tile, batch*head) walks the query tiles
// from the diagonal down and keeps its dK and dV tiles in registers.  Its
// dQ contribution of each visited query tile (ds . K, an fp32 64 x 64
// tile) goes one of two ways:
// - partials (apex_flash_bwd): to its own slot of an fp32 partials
//   buffer, which a second small kernel adds in key order.  The buffer
//   holds only the visited tiles, q*(q+1)/2 + k for causal, q*nk + k
//   otherwise: bh x 136 x 64 x 64 floats at S 1024 causal.
// - accumulated (apex_flash_bwd_acc): into one running fp32 64 x 64 block
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
//   that its predecessor needs.  The running buffer is bh x nq x 64 x 64
//   floats (bh x 16 x 64 x 64 at S 1024), and the traffic of the two ways
//   is about the same: the running block is read and written once per
//   visited tile, where the partials are written once and read back once.
// dbias needs no such care: the block of a key tile is the
// only writer of that tile's columns, so each element is written once,
// directly, and the causally skipped tiles (the rows above the diagonal
// block) are zero-filled by the same block.  The bias is read straight
// from device memory in the elementwise step (16 values a thread, a
// half-warp reading 64 consecutive columns of a row); at BERT-large's
// shape it adds 12.6 MB to the forward's reads, against the 0.1 ms the
// products need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head_dim
constexpr int kB = 64;        // query and key tile
constexpr int kLd = kB + 4;   // padded row of a shared-memory tile
constexpr int kThreads = 256;
constexpr int kTile = kB * kLd;  // floats per shared-memory tile
constexpr float kNegInf = -1e30f;
// polls of a turn counter before the kernel traps instead of hanging
// (each poll sleeps at least 64 ns: several seconds in all)
constexpr long long kMaxPolls = 1LL << 27;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and back (probs_bf16): the identity for fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
__device__ __forceinline__ bool keep_elem(uint32_t seed, uint32_t bh,
                                          uint32_t row, uint32_t col,
                                          uint32_t thresh) {
  uint32_t x = (row * 0x9E3779B1u + col * 0x85EBCA77u + bh * 0xC2B2AE3Du) ^
               seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < thresh;
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
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int r0,
                                          int rows, float* nat, float* tr) {
  for (int e = threadIdx.x; e < kB * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    const float v = r0 + r < rows ? to_f32(g[(int64_t)(r0 + r) * kD + d])
                                  : 0.f;
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

template <typename T, bool kProbs>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
        if (kProbs) p = round_to<T>(p);
        pt[(tx * 4 + j) * kLd + ty * 4 + i] = p;
      }
    }
    __syncthreads();
    mma_4x4(pt, ty * 4, vs, tx * 4, acc);
  }
  T* ob = o + base_q;
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
template <typename T, bool kProbs, bool kAcc>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ seed_pack, const Bias bias,
                 T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dq_part, int64_t tiles_per_bh,
                 float* __restrict__ dq_run, int* __restrict__ turns,
                 T* __restrict__ dq, int fault, float* __restrict__ dbias,
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
        if (kProbs) {
          pd = round_to<T>(pd);
          ds = round_to<T>(ds);
        }
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
        T* const out = dq + ((int64_t)bh * sq + q0 + r) * kD + tx * 4;
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
// added in key order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ dq_part, T* __restrict__ dq,
                int sq, int sk, int causal, int64_t tiles_per_bh) {
  const int bh = blockIdx.y;
  const int qb = blockIdx.x;
  const int nk = (sk + kB - 1) / kB;
  const int kend = causal ? min(nk, qb + 1) : nk;
  const float* base = dq_part + (int64_t)bh * tiles_per_bh * (kB * kD);
  for (int e = threadIdx.x; e < kB * kD; e += kThreads) {
    const int row = qb * kB + e / kD;
    if (row >= sq) break;
    float acc = 0.f;
    for (int kb = 0; kb < kend; ++kb)
      acc += base[tile_index(qb, kb, nk, causal) * (kB * kD) + e];
    store_f32(dq + ((int64_t)bh * sq + row) * kD + e % kD, acc);
  }
}

constexpr size_t kFwdSmem = 4 * kTile * sizeof(float);
constexpr size_t kBwdSmem = (10 * kTile + 2 * kB) * sizeof(float);

// probs_bf16 is a template argument, so the option costs the kernels
// without it nothing; fp32 instantiates only kProbs = false, the rounding
// being the identity there.
template <typename T, bool kProbs>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* seed, const Bias& bias, int bh, int sq,
               int sk, int h_local, int h_total, float scale, int causal,
               float rate, uint32_t thresh, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kProbs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kB - 1) / kB, bh);
  flash_fwd_kernel<T, kProbs><<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seed, bias, sq, sk,
      h_local, h_total, scale, causal, rate, thresh);
  return static_cast<int>(cudaGetLastError());
}

// The combined backward, then (partials only) the key-order dq sum.
template <typename T, bool kProbs, bool kAcc>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* seed,
               const Bias& bias, void* dq, void* dk, void* dv,
               float* dq_part, long long tiles_per_bh, float* dq_run,
               int* turns, int fault, float* dbias, int bh, int sq, int sk,
               int h_local, int h_total, float scale, int causal, float rate,
               uint32_t thresh, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_kernel<T, kProbs, kAcc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (sq + kB - 1) / kB;
  if (kAcc) {
    // the turn counters and the ticket start at 0 on every launch
    e = cudaMemsetAsync(turns, 0, ((size_t)bh * nq + 1) * sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid_k((sk + kB - 1) / kB, bh);
  flash_bwd_kernel<T, kProbs, kAcc><<<grid_k, kThreads, kBwdSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      seed, bias, static_cast<T*>(dk), static_cast<T*>(dv), dq_part,
      tiles_per_bh, dq_run, turns, static_cast<T*>(dq), fault, dbias, sq, sk,
      h_local, h_total, scale, causal, rate, thresh);
  e = cudaGetLastError();
  if (e != cudaSuccess || kAcc) return static_cast<int>(e);
  const dim3 grid_q(nq, bh);
  flash_dq_kernel<T><<<grid_q, kThreads, 0, s>>>(
      dq_part, static_cast<T*>(dq), sq, sk, causal, tiles_per_bh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tiles of the dq partials buffer per batch*head: the buffer holds
// bh * tiles * 64 * 64 floats.
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

// q: (bh, sq, 64), k/v: (bh, sk, 64), o like q, lse: (bh, sq) fp32;
// dtype 0 = float32, 1 = bfloat16.  seed: device int32[4] = [seed, row
// offset, col offset, head offset]; thresh = (1 - rate) * 2^32 clamped;
// probs_bf16 1 rounds each tile's probabilities to the input dtype before
// p.V.  Returns cudaGetLastError().
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, const int* seed,
                              const void* bias, int bias_dtype, int bias_h,
                              long long bias_sb, long long bias_sr, int bh,
                              int sq, int sk, int h_local, int h_total,
                              float scale, int causal, float rate,
                              unsigned int thresh, int probs_bf16, int dtype,
                              void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bias != nullptr && (bias_dtype < 0 || bias_dtype > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias b = make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr);
  if (dtype == 0)
    return launch_fwd<float, false>(q, k, v, o, lse, seed, b, bh, sq, sk,
                                    h_local, h_total, scale, causal, rate,
                                    thresh, s);
  if (dtype == 1)
    return (probs_bf16 ? launch_fwd<__nv_bfloat16, true>
                       : launch_fwd<__nv_bfloat16, false>)(
        q, k, v, o, lse, seed, b, bh, sq, sk, h_local, h_total, scale,
        causal, rate, thresh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dout like q; lse, delta: (bh, sq) fp32 (delta = rowsum(dout * o));
// the bias as for apex_flash_fwd; dq, dk, dv like q, k, v; dq_part: fp32
// scratch of bh * apex_flash_dq_tiles(...) * 64 * 64; dbias: null, or an
// fp32 (bh, sq, sk) output that every element of is written; probs_bf16 1
// rounds pd and ds to the input dtype before their products.  Returns
// cudaGetLastError().
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const int* seed,
                              const void* bias, int bias_dtype, int bias_h,
                              long long bias_sb, long long bias_sr, void* dq,
                              void* dk, void* dv, float* dq_part,
                              float* dbias, int bh, int sq, int sk,
                              int h_local, int h_total, float scale,
                              int causal, float rate, unsigned int thresh,
                              int probs_bf16, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if (bias != nullptr && (bias_dtype < 0 || bias_dtype > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias b = make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr);
  const long long tiles = apex_flash_dq_tiles(sq, sk, causal);
  if (dtype == 0)
    return launch_bwd<float, false, false>(
        q, k, v, dout, lse, delta, seed, b, dq, dk, dv, dq_part, tiles,
        nullptr, nullptr, 0, dbias, bh, sq, sk, h_local, h_total, scale,
        causal, rate, thresh, s);
  if (dtype == 1)
    return (probs_bf16 ? launch_bwd<__nv_bfloat16, true, false>
                       : launch_bwd<__nv_bfloat16, false, false>)(
        q, k, v, dout, lse, delta, seed, b, dq, dk, dv, dq_part, tiles,
        nullptr, nullptr, 0, dbias, bh, sq, sk, h_local, h_total, scale,
        causal, rate, thresh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Floats of the running dq buffer of apex_flash_bwd_acc (one 64 x 64
// tile per (bh, query tile)) and ints of its turn counters (one per
// (bh, query tile), then the ticket).
extern "C" long long apex_flash_acc_floats(int bh, int sq) {
  return (long long)bh * ((sq + kB - 1) / kB) * kB * kD;
}
extern "C" long long apex_flash_acc_turns(int bh, int sq) {
  return (long long)bh * ((sq + kB - 1) / kB) + 1;
}

// The combined backward with dq accumulated in key order: arguments as
// for apex_flash_bwd without dq_part and dbias; dq_run: fp32 scratch of
// apex_flash_acc_floats(bh, sq) (any contents: it is written before it
// is read); turns: int32 scratch of apex_flash_acc_turns(bh, sq), zeroed
// here on the stream; fault: 0, or a planted error for the checks (1: key
// tile 1's contribution dropped, 2: key order reversed).  Returns
// cudaGetLastError().
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
                                  int fault, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  if ((bias != nullptr && (bias_dtype < 0 || bias_dtype > 1)) || fault < 0 ||
      fault > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias b = make_bias(bias, bias_dtype, bias_h, bias_sb, bias_sr);
  if (dtype == 0)
    return launch_bwd<float, false, true>(
        q, k, v, dout, lse, delta, seed, b, dq, dk, dv, nullptr, 0, dq_run,
        turns, fault, nullptr, bh, sq, sk, h_local, h_total, scale, causal,
        rate, thresh, s);
  if (dtype == 1)
    return (probs_bf16 ? launch_bwd<__nv_bfloat16, true, true>
                       : launch_bwd<__nv_bfloat16, false, true>)(
        q, k, v, dout, lse, delta, seed, b, dq, dk, dv, nullptr, 0, dq_run,
        turns, fault, nullptr, bh, sq, sk, h_local, h_total, scale, causal,
        rate, thresh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
