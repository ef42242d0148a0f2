// Tensor-core and async-copy building blocks shared by the kernels that
// run bf16 products on the H100's tensor cores (conv_bn.cu,
// flash_attention.cu, paged_attention.cu): mma.sync m16n8k16 with fp32
// accumulation, its ldmatrix operand loads, cp.async copies into shared
// memory, and the 64 x 64 attention-tile steps built on them.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row): register 0 holds row g, columns 2t and 2t + 1;
//   register 1 row g + 8; registers 2 and 3 the same rows at columns
//   8 + 2t and 8 + 2t + 1 (two bf16 a register, the lower column in the
//   low half);
// - B (16 x 8, col): register 0 holds rows 2t and 2t + 1 of column g,
//   register 1 rows 8 + 2t and 8 + 2t + 1;
// - C/D (16 x 8, fp32): c[0], c[1] at row g, columns 2t and 2t + 1;
//   c[2], c[3] at row g + 8.
// So the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are the A fragment of a k16 step: a product's result feeds the next
// product from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// c += a . b on the tensor cores: bf16 operands, fp32 accumulation; b is
// the B fragment's registers 0 and 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register q of every lane then holds row
// lane / 4, columns 2 * (lane % 4) and + 1, of matrix q — the layout of
// the mma.sync fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same, each matrix transposed: register q of every lane holds rows
// 2 * (lane % 4) and + 1, column lane / 4, of matrix q.  A matrix stored
// [k][n] (n contiguous) so gives the B fragment of its k x n product.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two floats as a bf16 pair (x in the low half), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x and y split into bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi).
// x - hi is exact in fp32, so hi + lo is x to within 2^-16 of |x| (the
// rounding of lo, itself at most 2^-8 of |x|).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// The same for 4 bytes.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Attention tiles of 64 query rows x 64 keys, 4 warps of 16 rows each
// (flash_attention.cu, paged_attention.cu).  A staged tile is [64][D]
// bf16 in rows of D + 8 elements (16 bytes of padding: the 8 rows one
// ldmatrix reads fall in distinct banks); a warp's 16 x 64 fp32 scores
// or probabilities are the mma accumulators x[8][4].
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * kLog2e)

template <int D>
constexpr int kLdOf = D + 8;

// The A fragments of k16 step kk (columns 16 kk .. 16 kk + 15) of a
// 16 x 64 fp32 accumulator tile x[8][4]: rounded to bf16 (hi), and with
// kSplit the residual too (lo).
template <bool kSplit>
__device__ __forceinline__ void a_frag(const float (&x)[8][4], int kk,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* c = x[2 * kk + (i >> 1)] + 2 * (i & 1);
    if (kSplit)
      split_bf16(c[0], c[1], hi[i], lo[i]);
    else
      hi[i] = pack_bf16(c[0], c[1]);
  }
}

// acc (16 x D, this warp's rows) += (hi + lo) (16 x 16) . rows
// [16 kk, 16 kk + 16) of a staged [k][D] tile; without kSplit, hi alone.
template <int D, bool kSplit>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         const __nv_bfloat16* tile, int kk) {
  const int lane = threadIdx.x % 32, lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (kk * 16 + (lm & 1) * 8 + lr) * kLdOf<D> +
                             dp * 16 + (lm >> 1) * 8);
    mma_bf16(acc[2 * dp], hi, r[0], r[1]);
    mma_bf16(acc[2 * dp + 1], hi, r[2], r[3]);
    if (kSplit) {
      mma_bf16(acc[2 * dp], lo, r[0], r[1]);
      mma_bf16(acc[2 * dp + 1], lo, r[2], r[3]);
    }
  }
}

// s (16 x 64) += a rows (16 x D, fragments af) . b^T, with b a staged
// [64][D] tile: the scores of this warp's 16 rows against the tile's 64.
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[8][4],
                                           const uint32_t (&af)[4],
                                           const __nv_bfloat16* b, int kk) {
  const int lane = threadIdx.x % 32, lm = lane / 8, lr = lane % 8;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t r[4];
    ldmatrix_x4(r, b + (np * 16 + (lm >> 1) * 8 + lr) * kLdOf<D> + kk * 16 +
                       (lm & 1) * 8);
    mma_bf16(s[2 * np], af, r[0], r[1]);
    mma_bf16(s[2 * np + 1], af, r[2], r[3]);
  }
}

// The A fragment of rows [r0, r0 + 16), k16 step kk, of a staged tile.
template <int D>
__device__ __forceinline__ void a_rows(uint32_t (&af)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int kk) {
  const int lane = threadIdx.x % 32, lm = lane / 8, lr = lane % 8;
  ldmatrix_x4(af, tile + (r0 + (lm & 1) * 8 + lr) * kLdOf<D> + kk * 16 +
                      (lm >> 1) * 8);
}

// 2^x by the SFU, subnormal results flushed to 0 (p below 2^-126 of the
// row's largest moves no output).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
