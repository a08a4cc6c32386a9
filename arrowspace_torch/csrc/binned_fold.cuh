// What the tensor-core kernels share: K1 (bintopk.cu, λ-aware cosine
// score), K6/K7 (the energy tile, energy_tile.cuh), K3 (merge_topk.cu,
// the exact merge top-k of K1's score) and the λ body of K2 and K5
// (lambda_tile.cuh).  K1, K6 and K7 keep, per (query, bin), a running
// top-DEPTH in registers where their tensor-core accumulators are; K3
// keeps each query's top-k in shared memory.  This header holds the
// pieces they have in common:
// - the staging of a tile's feature slice into shared memory by cp.async
//   (stage_slice for a bin tile of the corpus, stage_rows for any run of
//   rows), two buffers a kernel, one barrier a step;
// - the 3×TF32 product on the tensor cores (mma_kstep): mma.sync m16n8k8
//   TF32, every fp32 value v split in registers into hi = rna(v) and
//   lo = rna(v - hi), and lo·hi, hi·lo, hi·hi accumulated in fp32 at each
//   8-feature k-step.  One TF32 product keeps 11 significant bits; the
//   split keeps float32's accuracy (within 1e-5 of the plain version at
//   the serving shapes), and every column runs the same instruction
//   sequence, so identical corpus rows get bitwise identical dot products.
// - K1's and K3's bf16 mode (mma_kstep_bf16): mma.sync m16n8k16 bf16
//   with fp32 accumulation, one product per 16 features and no split
//   (every product of two bf16 values is exact in fp32), on slices staged
//   as bf16 (stage_slice / stage_rows on __nv_bfloat16: 16-byte copies of
//   8 values, rows of 64 features at a stride of 72 bf16, 36 32-bit words
//   ≡ 4 mod 8, so fragment loads are as free of bank conflicts as at 68
//   floats).  cp.async copies 4, 8 or 16 bytes, never 2, so bf16 operands
//   come with F a multiple of 8 and 16-byte aligned rows (the wrappers
//   zero-pad and check).
// The tensor core's accumulate truncates rather than rounds, so a kernel
// sums a bounded run of k-steps into a zeroed partial and folds it into
// its running dot product with one rounded fp32 add.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace asp_fold {

constexpr int kThreads = 256;
// The tensor-core kernels' slice: 64 features at a row stride of 68
// floats (≡ 4 mod 8: lane (g, t) of a fragment load reads bank 4g + t).
constexpr int kTileFK = 64;
constexpr int kTileXS = 68;

// What a k-step of each operand type takes: float32 (3×TF32) or bf16.
// kStep features a k-step; kPad elements of row padding of a staged slice
// or query block (a row stride ≡ 4 mod 8 32-bit words); kLane elements
// between the fragment columns of lanes t and t + 1.
template <typename T>
struct Operand;
template <>
struct Operand<float> {
  static constexpr int kStep = 8, kPad = 4, kLane = 1;
};
template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kStep = 16, kPad = 8, kLane = 2;
};

// The row stride of a staged 64-feature slice of T (68 floats, 72 bf16).
template <typename T>
__host__ __device__ constexpr int tile_stride() {
  return kTileFK + Operand<T>::kPad;
}

// Features staged per step, and the row stride of a staged slice in
// elements (padding keeps fragment and 16-byte reads conflict-free).
template <int BINS>
__host__ __device__ constexpr int slice_features() {
  return BINS >= 512 ? 32 : 64;
}
template <int BINS, typename T = float>
__host__ __device__ constexpr int slice_stride() {
  return slice_features<BINS>() + Operand<T>::kPad;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Issues the copy of rows g0 .. g0+BINS-1, features f0 .. f0+FK-1 into
// dst[BINS][XS]; features at or past F are stored as zeros.  vec: F is a
// multiple of 4 and the corpus is 16-byte aligned, so whole float4s are
// copied.
template <int BINS>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ xrows,
                                            int64_t g0, int F, int f0,
                                            bool vec, int tid) {
  constexpr int kXS = slice_stride<BINS, float>();
  constexpr int kC4 = slice_features<BINS>() / 4;
  for (int idx = tid; idx < BINS * kC4; idx += kThreads) {
    const int b = idx / kC4, c = idx % kC4;
    const int f = f0 + 4 * c;
    float* d = dst + b * kXS + 4 * c;
    const float* src = xrows + (g0 + b) * F + f;
    if (vec) {
      if (f < F)
        cp_async16(d, src);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (f + e < F)
          cp_async4(d + e, src + e);
        else
          d[e] = 0.0f;
      }
    }
  }
}

// The same for bf16 rows (F a multiple of 8, rows 16-byte aligned): 8
// values a 16-byte copy, into dst[BINS][slice_stride<BINS, bf16>].
template <int BINS>
__device__ __forceinline__ void stage_slice(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ xrows, int64_t g0,
    int F, int f0, bool /*vec*/, int tid) {
  constexpr int kXS = slice_stride<BINS, __nv_bfloat16>();
  constexpr int kC8 = slice_features<BINS>() / 8;
  for (int idx = tid; idx < BINS * kC8; idx += kThreads) {
    const int b = idx / kC8, c = idx % kC8;
    const int f = f0 + 8 * c;
    __nv_bfloat16* d = dst + b * kXS + 8 * c;
    if (f < F)
      cp_async16(d, xrows + (g0 + b) * F + f);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Issues the copy of rows r0 .. r0+ROWS-1 of a row-major (·, F) matrix,
// features f0 .. f0+kTileFK-1, into dst[ROWS][kTileXS]; rows at or past
// r_end and features at or past F are stored as zeros.  vec: F is a
// multiple of 4 and the rows are 16-byte aligned.  The energy tile stages
// its query slices with it, K3 both its query and its corpus slices, the
// λ body the slices of L, W and W2.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int r_end, int F, int f0,
                                           bool vec, int tid) {
  constexpr int kC4 = kTileFK / 4;
  for (int idx = tid; idx < ROWS * kC4; idx += kThreads) {
    const int r = idx / kC4, c = idx % kC4;
    const int f = f0 + 4 * c;
    float* d = dst + r * kTileXS + 4 * c;
    const bool live = r0 + r < r_end;
    const float* s = src + (size_t)(r0 + r) * F + f;
    if (vec) {
      if (live && f < F)
        cp_async16(d, s);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (live && f + e < F)
          cp_async4(d + e, s + e);
        else
          d[e] = 0.0f;
      }
    }
  }
}

// The same for bf16 rows (F a multiple of 8, rows 16-byte aligned), into
// dst[ROWS][tile_stride<bf16>()].
template <int ROWS>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int r0,
    int r_end, int F, int f0, bool /*vec*/, int tid) {
  constexpr int kXS = tile_stride<__nv_bfloat16>();
  constexpr int kC8 = kTileFK / 8;
  for (int idx = tid; idx < ROWS * kC8; idx += kThreads) {
    const int r = idx / kC8, c = idx % kC8;
    const int f = f0 + 8 * c;
    __nv_bfloat16* d = dst + r * kXS + 8 * c;
    if (r0 + r < r_end && f < F)
      cp_async16(d, src + (size_t)(r0 + r) * F + f);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// cvt.rna.tf32.f32 for finite v (every value the kernels read is): round
// to the nearest 10-bit mantissa, ties away from zero.  Two integer
// instructions, where the cvt compiles to about five (it also handles NaN
// and inf).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a · b on one m16n8k8 tile; a row-major 16×8, b column-major 8×8.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 8 features for a warp's 16 queries × 8·NT bins: qa points
// at the thread's A element (query g, feature t) in rows of stride QS, xb
// at its B element (bin g of n-tile 0, feature t) in a staged slice.
template <int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4],
                                          const float* qa, int QS,
                                          const float* xb) {
  uint32_t ahi[4], alo[4];
  split_tf32(qa[0], ahi[0], alo[0]);           // (g,     t)
  split_tf32(qa[8 * QS], ahi[1], alo[1]);      // (g + 8, t)
  split_tf32(qa[4], ahi[2], alo[2]);           // (g,     t + 4)
  split_tf32(qa[8 * QS + 4], ahi[3], alo[3]);  // (g + 8, t + 4)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* xj = xb + j * 8 * kTileXS;
    uint32_t bhi0, blo0, bhi1, blo1;
    split_tf32(xj[0], bhi0, blo0);             // (k = t,     n = g)
    split_tf32(xj[4], bhi1, blo1);             // (k = t + 4, n = g)
    mma_tf32(acc[j], alo, bhi0, bhi1);
    mma_tf32(acc[j], ahi, blo0, blo1);
    mma_tf32(acc[j], ahi, bhi0, bhi1);
  }
}

// d += a · b on one m16n8k16 tile of bf16, fp32 accumulation; a
// row-major 16×16, b column-major 16×8.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive bf16 values, the lower index in the low half.
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One k-step of 16 features for a warp's 16 queries × 8·NT bins, bf16
// operands: qa points at the thread's A pair (query g, features 2t and
// 2t + 1) in rows of stride QS, xb at its B pair (bin g of n-tile 0,
// features 2t and 2t + 1) in a staged slice of stride tile_stride<bf16>.
template <int NT>
__device__ __forceinline__ void mma_kstep_bf16(float (&acc)[NT][4],
                                               const __nv_bfloat16* qa,
                                               int QS,
                                               const __nv_bfloat16* xb) {
  constexpr int kXS = tile_stride<__nv_bfloat16>();
  uint32_t a[4];
  a[0] = bf16_pair(qa);               // (g,     2t)
  a[1] = bf16_pair(qa + 8 * QS);      // (g + 8, 2t)
  a[2] = bf16_pair(qa + 8);           // (g,     2t + 8)
  a[3] = bf16_pair(qa + 8 * QS + 8);  // (g + 8, 2t + 8)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const __nv_bfloat16* xj = xb + j * 8 * kXS;
    mma_bf16(acc[j], a, bf16_pair(xj), bf16_pair(xj + 8));  // k = 2t, 2t + 8
  }
}

// The k-step of each operand type, for kernels templated on it.
template <int NT>
__device__ __forceinline__ void kstep(float (&acc)[NT][4], const float* qa,
                                      int QS, const float* xb) {
  mma_kstep<NT>(acc, qa, QS, xb);
}
template <int NT>
__device__ __forceinline__ void kstep(float (&acc)[NT][4],
                                      const __nv_bfloat16* qa, int QS,
                                      const __nv_bfloat16* xb) {
  mma_kstep_bf16<NT>(acc, qa, QS, xb);
}

}  // namespace asp_fold
