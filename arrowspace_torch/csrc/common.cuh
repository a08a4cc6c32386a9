// Shared definitions of the arrowspace_torch CUDA kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes), launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// float32 lowest finite value: the empty-slot score of every pool.
#define ASP_NEG_INF (-3.4028234663852886e38f)
#define ASP_INT_MAX 2147483647
#define ASP_FULL_MASK 0xffffffffu

// Score of one (query, item) pair on the SHIFTED scale: dot is α·cos
// (queries arrive α-prescaled), and c1 = 1 - α.  The explicit roundings
// keep the compiler from fusing the product into the subtraction, so the
// λ term rounds exactly as the PyTorch expression acos - c1·min(|Δλ|, 1).
__device__ __forceinline__ float asp_shifted_score(float dot, float ql,
                                                   float xl, float c1) {
  const float dl = fminf(fabsf(__fsub_rn(ql, xl)), 1.0f);
  return __fsub_rn(dot, __fmul_rn(c1, dl));
}

// ---- exact order statistics of one row, one warp per row ----
//
// Lane l holds the row's values l, l+32, ... as sortable ints (y[m] for
// m < nv, non-finite values mapped to +inf's pattern, lanes past F to
// INT32_MAX).  The order statistic is found by bisection over the int
// range, 32 ballot passes, so it returns an element of the row exactly
// as a sort would: median and percentile τ equal the sort path bitwise.
// Shared by K2 (taulambda.cu) and K4 (select_tau.cu).

#define ASP_TAU_FLOOR 1e-10f

// Monotone map float -> int: signed int order equals float order.
__device__ __forceinline__ int asp_to_sortable(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? i ^ 0x7FFFFFFF : i;
}

__device__ __forceinline__ float asp_from_sortable(int y) {
  return __int_as_float(y < 0 ? y ^ 0x7FFFFFFF : y);
}

template <int NV>
__device__ __forceinline__ int asp_warp_count_le(const int (&y)[NV], int nv,
                                                 int mid) {
  int cnt = 0;
#pragma unroll
  for (int m = 0; m < NV; ++m)
    if (m < nv) cnt += __popc(__ballot_sync(ASP_FULL_MASK, y[m] <= mid));
  return cnt;
}

// Smallest sortable value v with count(y <= v) >= rank1: the rank1-th
// smallest element (lanes past F hold INT32_MAX and never count short).
template <int NV>
__device__ int asp_bisect_order_stat(const int (&y)[NV], int nv, int rank1) {
  int lo = INT32_MIN, hi = INT32_MAX;
  for (int it = 0; it < 32; ++it) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    if (asp_warp_count_le<NV>(y, nv, mid) >= rank1)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// τ of one row held as y (see above) with m_count finite values: kind 0
// the median (mean of the two middle elements when m_count is even),
// kind 1 the percentile pct (rank round((m-1)·pct) in float32, as
// taumode.select_tau_sorted computes it); TAU_FLOOR for a row with no
// finite value, and floored at TAU_FLOOR.  Every lane returns it.
template <int NV>
__device__ float asp_warp_order_tau(const int (&y)[NV], int nv, int m_count,
                                    int F, int kind, float pct) {
  float tau;
  if (kind == 1) {
    const float pos = __fadd_rn(__fmul_rn((float)(m_count - 1), pct), 0.5f);
    int idx = (int)floorf(pos);
    idx = min(max(idx, 0), F - 1);
    const int vsel = asp_bisect_order_stat<NV>(y, nv, idx + 1);
    tau = m_count > 0 ? asp_from_sortable(vsel) : ASP_TAU_FLOOR;
  } else {
    const int m1 = max(m_count, 1);
    const int lo_r = min(max((m1 - 1) / 2, 0), F - 1);
    const int hi_r = min(max(m1 / 2, 0), F - 1);
    const int v_lo = asp_bisect_order_stat<NV>(y, nv, lo_r + 1);
    const int cnt_lo = asp_warp_count_le<NV>(y, nv, v_lo);
    int nxt = INT32_MAX;
#pragma unroll
    for (int m = 0; m < NV; ++m)
      if (m < nv && y[m] > v_lo) nxt = min(nxt, y[m]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      nxt = min(nxt, __shfl_xor_sync(ASP_FULL_MASK, nxt, off));
    const int v_hi = cnt_lo < hi_r + 1 ? nxt : v_lo;
    const float med = __fmul_rn(
        0.5f, __fadd_rn(asp_from_sortable(v_lo), asp_from_sortable(v_hi)));
    tau = m_count > 0 ? med : ASP_TAU_FLOOR;
  }
  return fmaxf(tau, ASP_TAU_FLOOR);
}

__device__ __forceinline__ float asp_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(ASP_FULL_MASK, v, off);
  return v;
}

// ---- synthetic λ of item rows against a graph L (n×n) ----
//
// Shared by K2 (taulambda.cu, τ + λ) and K5 (lambda_batch.cu, λ given τ),
// whose five quadratic forms run on the tensor cores (lambda_tile.cuh).

#define ASP_DENOM_EPS 1e-12f

// den = xᵀx over the full row; s_part = x²·d_r + x²·d_c and ta =
// x⁴·d2_r + x⁴·d2_c over xₙ; num, xwx, tb, tc, td the quadratic forms.
__device__ __forceinline__ float asp_lambda_of(float tau, float den,
                                               float s_part, float ta,
                                               float num, float xwx,
                                               float tb, float tc,
                                               float td) {
  const float e_raw =
      den > ASP_DENOM_EPS ? num / fmaxf(den, ASP_DENOM_EPS) : 0.0f;
  const float s = s_part - 2.0f * xwx;
  const float g_num = ta + 6.0f * tb - 4.0f * tc - 4.0f * td;
  float g = s > 0.0f ? g_num / fmaxf(s * s, ASP_DENOM_EPS) : 0.0f;
  g = fminf(fmaxf(g, 0.0f), 1.0f);
  return tau * (e_raw / (e_raw + tau)) + (1.0f - tau) * g;
}

// Sets the dynamic shared-memory ceiling of a kernel when it needs more
// than the default 48 KB.
template <typename Kernel>
__host__ inline cudaError_t asp_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
