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
// Lane l holds some of the row's values as sortable ints y[m]: which ones
// does not matter, since only counts, minima and maxima are taken.  A
// finite value v is held as asp_to_sortable(v); a non-finite value and a
// slot past the row hold ASP_NO_VALUE, above every finite value's int.
//
// The order statistic is a radix select over the row's finite range
// [lo, hi] (warp reductions after the load) on the offsets u = y - lo:
// 8-bit digits from the range's top bit down, at most 4 passes (none for
// a constant row).  A pass counts the candidates (the offsets that match
// the digits found so far) into this warp's 256 counters in shared
// memory, and a warp scan picks the digit holding the rank; when the
// rank is the smallest or largest of its digit's candidates, one warp
// min or max ends it.  So it returns an element of the row exactly as a
// sort would: median and percentile τ equal the sort path bitwise.
// Counting takes integer compares and shared-memory adds, never a
// ballot and popc per value.  Shared by K2 (taulambda.cu) and K4
// (select_tau.cu).

#define ASP_TAU_FLOOR 1e-10f
#define ASP_NO_VALUE ASP_INT_MAX
// The offset of a slot that holds no value: its top byte (0xFF) is above
// every held offset's, since a finite range is below 0xFF000000.
#define ASP_NO_OFFSET 0xFFFFFFFFu

// Monotone map float -> int: signed int order equals float order.
__device__ __forceinline__ int asp_to_sortable(float v) {
  const int i = __float_as_int(v);
  return i < 0 ? i ^ 0x7FFFFFFF : i;
}

__device__ __forceinline__ float asp_from_sortable(int y) {
  return __int_as_float(y < 0 ? y ^ 0x7FFFFFFF : y);
}

// The slot value of v: its sortable int if finite, else ASP_NO_VALUE.
__device__ __forceinline__ int asp_tau_key(float v) {
  return isfinite(v) ? asp_to_sortable(v) : ASP_NO_VALUE;
}

// The row's finite count and the least and greatest finite sortable
// values (ASP_NO_VALUE and INT32_MIN when there is none), on every lane.
template <int NV>
__device__ __forceinline__ void asp_row_range(const int (&y)[NV], int& count,
                                              int& lo, int& hi) {
  int c = 0, mn = ASP_NO_VALUE, mx = INT32_MIN;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const bool held = y[m] != ASP_NO_VALUE;
    c += held;
    mn = min(mn, y[m]);
    mx = held ? max(mx, y[m]) : mx;
  }
  count = __reduce_add_sync(ASP_FULL_MASK, c);
  lo = __reduce_min_sync(ASP_FULL_MASK, mn);
  hi = __reduce_max_sync(ASP_FULL_MASK, mx);
}

// The (k+1)-th smallest held offset, 0 <= k < (held offsets), of a row
// whose held offsets span [0, range]; hist is this warp's 256 counters
// in shared memory (16-byte aligned).  Every lane returns it.
template <int NV>
__device__ unsigned asp_radix_select(const unsigned (&u)[NV], unsigned k,
                                     unsigned range, unsigned* hist) {
  if (range == 0) return 0;
  const int lane = threadIdx.x & 31;
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  // bits shift .. shift+7 form a pass's digit (the first pass's hold the
  // range's top bit); ans holds the answer's bits prev .. 31
  int shift = max(0, 24 - __clz(range)), prev = 32;
  unsigned ans = 0, rank = k;
  for (;;) {
    h4[2 * lane] = make_uint4(0, 0, 0, 0);
    h4[2 * lane + 1] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    // a candidate's t is its digit, below lim; any other offset's t is
    // lim or more, but for the first pass at shift 24, where a slot with
    // no value lands in digit 255, above every held offset's
    const unsigned lim = 1u << min(prev - shift, 8);
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const unsigned t = (u[m] ^ ans) >> shift;
      if (t < lim) atomicAdd(&hist[t], 1u);
    }
    __syncwarp();
    // lane l scans digits 8l .. 8l+7
    const uint4 a = h4[2 * lane], b = h4[2 * lane + 1];
    const unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned tot = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) tot += c[j];
    unsigned incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned s = __shfl_up_sync(ASP_FULL_MASK, incl, off);
      if (lane >= off) incl += s;
    }
    unsigned below = incl - tot, digit = 0, cnt = 0;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found && below + c[j] > rank) {
        digit = 8 * lane + j;
        cnt = c[j];
        found = true;
      } else if (!found) {
        below += c[j];
      }
    }
    // the owner is the lowest lane that found the rank (later lanes
    // "find" it in their first digit)
    const int src = __ffs(__ballot_sync(ASP_FULL_MASK, found)) - 1;
    digit = __shfl_sync(ASP_FULL_MASK, digit, src);
    below = __shfl_sync(ASP_FULL_MASK, below, src);
    cnt = __shfl_sync(ASP_FULL_MASK, cnt, src);
    ans |= digit << shift;
    prev = shift;
    rank -= below;
    if (shift == 0) return ans;
    if (rank == 0 || rank + 1 == cnt) {   // the digit's least or greatest
      const bool least = rank == 0;
      unsigned best = least ? ASP_NO_OFFSET : 0u;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const bool cand = ((u[m] ^ ans) >> prev) == 0;
        best = !cand ? best : least ? min(best, u[m]) : max(best, u[m]);
      }
      return least ? __reduce_min_sync(ASP_FULL_MASK, best)
                   : __reduce_max_sync(ASP_FULL_MASK, best);
    }
    shift = max(shift - 8, 0);
  }
}

// τ of one row held as y (see above): kind 0 the median (mean of the two
// middle elements when the finite count m is even), kind 1 the
// percentile pct in [0, 1] (rank round((m-1)·pct) in float32, as
// taumode.select_tau_sorted computes it); TAU_FLOOR for a row with no
// finite value, and floored at TAU_FLOOR.  Every lane returns it.
template <int NV>
__device__ float asp_warp_order_tau(const int (&y)[NV], int kind, float pct,
                                    unsigned* hist) {
  int m, lo, hi;
  asp_row_range<NV>(y, m, lo, hi);
  if (m == 0) return ASP_TAU_FLOOR;
  unsigned u[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    u[i] = y[i] != ASP_NO_VALUE ? (unsigned)y[i] - (unsigned)lo
                                : ASP_NO_OFFSET;
  const unsigned range = (unsigned)hi - (unsigned)lo;
  float tau;
  if (kind == 1) {
    const float pos = __fadd_rn(__fmul_rn((float)(m - 1), pct), 0.5f);
    const int idx = min(max((int)floorf(pos), 0), m - 1);
    const unsigned o = asp_radix_select<NV>(u, idx, range, hist);
    tau = asp_from_sortable((int)((unsigned)lo + o));
  } else {
    const unsigned lo_r = (m - 1) / 2;
    const unsigned o_lo = asp_radix_select<NV>(u, lo_r, range, hist);
    unsigned o_hi = o_lo;
    if (m % 2 == 0) {   // the next element: o_lo again, or the next offset
      unsigned le = 0, nxt = ASP_NO_OFFSET;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        le += u[i] <= o_lo;
        nxt = u[i] > o_lo ? min(nxt, u[i]) : nxt;
      }
      le = __reduce_add_sync(ASP_FULL_MASK, le);
      nxt = __reduce_min_sync(ASP_FULL_MASK, nxt);
      o_hi = le >= lo_r + 2 ? o_lo : nxt;
    }
    tau = __fmul_rn(0.5f,
                    __fadd_rn(asp_from_sortable((int)((unsigned)lo + o_lo)),
                              asp_from_sortable((int)((unsigned)lo + o_hi))));
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
