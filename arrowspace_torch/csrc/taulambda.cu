// K2: fused τ + λ in one pass over the item rows.
//
// Replaces arrowspace_tpu/ops/pallas_taulambda.py fused_taulambda_batch
// (pallas_call :151, body _kernel :33; τ from pallas_tau._tau_rows :305,
// bisect layout, _bisect_order_stat :190).
//
// What it computes, per item row x (F values) against the graph L (n×n,
// n <= F), W = max(-L, 0) off the diagonal, W2 = W∘W and their row and
// column sums d_r, d_c, d2_r, d2_c:
//   τ  = the exact order statistic of the row's finite values (median,
//        percentile, mean or fixed), floored at TAU_FLOOR;
//   E  = xₙᵀLxₙ / xᵀx                     (0 when xᵀx <= 1e-12)
//   S  = x²·d_r + x²·d_c - 2·xₙᵀWxₙ
//   G  = clamp((x⁴·d2_r + x⁴·d2_c + 6·x²ᵀW2x² - 4·xᵀW2x³ - 4·x³ᵀW2x)/S², 0, 1)
//   λ  = τ·E/(E+τ) + (1-τ)·G
//
// What bounds it on an H100: the five quadratic forms, 5·n² FMAs per row
// (82 GFMA at 1M×128), on the fp32 CUDA cores; L, W and W2 together are
// 192 KB at n=128, too much to keep beside an item tile in one block's
// shared memory.  What the design does about it: a CTA stages 128 item
// rows once and streams the three matrices through shared memory in
// 32-column panels, so each panel feeds all 128 rows; each thread holds a
// 4-row × 4-column register tile of the five matrix-vector products (12
// shared loads for 80 FMAs a step).  τ is a warp-per-row bisection over
// the sortable-int value range (32 ballot passes), exact like the sort,
// so the median and percentile equal select_tau_batch bitwise.  The τ
// selection and the λ body (panel products, λ formula) live in
// common.cuh: K4 shares the first, K5 (lambda_batch.cu) the second.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;       // item rows per CTA
constexpr int kPanel = 32;       // graph columns per staged panel
constexpr int kMaxLane = 8;      // row values per lane: F <= 256

__global__ void __launch_bounds__(kThreads)
    taulambda_kernel(const float* __restrict__ x, const float* __restrict__ L,
                     const float* __restrict__ W, const float* __restrict__ W2,
                     const float* __restrict__ d_r,
                     const float* __restrict__ d_c,
                     const float* __restrict__ d2_r,
                     const float* __restrict__ d2_c, int N, int F, int n,
                     int kind, float pct, float fixed,
                     float* __restrict__ lam_out,
                     float* __restrict__ tau_out) {
  extern __shared__ float smem[];
  const int xstride = F + 1;
  float* xs = smem;                                // [kRows][F + 1]
  float* lp = xs + kRows * xstride;                // [n][kPanel + 1]
  float* wp = lp + n * (kPanel + 1);
  float* w2p = wp + n * (kPanel + 1);
  float* r_tau = w2p + n * (kPanel + 1);           // per-row scalars
  float* r_den = r_tau + kRows;
  float* r_s = r_den + kRows;                      // x²·d_r + x²·d_c
  float* r_ta = r_s + kRows;                       // x⁴·d2_r + x⁴·d2_c
  float* r_num = r_ta + kRows;                     // xₙᵀLxₙ
  float* r_xwx = r_num + kRows;                    // xₙᵀWxₙ
  float* r_tb = r_xwx + kRows;                     // x²ᵀW2x²
  float* r_tc = r_tb + kRows;                      // xᵀW2x³
  float* r_td = r_tc + kRows;                      // x³ᵀW2x

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  for (int idx = tid; idx < kRows * F; idx += kThreads) {
    const int r = idx / F, f = idx % F;
    const int64_t g = row0 + r;
    xs[r * xstride + f] = g < N ? x[g * F + f] : 0.0f;
  }
  __syncthreads();

  // ---- τ and the O(F) row sums: one warp per row ----
  const int nv = (F + 31) / 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    int y[kMaxLane];
    float v[kMaxLane];
    int m_count = 0;
    float den = 0.0f, sr = 0.0f, sc = 0.0f, tar = 0.0f, tac = 0.0f,
          fsum = 0.0f;
#pragma unroll
    for (int m = 0; m < kMaxLane; ++m) {
      const int f = m * 32 + lane;
      const bool in = m < nv && f < F;
      v[m] = in ? xs[r * xstride + f] : 0.0f;
      const bool fin = in && isfinite(v[m]);
      y[m] = in ? asp_to_sortable(fin ? v[m] : __int_as_float(0x7F800000))
                : INT32_MAX;
      if (m < nv) m_count += __popc(__ballot_sync(ASP_FULL_MASK, fin));
      if (fin) fsum += v[m];
      if (in) {
        const float x2 = v[m] * v[m];
        den += x2;
        if (f < n) {
          const float x4 = x2 * x2;
          sr += x2 * d_r[f];
          sc += x2 * d_c[f];
          tar += x4 * d2_r[f];
          tac += x4 * d2_c[f];
        }
      }
    }
    den = asp_warp_sum(den);
    const float s_part = asp_warp_sum(sr) + asp_warp_sum(sc);
    const float ta_part = asp_warp_sum(tar) + asp_warp_sum(tac);

    float tau;
    if (kind == 3) {
      tau = fixed;
    } else if (kind == 2) {
      const float s = asp_warp_sum(fsum);
      tau = m_count > 0 ? s / (float)max(m_count, 1) : 0.0f;
      tau = fmaxf(tau, ASP_TAU_FLOOR);
    } else {
      tau = asp_warp_order_tau<kMaxLane>(y, nv, m_count, F, kind, pct);
    }
    if (lane == 0) {
      r_tau[r] = tau;
      r_den[r] = den;
      r_s[r] = s_part;
      r_ta[r] = ta_part;
    }
  }

  // ---- the five matrix-vector products, panel by panel ----
  const int tr = tid / 8;          // rows tr*4 .. tr*4+3
  const int tc = tid % 8;          // panel columns tc*4 .. tc*4+3
  float pn[4] = {0, 0, 0, 0}, pw[4] = {0, 0, 0, 0}, pb[4] = {0, 0, 0, 0},
        pc[4] = {0, 0, 0, 0}, pd[4] = {0, 0, 0, 0};
  for (int i0 = 0; i0 < n; i0 += kPanel) {
    __syncthreads();
    for (int idx = tid; idx < n * kPanel; idx += kThreads) {
      const int ii = idx / n, j = idx % n;
      const int i = i0 + ii;
      const bool ok = i < n;
      lp[j * (kPanel + 1) + ii] = ok ? L[(int64_t)i * n + j] : 0.0f;
      wp[j * (kPanel + 1) + ii] = ok ? W[(int64_t)i * n + j] : 0.0f;
      w2p[j * (kPanel + 1) + ii] = ok ? W2[(int64_t)i * n + j] : 0.0f;
    }
    __syncthreads();
    float aL[4][4], aW[4][4], aA[4][4], aB[4][4], aC[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        aL[a][c] = aW[a][c] = aA[a][c] = aB[a][c] = aC[a][c] = 0.0f;
    const float* xr = xs + tr * 4 * xstride;
    asp_lambda_accumulate<kPanel>(xr, xstride, lp, wp, w2p, tc, n, aL, aW,
                                  aA, aB, aC);
    asp_lambda_fold(xr + i0, xstride, tc, n - i0, aL, aW, aA, aB, aC, pn,
                    pw, pb, pc, pd);
  }
  asp_lambda_reduce(pn, pw, pb, pc, pd);
  if (tc == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = tr * 4 + a;
      r_num[r] = pn[a];
      r_xwx[r] = pw[a];
      r_tb[r] = pb[a];
      r_tc[r] = pc[a];
      r_td[r] = pd[a];
    }
  }
  __syncthreads();

  // ---- λ per row ----
  if (tid < kRows && row0 + tid < N) {
    const int r = tid;
    lam_out[row0 + r] = asp_lambda_of(r_tau[r], r_den[r], r_s[r], r_ta[r],
                                      r_num[r], r_xwx[r], r_tb[r], r_tc[r],
                                      r_td[r]);
    tau_out[row0 + r] = r_tau[r];
  }
}

}  // namespace

extern "C" int asp_taulambda(const void* x, const void* L, const void* W,
                             const void* W2, const void* d_r, const void* d_c,
                             const void* d2_r, const void* d2_c, int N, int F,
                             int n, int kind, float pct, float fixed,
                             void* lam_out, void* tau_out, void* stream) {
  if (F > kMaxLane * 32 || n > F || n < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const size_t smem =
      (size_t)(kRows * (F + 1) + 3 * n * (kPanel + 1) + 9 * kRows) * 4;
  cudaError_t err = asp_allow_smem(taulambda_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kRows - 1) / kRows;
  taulambda_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(L),
      static_cast<const float*>(W), static_cast<const float*>(W2),
      static_cast<const float*>(d_r), static_cast<const float*>(d_c),
      static_cast<const float*>(d2_r), static_cast<const float*>(d2_c), N, F,
      n, kind, pct, fixed, static_cast<float*>(lam_out),
      static_cast<float*>(tau_out));
  return (int)cudaGetLastError();
}
