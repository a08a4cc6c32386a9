// K5: synthetic λ of item rows given their τ, in one pass over the items.
//
// Replaces arrowspace_tpu/ops/pallas_lambda.py fused_lambda_batch
// (pallas_call :166, body _kernel :39-87).
//
// What it computes, per item row x (F values) with τ given, against the
// graph L (n×n, n <= F), W = max(-L, 0) off the diagonal, W2 = W∘W and
// their row and column sums d_r, d_c, d2_r, d2_c; xₙ = x[:n]:
//   E  = xₙᵀLxₙ / xᵀx over the FULL row    (0 when xᵀx <= 1e-12)
//   S  = x²·d_r + x²·d_c - 2·xₙᵀWxₙ
//   G  = clamp((x⁴·d2_r + x⁴·d2_c + 6·x²ᵀW2x² - 4·x³ᵀW2xₙ - 4·xₙᵀW2x³)/S²,
//              0, 1), 0 when S <= 0
//   λ  = τ·E/(E+τ) + (1-τ)·G
// This is K2's λ after its τ (the body is shared, common.cuh).  It is
// the λ of a JL-projected canonical build, whose graph has r = min(jl_dim,
// F/2) nodes over the F-wide raw rows: the graph terms read only the
// first n coordinates, the denominator the whole row.
//
// What bounds it on an H100: the five quadratic forms, 5·n² FMAs per row
// (171 GFMA at 1M rows, n=185), on the fp32 CUDA cores; the bytes (the
// rows, read once) are a fifth of that time.  What the design does: one
// warp per row streams the full row from device memory once, keeps the
// graph coordinates x[:n] of 128 rows in shared memory and sums x² over
// the whole row as it goes; then each thread holds K2's 4-row × 4-column
// register tile of the five products while L, W and W2 pass through
// shared memory in 32×32 blocks (so n up to 420 fits beside the rows).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;       // item rows per CTA
constexpr int kPanel = 32;       // graph rows (and columns) per block

__global__ void __launch_bounds__(kThreads)
    lambda_batch_kernel(const float* __restrict__ x,
                        const float* __restrict__ L,
                        const float* __restrict__ W,
                        const float* __restrict__ W2,
                        const float* __restrict__ d_r,
                        const float* __restrict__ d_c,
                        const float* __restrict__ d2_r,
                        const float* __restrict__ d2_c,
                        const float* __restrict__ tau, int N, int F, int n,
                        float* __restrict__ lam_out) {
  extern __shared__ float smem[];
  const int xstride = n + 1;
  float* xs = smem;                                 // [kRows][n + 1]
  float* lp = xs + kRows * xstride;                 // [kPanel][kPanel + 1]
  float* wp = lp + kPanel * (kPanel + 1);
  float* w2p = wp + kPanel * (kPanel + 1);
  float* r_den = w2p + kPanel * (kPanel + 1);       // per-row scalars
  float* r_s = r_den + kRows;                       // x²·d_r + x²·d_c
  float* r_ta = r_s + kRows;                        // x⁴·d2_r + x⁴·d2_c
  float* r_num = r_ta + kRows;                      // xₙᵀLxₙ
  float* r_xwx = r_num + kRows;                     // xₙᵀWxₙ
  float* r_tb = r_xwx + kRows;                      // x²ᵀW2x²
  float* r_tc = r_tb + kRows;                       // xᵀW2x³
  float* r_td = r_tc + kRows;                       // x³ᵀW2x

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  // ---- one warp per row: stage x[:n], the O(F) row sums ----
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int64_t g = row0 + r;
    const float* xr = x + g * F;
    float den = 0.0f, sr = 0.0f, sc = 0.0f, tar = 0.0f, tac = 0.0f;
    for (int f = lane; f < F; f += 32) {
      const float v = g < N ? xr[f] : 0.0f;
      const float x2 = v * v;
      den += x2;
      if (f < n) {
        const float x4 = x2 * x2;
        xs[r * xstride + f] = v;
        sr += x2 * d_r[f];
        sc += x2 * d_c[f];
        tar += x4 * d2_r[f];
        tac += x4 * d2_c[f];
      }
    }
    den = asp_warp_sum(den);
    const float s_part = asp_warp_sum(sr) + asp_warp_sum(sc);
    const float ta_part = asp_warp_sum(tar) + asp_warp_sum(tac);
    if (lane == 0) {
      r_den[r] = den;
      r_s[r] = s_part;
      r_ta[r] = ta_part;
    }
  }

  // ---- the five matrix-vector products, one 32-row panel at a time ----
  const int tr = tid / 8;          // rows tr*4 .. tr*4+3
  const int tc = tid % 8;          // panel rows tc*4 .. tc*4+3
  const float* xr = xs + tr * 4 * xstride;
  float pn[4] = {0, 0, 0, 0}, pw[4] = {0, 0, 0, 0}, pb[4] = {0, 0, 0, 0},
        pc[4] = {0, 0, 0, 0}, pd[4] = {0, 0, 0, 0};
  for (int i0 = 0; i0 < n; i0 += kPanel) {
    float aL[4][4], aW[4][4], aA[4][4], aB[4][4], aC[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        aL[a][c] = aW[a][c] = aA[a][c] = aB[a][c] = aC[a][c] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += kPanel) {
      __syncthreads();
      for (int idx = tid; idx < kPanel * kPanel; idx += kThreads) {
        const int ii = idx / kPanel, jj = idx % kPanel;
        const int i = i0 + ii, j = j0 + jj;
        const bool ok = i < n && j < n;
        const int64_t at = (int64_t)i * n + j;
        lp[jj * (kPanel + 1) + ii] = ok ? L[at] : 0.0f;
        wp[jj * (kPanel + 1) + ii] = ok ? W[at] : 0.0f;
        w2p[jj * (kPanel + 1) + ii] = ok ? W2[at] : 0.0f;
      }
      __syncthreads();
      asp_lambda_accumulate<kPanel>(xr + j0, xstride, lp, wp, w2p, tc,
                                    min(kPanel, n - j0), aL, aW, aA, aB, aC);
    }
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
    lam_out[row0 + r] = asp_lambda_of(tau[row0 + r], r_den[r], r_s[r],
                                      r_ta[r], r_num[r], r_xwx[r], r_tb[r],
                                      r_tc[r], r_td[r]);
  }
}

}  // namespace

extern "C" int asp_lambda_batch(const void* x, const void* L, const void* W,
                                const void* W2, const void* d_r,
                                const void* d_c, const void* d2_r,
                                const void* d2_c, const void* tau, int N,
                                int F, int n, void* lam_out, void* stream) {
  if (n > F || n < 1) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const size_t smem = (size_t)(kRows * (n + 1) +
                               3 * kPanel * (kPanel + 1) + 8 * kRows) * 4;
  cudaError_t err = asp_allow_smem(lambda_batch_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kRows - 1) / kRows;
  lambda_batch_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(L),
      static_cast<const float*>(W), static_cast<const float*>(W2),
      static_cast<const float*>(d_r), static_cast<const float*>(d_c),
      static_cast<const float*>(d2_r), static_cast<const float*>(d2_c),
      static_cast<const float*>(tau), N, F, n,
      static_cast<float*>(lam_out));
  return (int)cudaGetLastError();
}
