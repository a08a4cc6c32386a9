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
// What bounds it on an H100: the five quadratic forms, 5·n² multiply-adds
// a row (82 GFMA at 1M×128), which the λ body shared with K5
// (lambda_tile.cuh) runs on the tensor cores as 3×TF32 (4.9e14 TF32
// flops at 1M×128, 1.0 ms at 494.7 TFLOP/s); then τ's selection.  What
// the design does: a CTA stages its 64 item rows once (F <= 256 values
// each); τ is a warp-per-row radix select over the row's finite range
// (common.cuh, shared with K4; its counters borrow the graph slices'
// shared memory until the products begin), exact like the sort, so the
// median and percentile equal select_tau_batch bitwise; the same warp sums
// the O(F) row terms and then zeroes the row's columns n .. round8(n) - 1,
// which the products must read as 0; then the shared body runs the
// products against the graph streamed from L2, and one thread per row
// forms λ.  Two CTAs share an SM up to F = 224, so one loads its rows and
// selects τ while the other multiplies; the row load, τ and the graph
// staging alone take 56-59 % of the kernel's time at F = 128
// (tools/kernel_ablation.py).
#include "lambda_tile.cuh"

namespace {

namespace al = asp_lambda;
constexpr int kThreads = al::kThreads;
constexpr int kRows = al::kRows;
constexpr int kMaxLane = 8;      // row values per lane: F <= 256
constexpr int kRowScalars = 4;   // τ, xᵀx, the S and G row terms
static_assert(al::kGraphFloats >= kThreads / 32 * 256,
              "the graph slices hold every warp's selection counters");

__global__ void __launch_bounds__(kThreads, al::kCtasPerSm)
    taulambda_kernel(const float* __restrict__ x, const float* __restrict__ L,
                     const float* __restrict__ W, const float* __restrict__ W2,
                     const float* __restrict__ d_r,
                     const float* __restrict__ d_c,
                     const float* __restrict__ d2_r,
                     const float* __restrict__ d2_c, int N, int F, int n,
                     int kind, float pct, float fixed, bool vec,
                     float* __restrict__ lam_out,
                     float* __restrict__ tau_out) {
  extern __shared__ float4 smem4[];
  const int S = al::tile_stride(F);
  const int n8 = (n + 7) & ~7;
  float* xs = reinterpret_cast<float*>(smem4);     // [kRows][S]
  float* gs = xs + kRows * S;                      // graph slices
  float* red = gs + al::kGraphFloats;              // per-group forms
  float* r_tau = red + al::kRedFloats;             // per-row scalars
  float* r_den = r_tau + kRows;
  float* r_s = r_den + kRows;                      // x²·d_r + x²·d_c
  float* r_ta = r_s + kRows;                       // x⁴·d2_r + x⁴·d2_c

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  for (int idx = tid; idx < kRows * F; idx += kThreads) {
    const int r = idx / F, f = idx % F;
    const int64_t g = row0 + r;
    xs[r * S + f] = g < N ? x[g * F + f] : 0.0f;
  }
  __syncthreads();

  // ---- τ and the O(F) row sums: one warp per row ----
  // the graph slices' space holds each warp's 256 selection counters
  // until the products begin (see the barrier below)
  unsigned* hist = reinterpret_cast<unsigned*>(gs) + warp * 256;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    int y[kMaxLane];
    float v[kMaxLane];
    int fin_count = 0;
    float den = 0.0f, sr = 0.0f, sc = 0.0f, tar = 0.0f, tac = 0.0f,
          fsum = 0.0f;
#pragma unroll
    for (int m = 0; m < kMaxLane; ++m) {
      const int f = m * 32 + lane;
      const bool in = f < F;
      v[m] = in ? xs[r * S + f] : 0.0f;
      const bool fin = in && isfinite(v[m]);
      y[m] = fin ? asp_to_sortable(v[m]) : ASP_NO_VALUE;
      fin_count += fin;
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
      const int m_count = __reduce_add_sync(ASP_FULL_MASK, fin_count);
      const float s = asp_warp_sum(fsum);
      tau = m_count > 0 ? s / (float)max(m_count, 1) : 0.0f;
      tau = fmaxf(tau, ASP_TAU_FLOOR);
    } else {
      tau = asp_warp_order_tau<kMaxLane>(y, kind, pct, hist);
    }
    // the products read the row's columns n .. n8 - 1 as 0
    __syncwarp();
    for (int f = n + lane; f < n8; f += 32) xs[r * S + f] = 0.0f;
    if (lane == 0) {
      r_tau[r] = tau;
      r_den[r] = den;
      r_s[r] = s_part;
      r_ta[r] = ta_part;
    }
  }

  // ---- the five quadratic forms on the tensor cores ----
  __syncthreads();   // every warp is done with its counters in gs
  al::forms(xs, S, L, W, W2, n, vec, gs, red);

  // ---- λ per row ----
  if (tid < kRows && row0 + tid < N) {
    const int r = tid;
    lam_out[row0 + r] = al::lambda_of_row(red, r, r_tau[r], r_den[r], r_s[r],
                                          r_ta[r]);
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
  const size_t smem = al::smem_bytes(F, kRowScalars);
  cudaError_t err = asp_allow_smem(taulambda_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = al::graph_vec(n, L, W, W2);
  const int grid = (N + kRows - 1) / kRows;
  taulambda_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(L),
      static_cast<const float*>(W), static_cast<const float*>(W2),
      static_cast<const float*>(d_r), static_cast<const float*>(d_c),
      static_cast<const float*>(d2_r), static_cast<const float*>(d2_c), N, F,
      n, kind, pct, fixed, vec, static_cast<float*>(lam_out),
      static_cast<float*>(tau_out));
  return (int)cudaGetLastError();
}
