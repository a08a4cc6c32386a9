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
// This is K2's λ after its τ (the body is shared, lambda_tile.cuh).  It
// is the λ of a JL-projected canonical build, whose graph has r =
// min(jl_dim, F/2) nodes over the F-wide raw rows: the graph terms read
// only the first n coordinates, the denominator the whole row.
//
// What bounds it on an H100: the five quadratic forms, 5·n² multiply-adds
// a row (171 GFMA at 688128 rows, n = 185), which lambda_tile.cuh runs on
// the tensor cores as 3×TF32 (7.6e14 TF32 flops, 1.5 ms at 494.7
// TFLOP/s); the rows, read once from device memory, take 0.6 ms at 3.35
// TB/s.  What the design does: one warp per row streams the full row
// once, sums x² over it and the O(n) terms over its first n values, and
// stores x[:n] in the CTA's item tile; then the shared body runs the
// products against the graph streamed from L2, and one thread per row
// forms λ.  Two CTAs share an SM up to n = 224, so one streams its rows
// while the other multiplies; the products then take 85-90 % of the time
// (tools/kernel_ablation.py).
#include "lambda_tile.cuh"

namespace {

namespace al = asp_lambda;
constexpr int kThreads = al::kThreads;
constexpr int kRows = al::kRows;
constexpr int kRowScalars = 3;   // xᵀx, the S and G row terms

__global__ void __launch_bounds__(kThreads, al::kCtasPerSm)
    lambda_batch_kernel(const float* __restrict__ x,
                        const float* __restrict__ L,
                        const float* __restrict__ W,
                        const float* __restrict__ W2,
                        const float* __restrict__ d_r,
                        const float* __restrict__ d_c,
                        const float* __restrict__ d2_r,
                        const float* __restrict__ d2_c,
                        const float* __restrict__ tau, int N, int F, int n,
                        bool vec, float* __restrict__ lam_out) {
  extern __shared__ float4 smem4[];
  const int S = al::tile_stride(n);
  const int n8 = (n + 7) & ~7;
  float* xs = reinterpret_cast<float*>(smem4);      // [kRows][S]
  float* gs = xs + kRows * S;                       // graph slices
  float* red = gs + al::kGraphFloats;               // per-group forms
  float* r_den = red + al::kRedFloats;              // xᵀx
  float* r_s = r_den + kRows;                       // x²·d_r + x²·d_c
  float* r_ta = r_s + kRows;                        // x⁴·d2_r + x⁴·d2_c

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
        xs[r * S + f] = v;
        sr += x2 * d_r[f];
        sc += x2 * d_c[f];
        tar += x4 * d2_r[f];
        tac += x4 * d2_c[f];
      }
    }
    for (int f = n + lane; f < n8; f += 32) xs[r * S + f] = 0.0f;
    den = asp_warp_sum(den);
    const float s_part = asp_warp_sum(sr) + asp_warp_sum(sc);
    const float ta_part = asp_warp_sum(tar) + asp_warp_sum(tac);
    if (lane == 0) {
      r_den[r] = den;
      r_s[r] = s_part;
      r_ta[r] = ta_part;
    }
  }

  // ---- the five quadratic forms on the tensor cores ----
  al::forms(xs, S, L, W, W2, n, vec, gs, red);

  // ---- λ per row ----
  if (tid < kRows && row0 + tid < N) {
    const int r = tid;
    lam_out[row0 + r] = al::lambda_of_row(red, r, tau[row0 + r], r_den[r],
                                          r_s[r], r_ta[r]);
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
  const size_t smem = al::smem_bytes(n, kRowScalars);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = asp_allow_smem(lambda_batch_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = al::graph_vec(n, L, W, W2);
  const int grid = (N + kRows - 1) / kRows;
  lambda_batch_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(L),
      static_cast<const float*>(W), static_cast<const float*>(W2),
      static_cast<const float*>(d_r), static_cast<const float*>(d_c),
      static_cast<const float*>(d2_r), static_cast<const float*>(d2_c),
      static_cast<const float*>(tau), N, F, n, vec,
      static_cast<float*>(lam_out));
  return (int)cudaGetLastError();
}

// Shared bytes of a K2 or K5 CTA (lambda_tile.cuh smem_bytes), for the
// test that holds the wrappers' gates to it.
extern "C" int asp_lambda_tile_bytes(int cols, int row_scalars) {
  return (int)al::smem_bytes(cols, row_scalars);
}
