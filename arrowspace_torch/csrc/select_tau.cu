// K4: per-row τ selection (median or percentile over the finite values).
//
// Replaces arrowspace_tpu/ops/pallas_tau.py fused_select_tau (pallas_call
// :475, body _kernel :422, _tau_rows :305 with the "bisect" layout,
// _bisect_order_stat :190).
//
// What it computes: for every row of an (N, F) float32 matrix, F <= 1536,
// the median (mean of the two middle values for an even count) or the
// percentile rank round((m-1)·p) of its m finite values, TAU_FLOOR for a
// row with no finite value, floored at TAU_FLOOR:
// taumode.select_tau_sorted, bitwise.
//
// What bounds it on an H100: reading the matrix once, 512 MB at 1M×128,
// 0.15 ms at 3.35 TB/s, about 35 SM-clocks a row, and the selection's
// integer work.  A bisection over the sortable-int range takes 32 passes,
// each a ballot and popc per held value (16 popc results a clock per SM):
// 1.19 ms at 1M×128 ("old_count" in tools/kernel_ablation.py, which
// times each choice of selection).  What the design does: one warp per
// row reads the row straight into registers, 16 bytes a lane where rows
// are 16-byte aligned (the order within a lane does not matter for
// counting), with as many slots a lane as the row needs (4 at F = 128,
// 24 at 768, 48 at 1536); the selection (common.cuh, shared with K2) is
// a radix select over the row's finite range, at most 4 passes of 8-bit
// digits counted into a 256-bin histogram a warp in shared memory,
// usually ended after one or two by a warp min or max.  The only memory
// traffic is the one read and one τ a row.  Rows are independent, so
// every warp of the card works on its own row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxF = 1536;

// NV slots a lane.  VEC: slot 4j + c holds value 4(32j + lane) + c (F %
// 4 == 0, rows 16-byte aligned); else slot m holds value 32m + lane.
template <int NV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    select_tau_kernel(const float* __restrict__ x, int64_t N, int F,
                      int kind, float pct, float* __restrict__ tau_out) {
  __shared__ uint4 hist[kWarps][64];   // 256 counters a warp
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= N) return;  // uniform across the warp
  const float* row = x + r * F;
  int y[NV];
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < NV / 4; ++j) {
      const int f = 4 * (32 * j + lane);
      const float4 v = f < F ? *reinterpret_cast<const float4*>(row + f)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      y[4 * j] = f < F ? asp_tau_key(v.x) : ASP_NO_VALUE;
      y[4 * j + 1] = f < F ? asp_tau_key(v.y) : ASP_NO_VALUE;
      y[4 * j + 2] = f < F ? asp_tau_key(v.z) : ASP_NO_VALUE;
      y[4 * j + 3] = f < F ? asp_tau_key(v.w) : ASP_NO_VALUE;
    }
  } else {
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int f = 32 * m + lane;
      y[m] = f < F ? asp_tau_key(row[f]) : ASP_NO_VALUE;
    }
  }
  const float tau = asp_warp_order_tau<NV>(
      y, kind, pct, reinterpret_cast<unsigned*>(hist[warp]));
  if (lane == 0) tau_out[r] = tau;
}

template <int NV>
int launch(const float* x, int64_t N, int F, int kind, float pct, float* out,
           bool vec, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((N + kWarps - 1) / kWarps);
  if constexpr (NV % 4 == 0) {
    if (vec) {
      select_tau_kernel<NV, true><<<blocks, kThreads, 0, stream>>>(
          x, N, F, kind, pct, out);
      return (int)cudaGetLastError();
    }
  }
  select_tau_kernel<NV, false><<<blocks, kThreads, 0, stream>>>(
      x, N, F, kind, pct, out);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0 = median, 1 = percentile (pct in [0, 1]); 1 <= F <= 1536.
extern "C" int asp_select_tau(const void* x, long long N, int F, int kind,
                              float pct, void* tau_out, void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* out = static_cast<float*>(tau_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > kMaxF || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int slots = vec ? 4 * ((F + 127) / 128) : (F + 31) / 32;
  if (slots <= 2) return launch<2>(xp, N, F, kind, pct, out, false, st);
  if (slots <= 4) return launch<4>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 8) return launch<8>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 12) return launch<12>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 16) return launch<16>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 24) return launch<24>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 32) return launch<32>(xp, N, F, kind, pct, out, vec, st);
  if (slots <= 40) return launch<40>(xp, N, F, kind, pct, out, vec, st);
  return launch<48>(xp, N, F, kind, pct, out, vec, st);
}
