// K4: per-row τ selection (median or percentile over the finite values).
//
// Replaces arrowspace_tpu/ops/pallas_tau.py fused_select_tau (pallas_call
// :475, body _kernel :422, _tau_rows :305 with the "bisect" layout,
// _bisect_order_stat :190).
//
// What it computes: for every row of an (N, F) float32 matrix, the median
// (mean of the two middle values for an even count) or the percentile
// rank round((m-1)·p) of its m finite values, TAU_FLOOR for a row with no
// finite value, floored at TAU_FLOOR: taumode.select_tau_sorted, bitwise.
//
// What bounds it on an H100: reading the matrix once, 512 MB at 1M×128,
// 0.15 ms at 3.35 TB/s.  The selection itself is 32 ballot passes over
// the row per order statistic, integer work on the CUDA cores.  What the
// design does about it: one warp per row reads the row as coalesced
// 128-byte segments straight into registers (NV values a lane) and never
// writes anything but τ; the bisection (common.cuh, shared with K2) runs
// on those registers, so the only memory traffic is the one read.  Rows
// are independent, so every warp of the card works on its own row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int NV>
__global__ void __launch_bounds__(kThreads)
    select_tau_kernel(const float* __restrict__ x, int64_t N, int F,
                      int kind, float pct, float* __restrict__ tau_out) {
  const int lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= N) return;  // uniform across the warp
  const int nv = (F + 31) / 32;
  const float* row = x + r * F;
  int y[NV];
  int m_count = 0;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int f = m * 32 + lane;
    const bool in = m < nv && f < F;
    const float v = in ? row[f] : 0.0f;
    const bool fin = in && isfinite(v);
    y[m] = in ? asp_to_sortable(fin ? v : __int_as_float(0x7F800000))
              : INT32_MAX;
    if (m < nv) m_count += __popc(__ballot_sync(ASP_FULL_MASK, fin));
  }
  const float tau = asp_warp_order_tau<NV>(y, nv, m_count, F, kind, pct);
  if (lane == 0) tau_out[r] = tau;
}

template <int NV>
int launch(const float* x, int64_t N, int F, int kind, float pct, float* out,
           cudaStream_t stream) {
  const int64_t blocks = (N + kWarps - 1) / kWarps;
  select_tau_kernel<NV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, N, F, kind, pct, out);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0 = median, 1 = percentile; F <= 1024 (32 values a lane).
extern "C" int asp_select_tau(const void* x, long long N, int F, int kind,
                              float pct, void* tau_out, void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* out = static_cast<float*>(tau_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > 1024 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int nv = (F + 31) / 32;
  if (nv <= 4) return launch<4>(xp, N, F, kind, pct, out, st);
  if (nv <= 8) return launch<8>(xp, N, F, kind, pct, out, st);
  if (nv <= 16) return launch<16>(xp, N, F, kind, pct, out, st);
  return launch<32>(xp, N, F, kind, pct, out, st);
}
