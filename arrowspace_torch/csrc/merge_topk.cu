// K3: exact streaming merge top-k.
//
// Replaces arrowspace_tpu/ops/pallas_topk.py fused_lambda_topk
// (pallas_call :263, body _kernel :90, _merge_topk :74).
//
// What it computes: for every query q, the exact top-k corpus rows of the
// shifted score (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|, 1), ties going to the
// lowest row id.  The grid is (query block of 8, corpus chunk); each warp
// owns one query and keeps its chunk's top-k sorted in shared memory, and
// the CTA writes one partial top-k per (query, chunk).  The plain two-key
// sort merges the partials (ops/topk.py).
//
// What bounds it on an H100: the dot products in fp32 FMA, each lane
// scoring 4 rows of a 128-row tile per step from shared memory, and the
// serial insertions while a query's list warms up.  It serves the repair
// fallback (a handful of queries), where the corpus stream dominates; the
// design keeps that one pass over the corpus per query block and does an
// insertion only when a row beats the current kth (a warp ballot filters
// the tile first), so after warm-up nearly every tile costs only its
// scores.  Rows are visited in increasing id and insertion is strictly
// greater-than, so equal scores keep the lower id.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;  // corpus rows per step, 4 per lane
constexpr int kFK = 32;     // features staged per step
constexpr int kMaxK = 128;  // 4 list slots per lane

__global__ void __launch_bounds__(kThreads)
    merge_topk_kernel(const float* __restrict__ qhat,
                      const float* __restrict__ qlam,
                      const float* __restrict__ xhat,
                      const float* __restrict__ xlam, float c1, int n, int B,
                      int F, int k, int n_chunks, int rows_per_chunk,
                      float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // [kWarps][F]
  float* xs = qs + kWarps * F;                       // [kFK][kTile + 1]
  float* ls = xs + kFK * (kTile + 1);                // [kWarps][k]
  int* li = reinterpret_cast<int*>(ls + kWarps * k);  // [kWarps][k]

  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int gq = blockIdx.x * kWarps + w;
  const bool active = gq < B;
  const int ch = blockIdx.y;
  const int r0 = ch * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);

  for (int idx = tid; idx < kWarps * F; idx += kThreads) {
    const int qq = blockIdx.x * kWarps + idx / F;
    qs[idx] = qq < B ? qhat[(size_t)qq * F + idx % F] : 0.0f;
  }
  for (int p = lane; p < k; p += 32) {
    ls[w * k + p] = ASP_NEG_INF;
    li[w * k + p] = ASP_INT_MAX;
  }
  const float ql = active ? qlam[gq] : 0.0f;
  float kth = ASP_NEG_INF;
  float* my_s = ls + w * k;
  int* my_i = li + w * k;

  for (int base = r0; base < r1; base += kTile) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int f0 = 0; f0 < F; f0 += kFK) {
      __syncthreads();
      for (int idx = tid; idx < kTile * kFK; idx += kThreads) {
        const int t = idx / kFK, ff = idx % kFK;
        const int f = f0 + ff;
        const int64_t g = (int64_t)base + t;
        xs[ff * (kTile + 1) + t] =
            (f < F && g < r1) ? xhat[g * F + f] : 0.0f;
      }
      __syncthreads();
      const int fk = min(kFK, F - f0);
      for (int ff = 0; ff < fk; ++ff) {
        const float qv = qs[w * F + f0 + ff];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[j] = fmaf(qv, xs[ff * (kTile + 1) + lane + 32 * j], acc[j]);
      }
    }
    if (!active) continue;

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = base + lane + 32 * j;
      const float sc =
          g < r1 ? asp_shifted_score(acc[j], ql, xlam[g], c1) : ASP_NEG_INF;
      unsigned mask = __ballot_sync(ASP_FULL_MASK, g < r1 && sc > kth);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float cs = __shfl_sync(ASP_FULL_MASK, sc, src);
        const int cg = __shfl_sync(ASP_FULL_MASK, g, src);
        if (!(cs > kth)) continue;  // warp-uniform
        // insertion point: after every entry >= cs (those have lower ids)
        int pos = 0;
        for (int p0 = 0; p0 < k; p0 += 32) {
          const int p = p0 + lane;
          pos += __popc(
              __ballot_sync(ASP_FULL_MASK, p < k && my_s[p] >= cs));
        }
        float vs[kMaxK / 32];
        int vi[kMaxK / 32];
#pragma unroll
        for (int m = 0; m < kMaxK / 32; ++m) {
          const int p = m * 32 + lane;
          vs[m] = 0.0f;
          vi[m] = 0;
          if (p < k && p > pos) {
            vs[m] = my_s[p - 1];
            vi[m] = my_i[p - 1];
          }
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < kMaxK / 32; ++m) {
          const int p = m * 32 + lane;
          if (p < k && p > pos) {
            my_s[p] = vs[m];
            my_i[p] = vi[m];
          } else if (p == pos) {
            my_s[p] = cs;
            my_i[p] = cg;
          }
        }
        __syncwarp();
        kth = my_s[k - 1];
      }
    }
  }

  __syncthreads();
  if (active) {
    const int64_t row = (int64_t)gq * n_chunks + ch;
    for (int p = lane; p < k; p += 32) {
      out_s[row * k + p] = my_s[p];
      out_i[row * k + p] = my_i[p];
    }
  }
}

}  // namespace

extern "C" int asp_merge_topk(const void* qhat, const void* qlam,
                              const void* xhat, const void* xlam, float c1,
                              int n, int B, int F, int k, int n_chunks,
                              int rows_per_chunk, void* out_s, void* out_i,
                              void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return 0;
  const size_t smem =
      (size_t)(kWarps * F + kFK * (kTile + 1) + 2 * kWarps * k) * 4;
  cudaError_t err = asp_allow_smem(merge_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + kWarps - 1) / kWarps, n_chunks);
  merge_topk_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qhat), static_cast<const float*>(qlam),
      static_cast<const float*>(xhat), static_cast<const float*>(xlam), c1,
      n, B, F, k, n_chunks, rows_per_chunk, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
