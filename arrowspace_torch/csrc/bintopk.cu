// K1: bin-accumulator streaming λ-aware top-k.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_lambda_topk
// (pallas_call :667, body _kernel :387, _fold_subtiles :464, _fold_tile
// :359).
//
// What it computes: for every query q and every corpus row g < n, the
// shifted score s = (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|, 1), folded into the
// per-(query, chunk, bin) top-DEPTH pool and det of binned_fold.cuh.
//
// What bounds it on an H100: the B×N×F dot products in fp32 FMA, 268 GFMA
// at 1M×128 and B=2048, against 33.5 TFMA/s of fp32 CUDA-core peak.  What
// the design does about it: the register-tiled, cp.async double-buffered
// fold of binned_fold.cuh with a 4-query × 4-bin tile per thread (QT=4).
// The λ term is rounded with __fsub_rn/__fmul_rn (common.cuh) so nvcc
// cannot contract it into an FMA that the PyTorch expression does not
// make.  Tensor cores (wgmma) and TMA are later work.
#include "binned_fold.cuh"

namespace {

struct LambdaScore {
  static constexpr bool kPayload = false;
  const float* qlam;
  const float* xlam;
  float c1;

  struct Query {
    float ql = 0.0f;
  };
  struct Row {
    float xl;
  };
  __device__ Query query(int gq) const { return {__ldg(qlam + gq)}; }
  __device__ Row row(int64_t g) const { return {__ldg(xlam + g)}; }
  __device__ float operator()(float dot, const Query& q, const Row& r,
                              float&) const {
    return asp_shifted_score(dot, q.ql, r.xl, c1);
  }
};

}  // namespace

extern "C" int asp_bintopk(const void* qhat, const void* qlam,
                           const void* xhat, const void* xlam, float c1,
                           int n, int B, int F, int bins, int depth,
                           int n_chunks, int tiles_per_chunk, void* pool_s,
                           void* pool_i, void* det, void* stream) {
  const LambdaScore score{static_cast<const float*>(qlam),
                          static_cast<const float*>(xlam), c1};
  return asp_fold::launch_pool<4>(
      depth, bins, score, static_cast<const float*>(qhat),
      static_cast<const float*>(xhat), n, B, F, n_chunks, tiles_per_chunk,
      static_cast<float*>(pool_s), static_cast<int*>(pool_i), nullptr,
      static_cast<float*>(det), static_cast<cudaStream_t>(stream));
}
