// K7: bin-accumulator streaming fold of the chord surrogate of the
// energy score, with each pool entry's d² carried as a payload.
//
// Replaces arrowspace_tpu/ops/energy_approx.py binned_energy_topk_approx
// (pallas_call :404, body _chord_kernel :201, _fold_tile_d2 :146).
//
// What it computes: per query q, two chords and a floor fitted in the
// wrapper (ops/energy_approx._fit_chords) bound the convex, decreasing
// u(d²) = w_D/(1+√d²) from above, lifted by 1e-6·w_D against rounding:
//   d²  = (|z_q|² + |z_g|²) - 2·z_q·z_g     (K6's d², bitwise)
//   ŝ   = max(d²·a₁ + b₁, min(d², c)·a₂ + b₂) - w_λ·|λ_q - λ_g|
// ŝ is folded into the per-(query, chunk, bin) top-DEPTH pool and det of
// the energy tile, and each pool entry keeps its d², so the pool carries
// 3·DEPTH + 1 planes (K1 and K6: 2·DEPTH + 1).  The wrapper rescores the
// pooled d² exactly, sorts, and certifies a query when its k-th exact
// score beats every det (an item outside the pool lost a surrogate
// comparison, so its exact score ≤ its surrogate ≤ det).
//
// What bounds it on an H100, and the design: energy_tile.cuh, whose
// 3×TF32 product on the tensor cores gives K6's dot product bitwise, so
// the d² here is K6's.  The surrogate has no transcendental, but the d²
// payload adds DEPTH registers a (query, bin) pair: K6's 16 pairs a
// thread would pass 255 registers, so K7 holds 8 (a 16-query × 16-bin
// warp tile, NT = 2; 2048 pairs a CTA).  Every step of the surrogate is
// rounded explicitly so it equals chord_plane's once the dot product is
// given.
#include "energy_tile.cuh"

namespace {

struct ChordScore {
  static constexpr bool kPayload = true;
  const float* qn;
  const float* qlam;
  const float* ca;    // (B, 2): a₁, a₂
  const float* cb;    // (B, 3): b₁, b₂, c
  const float* xn;
  const float* xlam;
  float wl;

  struct Query {
    float qn = 0.0f, ql = 0.0f, a1 = 0.0f, a2 = 0.0f, b1 = 0.0f, b2 = 0.0f,
          ck = 0.0f;
  };
  struct Row {
    float xn, xl;
  };
  __device__ Query query(int gq) const {
    return {__ldg(qn + gq),         __ldg(qlam + gq),
            __ldg(ca + 2 * gq),     __ldg(ca + 2 * gq + 1),
            __ldg(cb + 3 * gq),     __ldg(cb + 3 * gq + 1),
            __ldg(cb + 3 * gq + 2)};
  }
  __device__ Row row(int64_t g) const {
    return {__ldg(xn + g), __ldg(xlam + g)};
  }
  __device__ float operator()(float dot, const Query& q, const Row& r,
                              float& d2_out) const {
    const float d2 = __fsub_rn(__fadd_rn(q.qn, r.xn), __fmul_rn(2.0f, dot));
    d2_out = d2;
    const float u = fmaxf(__fadd_rn(__fmul_rn(d2, q.a1), q.b1),
                          __fadd_rn(__fmul_rn(fminf(d2, q.ck), q.a2), q.b2));
    return __fsub_rn(u, __fmul_rn(wl, fabsf(__fsub_rn(q.ql, r.xl))));
  }
};

}  // namespace

extern "C" int asp_energy_chord(const void* zq, const void* qn,
                                const void* qlam, const void* ca,
                                const void* cb, const void* zx,
                                const void* xn, const void* xlam, float wl,
                                int n, int B, int G, int bins, int depth,
                                int n_chunks, int tiles_per_chunk,
                                void* pool_s, void* pool_i, void* pool_d,
                                void* det, void* stream) {
  const ChordScore score{
      static_cast<const float*>(qn), static_cast<const float*>(qlam),
      static_cast<const float*>(ca), static_cast<const float*>(cb),
      static_cast<const float*>(xn), static_cast<const float*>(xlam), wl};
  const asp_energy::TileArgs a{
      static_cast<const float*>(zq), static_cast<const float*>(zx),
      n, B, G, bins, n_chunks, tiles_per_chunk,
      static_cast<float*>(pool_s), static_cast<int*>(pool_i),
      static_cast<float*>(pool_d), static_cast<float*>(det)};
  return asp_energy::launch_pool<2>(score, a, depth,
                                    static_cast<cudaStream_t>(stream));
}
