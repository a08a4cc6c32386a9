// K6: bin-accumulator streaming energy top-k.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_energy_topk
// (pallas_call :934, body _energy_kernel :689, rsqrt2 score form
// :738-763).
//
// What it computes: for every query z_q and every corpus row z_g (g < n)
// of the z-plane (the JL-projected items), the energy score SHIFTED by
// +w_D, in the rsqrt2 form of the JAX kernel:
//   d² = (|z_q|² + |z_g|²) - 2·z_q·z_g, clamped to [FLT_MIN, FLT_MAX/2]
//   s  = d²·rsqrt(d²)                     (= √d²)
//   u  = w_D·rsqrt(1 + 2s + d²)           (= w_D/(1+√d²))
//   score = u - w_λ·|λ_q - λ_g|           (true score = score - w_D)
// folded into the per-(query, chunk, bin) top-DEPTH pool and det of the
// energy tile (energy_tile.cuh): the same bins, depth, det and "row g
// sits in bin g mod bins" layout as K1, so the strided repair serves both.
//
// What bounds it on an H100, and the design: energy_tile.cuh, with 16
// (query, bin) pairs a thread (NT = 4).  The dot product comes from the
// tensor cores as 3×TF32; the tail is rounded explicitly (__fadd_rn,
// __fsub_rn, __fmul_rn) so nvcc cannot contract any of it into an FMA
// that the plain PyTorch expression does not make, and both sides call
// the same rsqrt: rsqrtf here, torch.rsqrt in the plain version, which
// PyTorch's CUDA build implements with the same rsqrtf (asp_rsqrt_probe
// lets chip_smoke.py check that bitwise on the card).  So the score
// equals energy_plane's once the dot product is given.
#include <float.h>

#include "energy_tile.cuh"

namespace {

struct EnergyScore {
  static constexpr bool kPayload = false;
  const float* qn;
  const float* qlam;
  const float* xn;
  const float* xlam;
  float wl, wd;

  struct Query {
    float qn = 0.0f, ql = 0.0f;
  };
  struct Row {
    float xn, xl;
  };
  __device__ Query query(int gq) const {
    return {__ldg(qn + gq), __ldg(qlam + gq)};
  }
  __device__ Row row(int64_t g) const {
    return {__ldg(xn + g), __ldg(xlam + g)};
  }
  __device__ float operator()(float dot, const Query& q, const Row& r,
                              float&) const {
    const float d2 = __fsub_rn(__fadd_rn(q.qn, r.xn), __fmul_rn(2.0f, dot));
    const float d2c = fminf(fmaxf(d2, FLT_MIN), FLT_MAX * 0.5f);
    const float s = __fmul_rn(d2c, rsqrtf(d2c));
    const float u = __fmul_rn(
        wd, rsqrtf(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(2.0f, s)), d2c)));
    return __fsub_rn(u, __fmul_rn(wl, fabsf(__fsub_rn(q.ql, r.xl))));
  }
};

__global__ void rsqrt_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rsqrtf(x[i]);
}

}  // namespace

extern "C" int asp_energy_bintopk(const void* zq, const void* qn,
                                  const void* qlam, const void* zx,
                                  const void* xn, const void* xlam, float wl,
                                  float wd, int n, int B, int G, int bins,
                                  int depth, int n_chunks,
                                  int tiles_per_chunk, void* pool_s,
                                  void* pool_i, void* det, void* stream) {
  const EnergyScore score{
      static_cast<const float*>(qn), static_cast<const float*>(qlam),
      static_cast<const float*>(xn), static_cast<const float*>(xlam), wl, wd};
  const asp_energy::TileArgs a{
      static_cast<const float*>(zq), static_cast<const float*>(zx),
      n, B, G, bins, n_chunks, tiles_per_chunk,
      static_cast<float*>(pool_s), static_cast<int*>(pool_i), nullptr,
      static_cast<float*>(det)};
  return asp_energy::launch_pool<4>(score, a, depth,
                                    static_cast<cudaStream_t>(stream));
}

// out[i] = rsqrtf(x[i]): the rsqrt the energy kernels call, for holding
// it against torch.rsqrt on the card.
extern "C" int asp_rsqrt_probe(const void* x, void* out, long long n,
                               void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  rsqrt_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
