// K1: bin-accumulator streaming λ-aware top-k.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_lambda_topk
// (pallas_call :667, body _kernel :387, _fold_subtiles :464, _fold_tile
// :359).
//
// What it computes: for every query q and every corpus row g < n, the
// shifted score s = (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|, 1); row g belongs to
// bin g mod BINS.  Each CTA owns a block of QB queries and a chunk of
// corpus tiles (a tile is BINS consecutive rows, one per bin) and keeps,
// per (query, bin), the running top-DEPTH scores by (-score, lowest id)
// and det, the largest score it displaced.  It writes that pool and det
// per (query, chunk, bin); the plain flush merges the chunks with a
// two-key sort and sets the miss flags (ops/bintopk.py).
//
// What bounds it on an H100: the B×N×F dot products in fp32 FMA (TF32 is
// never used, the scores feed an exact top-k), 268 GFMA at 1M×128 and
// B=2048, against 33.5 TFMA/s of fp32 CUDA-core peak; the corpus (512 MB)
// is read once per query block, and the CTAs of one chunk run together,
// so those reads mostly hit L2.  What the design does about it:
// - each thread holds a 4-query × 4-bin register tile and reads float4
//   along the features, so 8 shared-memory loads feed 64 FMAs;
// - the corpus tile is staged row-major in 64-feature slices (32 at 512
//   bins, for shared memory) with a padded row stride (conflict-free
//   float4 reads), by cp.async into two buffers, so the next slice lands
//   while this one is computed, and a whole slice's loop is unrolled;
// - the fold is a branch-free depth-D insertion network in registers,
//   strict > so equal scores keep the earlier (lower-id) row.
// Each (query, row) dot is one FMA chain in increasing feature order;
// features past F are staged as zeros and add exact zeros.
// Tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Features staged per step, and the row stride of a staged slice in
// floats (4 of padding keep float4 reads conflict-free).
template <int BINS>
__host__ __device__ constexpr int slice_features() {
  return BINS >= 512 ? 32 : 64;
}
template <int BINS>
__host__ __device__ constexpr int slice_stride() {
  return slice_features<BINS>() + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most one committed group (the newest) is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issues the copy of rows g0 .. g0+BINS-1, features f0 .. f0+FK-1 into
// dst[BINS][XS]; features at or past F are stored as zeros.  vec: F is a
// multiple of 4 and xhat is 16-byte aligned, so whole float4s are copied.
template <int BINS>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ xhat,
                                            int64_t g0, int F, int f0,
                                            bool vec, int tid) {
  constexpr int kXS = slice_stride<BINS>();
  constexpr int kC4 = slice_features<BINS>() / 4;
  for (int idx = tid; idx < BINS * kC4; idx += kThreads) {
    const int b = idx / kC4, c = idx % kC4;
    const int f = f0 + 4 * c;
    float* d = dst + b * kXS + 4 * c;
    const float* src = xhat + (g0 + b) * F + f;
    if (vec) {
      if (f < F)
        cp_async16(d, src);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (f + e < F)
          cp_async4(d + e, src + e);
        else
          d[e] = 0.0f;
      }
    }
  }
}

// acc[i][j] += q[ty + i·QG][ff .. ff+3] · x[tx + j·G][ff .. ff+3], one
// FMA chain per (i, j) in increasing feature order.
template <int BINS, int G, int QG>
__device__ __forceinline__ void fma_group(float (&acc)[4][4], const float* qb,
                                          int QS, const float* xb, int ff,
                                          int tx, int ty) {
  constexpr int kXS = slice_stride<BINS>();
  float4 qv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qv[i] = *reinterpret_cast<const float4*>(qb + (ty + i * QG) * QS + ff);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 xv =
        *reinterpret_cast<const float4*>(xb + (tx + j * G) * kXS + ff);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][j] = fmaf(qv[i].x, xv.x, acc[i][j]);
      acc[i][j] = fmaf(qv[i].y, xv.y, acc[i][j]);
      acc[i][j] = fmaf(qv[i].z, xv.z, acc[i][j]);
      acc[i][j] = fmaf(qv[i].w, xv.w, acc[i][j]);
    }
  }
}

template <int DEPTH, int BINS>
__global__ void __launch_bounds__(kThreads)
    bintopk_kernel(const float* __restrict__ qhat,
                   const float* __restrict__ qlam,
                   const float* __restrict__ xhat,
                   const float* __restrict__ xlam, float c1, int n,
                   int n_tiles, int tiles_per_chunk, int B, int F,
                   int n_chunks, bool vec, float* __restrict__ pool_s,
                   int* __restrict__ pool_i, float* __restrict__ det_out) {
  constexpr int G = BINS / 4;        // threads along bins
  constexpr int QG = kThreads / G;   // threads along queries
  constexpr int QB = QG * 4;         // queries per CTA
  constexpr int kFK = slice_features<BINS>();
  constexpr int kXS = slice_stride<BINS>();
  extern __shared__ float4 smem4[];
  const int FP = (F + 3) & ~3;       // F rounded up to whole float4s
  const int QS = FP + 4;             // row stride of the staged queries
  float* qs = reinterpret_cast<float*>(smem4);  // [QB][QS]
  float* xs = qs + QB * QS;                     // [2][BINS][kXS]

  const int tid = threadIdx.x;
  const int tx = tid % G;
  const int ty = tid / G;
  const int q0 = blockIdx.x * QB;
  const int ch = blockIdx.y;

  const int t_begin = ch * tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + tiles_per_chunk);
  const int n_slices = (FP + kFK - 1) / kFK;
  const int steps = max(0, t_end - t_begin) * n_slices;
  if (steps > 0)
    stage_slice<BINS>(xs, xhat, (int64_t)t_begin * BINS, F, 0, vec, tid);
  cp_async_commit();

  for (int idx = tid; idx < QB * FP; idx += kThreads) {
    const int q = idx / FP, f = idx % FP;
    const int gq = q0 + q;
    qs[q * QS + f] = (gq < B && f < F) ? qhat[(size_t)gq * F + f] : 0.0f;
  }
  float ql[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + i * QG;
    ql[i] = gq < B ? qlam[gq] : 0.0f;
  }

  float s[DEPTH][4][4];
  int id[DEPTH][4][4];
  float dt[4][4];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dt[i][j] = ASP_NEG_INF;
      acc[i][j] = 0.0f;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        s[d][i][j] = ASP_NEG_INF;
        id[d][i][j] = ASP_INT_MAX;
      }
    }

  int t = t_begin, sl = 0;  // tile and feature slice of this step
  for (int step = 0; step < steps; ++step) {
    // issue the next step's slice into the other buffer, then wait for
    // this step's: the newest group may stay in flight
    if (step + 1 < steps) {
      const bool wrap = sl + 1 == n_slices;
      const int t1 = wrap ? t + 1 : t;
      const int sl1 = wrap ? 0 : sl + 1;
      stage_slice<BINS>(xs + ((step + 1) & 1) * BINS * kXS, xhat,
                        (int64_t)t1 * BINS, F, sl1 * kFK, vec, tid);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const float* xb = xs + (step & 1) * BINS * kXS;
    const float* qb = qs + sl * kFK;
    const int fk = min(kFK, FP - sl * kFK);
    if (fk == kFK) {
#pragma unroll
      for (int ff = 0; ff < kFK; ff += 4)
        fma_group<BINS, G, QG>(acc, qb, QS, xb, ff, tx, ty);
    } else {
#pragma unroll 2
      for (int ff = 0; ff < fk; ff += 4)
        fma_group<BINS, G, QG>(acc, qb, QS, xb, ff, tx, ty);
    }

    if (sl + 1 == n_slices) {  // tile complete: fold its scores
      const int64_t g0 = (int64_t)t * BINS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t g = g0 + tx + j * G;
        if (g < n) {
          const float xl = xlam[g];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float c = asp_shifted_score(acc[i][j], ql[i], xl, c1);
            int ci = (int)g;
#pragma unroll
            for (int d = 0; d < DEPTH; ++d) {
              const bool up = c > s[d][i][j];
              const float ts = s[d][i][j];
              const int ti = id[d][i][j];
              s[d][i][j] = up ? c : ts;
              id[d][i][j] = up ? ci : ti;
              c = up ? ts : c;
              ci = up ? ti : ci;
            }
            dt[i][j] = fmaxf(dt[i][j], c);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = 0.0f;
      }
      ++t;
      sl = 0;
    } else {
      ++sl;
    }
    __syncthreads();  // this buffer is refilled two steps on
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + i * QG;
    if (gq >= B) continue;
    const int64_t row = (int64_t)gq * n_chunks + ch;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = tx + j * G;
      det_out[row * BINS + b] = dt[i][j];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        pool_s[(row * DEPTH + d) * BINS + b] = s[d][i][j];
        pool_i[(row * DEPTH + d) * BINS + b] = id[d][i][j];
      }
    }
  }
}

template <int DEPTH, int BINS>
int launch(const float* qhat, const float* qlam, const float* xhat,
           const float* xlam, float c1, int n, int B, int F, int n_chunks,
           int tiles_per_chunk, float* pool_s, int* pool_i, float* det,
           cudaStream_t stream) {
  constexpr int QB = (kThreads / (BINS / 4)) * 4;
  const int qs_stride = ((F + 3) & ~3) + 4;
  const size_t smem =
      (size_t)(QB * qs_stride + 2 * BINS * slice_stride<BINS>()) *
      sizeof(float);
  cudaError_t err = asp_allow_smem(bintopk_kernel<DEPTH, BINS>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(xhat) % 16 == 0;
  const int n_tiles = (n + BINS - 1) / BINS;
  dim3 grid((B + QB - 1) / QB, n_chunks);
  bintopk_kernel<DEPTH, BINS><<<grid, kThreads, smem, stream>>>(
      qhat, qlam, xhat, xlam, c1, n, n_tiles, tiles_per_chunk, B, F,
      n_chunks, vec, pool_s, pool_i, det);
  return (int)cudaGetLastError();
}

template <int DEPTH>
int launch_bins(int bins, const float* qhat, const float* qlam,
                const float* xhat, const float* xlam, float c1, int n, int B,
                int F, int n_chunks, int tiles_per_chunk, float* pool_s,
                int* pool_i, float* det, cudaStream_t stream) {
  switch (bins) {
    case 128:
      return launch<DEPTH, 128>(qhat, qlam, xhat, xlam, c1, n, B, F,
                                n_chunks, tiles_per_chunk, pool_s, pool_i,
                                det, stream);
    case 256:
      return launch<DEPTH, 256>(qhat, qlam, xhat, xlam, c1, n, B, F,
                                n_chunks, tiles_per_chunk, pool_s, pool_i,
                                det, stream);
    case 512:
      return launch<DEPTH, 512>(qhat, qlam, xhat, xlam, c1, n, B, F,
                                n_chunks, tiles_per_chunk, pool_s, pool_i,
                                det, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int asp_bintopk(const void* qhat, const void* qlam,
                           const void* xhat, const void* xlam, float c1,
                           int n, int B, int F, int bins, int depth,
                           int n_chunks, int tiles_per_chunk, void* pool_s,
                           void* pool_i, void* det, void* stream) {
  const float* q = static_cast<const float*>(qhat);
  const float* ql = static_cast<const float*>(qlam);
  const float* x = static_cast<const float*>(xhat);
  const float* xl = static_cast<const float*>(xlam);
  float* ps = static_cast<float*>(pool_s);
  int* pi = static_cast<int*>(pool_i);
  float* dt = static_cast<float*>(det);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0) return 0;
  switch (depth) {
    case 2:
      return launch_bins<2>(bins, q, ql, x, xl, c1, n, B, F, n_chunks,
                            tiles_per_chunk, ps, pi, dt, st);
    case 3:
      return launch_bins<3>(bins, q, ql, x, xl, c1, n, B, F, n_chunks,
                            tiles_per_chunk, ps, pi, dt, st);
    case 4:
      return launch_bins<4>(bins, q, ql, x, xl, c1, n, B, F, n_chunks,
                            tiles_per_chunk, ps, pi, dt, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
