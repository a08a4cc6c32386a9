// The bin-accumulator fold shared by the binned top-k kernels: K1
// (bintopk.cu, λ-aware cosine score), K6 (energy_bintopk.cu, energy
// score) and K7 (energy_chord.cu, chord-surrogate energy score with a d²
// payload).  A kernel is this fold instantiated with a score policy.
//
// What it computes: for every query q and every corpus row g < n, a score
// s(q, g) from the dot product of the staged query row and corpus row;
// row g belongs to bin g mod BINS.  Each CTA owns a block of QB queries
// and a chunk of corpus tiles (a tile is BINS consecutive rows, one per
// bin) and keeps, per (query, bin), the running top-DEPTH scores by
// (-score, lowest id), optionally each entry's payload, and det, the
// largest score it displaced.  It writes that pool and det per (query,
// chunk, bin); the plain flush in Python merges the chunks.
//
// What bounds it on an H100: the B×N×F dot products in fp32 FMA (TF32 is
// never used: the scores feed an exact top-k), against 33.5 TFMA/s of
// fp32 CUDA-core peak; the corpus is read once per query block, and the
// CTAs of one chunk run together, so those reads mostly hit L2.  What the
// design does about it:
// - each thread holds a QT-query × 4-bin register tile and reads float4
//   along the features, so 4+QT shared-memory loads feed 16·QT FMAs;
// - the corpus tile is staged row-major in 64-feature slices (32 at 512
//   bins, for shared memory) with a padded row stride (conflict-free
//   float4 reads), by cp.async into two buffers, so the next slice lands
//   while this one is computed, and a whole slice's loop is unrolled;
// - the fold is a branch-free depth-D insertion network in registers,
//   strict > so equal scores keep the earlier (lower-id) row.
// Each (query, row) dot is one FMA chain in increasing feature order;
// features past F are staged as zeros and add exact zeros.
//
// A score policy provides: a Query type loaded once per (thread, query)
// by query(gq), a Row type loaded per corpus row by row(g), and
// operator()(dot, query, row, payload) returning the score (and, when
// kPayload, a float payload kept beside each pool entry).
#pragma once

#include "common.cuh"

namespace asp_fold {

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
// multiple of 4 and the corpus is 16-byte aligned, so whole float4s are
// copied.
template <int BINS>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ xrows,
                                            int64_t g0, int F, int f0,
                                            bool vec, int tid) {
  constexpr int kXS = slice_stride<BINS>();
  constexpr int kC4 = slice_features<BINS>() / 4;
  for (int idx = tid; idx < BINS * kC4; idx += kThreads) {
    const int b = idx / kC4, c = idx % kC4;
    const int f = f0 + 4 * c;
    float* d = dst + b * kXS + 4 * c;
    const float* src = xrows + (g0 + b) * F + f;
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
template <int BINS, int G, int QG, int QT>
__device__ __forceinline__ void fma_group(float (&acc)[QT][4],
                                          const float* qb, int QS,
                                          const float* xb, int ff, int tx,
                                          int ty) {
  constexpr int kXS = slice_stride<BINS>();
  float4 qv[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i)
    qv[i] = *reinterpret_cast<const float4*>(qb + (ty + i * QG) * QS + ff);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 xv =
        *reinterpret_cast<const float4*>(xb + (tx + j * G) * kXS + ff);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      acc[i][j] = fmaf(qv[i].x, xv.x, acc[i][j]);
      acc[i][j] = fmaf(qv[i].y, xv.y, acc[i][j]);
      acc[i][j] = fmaf(qv[i].z, xv.z, acc[i][j]);
      acc[i][j] = fmaf(qv[i].w, xv.w, acc[i][j]);
    }
  }
}

// Queries per CTA: 256 threads, BINS/4 of them along the bins.
template <int BINS, int QT>
__host__ __device__ constexpr int query_block() {
  return (kThreads / (BINS / 4)) * QT;
}

template <int DEPTH, int BINS, int QT, class Score>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const Score score, const float* __restrict__ qrows,
                const float* __restrict__ xrows, int n, int n_tiles,
                int tiles_per_chunk, int B, int F, int n_chunks, bool vec,
                float* __restrict__ pool_s, int* __restrict__ pool_i,
                float* __restrict__ pool_d, float* __restrict__ det_out) {
  constexpr int G = BINS / 4;        // threads along bins
  constexpr int QG = kThreads / G;   // threads along queries
  constexpr int QB = QG * QT;        // queries per CTA
  constexpr int kFK = slice_features<BINS>();
  constexpr int kXS = slice_stride<BINS>();
  constexpr bool kPay = Score::kPayload;
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
    stage_slice<BINS>(xs, xrows, (int64_t)t_begin * BINS, F, 0, vec, tid);
  cp_async_commit();

  for (int idx = tid; idx < QB * FP; idx += kThreads) {
    const int q = idx / FP, f = idx % FP;
    const int gq = q0 + q;
    qs[q * QS + f] = (gq < B && f < F) ? qrows[(size_t)gq * F + f] : 0.0f;
  }
  typename Score::Query qst[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int gq = q0 + ty + i * QG;
    qst[i] = gq < B ? score.query(gq) : typename Score::Query{};
  }

  float s[DEPTH][QT][4];
  int id[DEPTH][QT][4];
  float pay[kPay ? DEPTH : 1][QT][4];
  float dt[QT][4];
  float acc[QT][4];
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dt[i][j] = ASP_NEG_INF;
      acc[i][j] = 0.0f;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        s[d][i][j] = ASP_NEG_INF;
        id[d][i][j] = ASP_INT_MAX;
        if constexpr (kPay) pay[d][i][j] = 0.0f;
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
      stage_slice<BINS>(xs + ((step + 1) & 1) * BINS * kXS, xrows,
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
        fma_group<BINS, G, QG, QT>(acc, qb, QS, xb, ff, tx, ty);
    } else {
#pragma unroll 2
      for (int ff = 0; ff < fk; ff += 4)
        fma_group<BINS, G, QG, QT>(acc, qb, QS, xb, ff, tx, ty);
    }

    if (sl + 1 == n_slices) {  // tile complete: fold its scores
      const int64_t g0 = (int64_t)t * BINS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t g = g0 + tx + j * G;
        if (g < n) {
          const typename Score::Row row = score.row(g);
#pragma unroll
          for (int i = 0; i < QT; ++i) {
            float cp = 0.0f;
            float c = score(acc[i][j], qst[i], row, cp);
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
              if constexpr (kPay) {
                const float tp = pay[d][i][j];
                pay[d][i][j] = up ? cp : tp;
                cp = up ? tp : cp;
              }
            }
            dt[i][j] = fmaxf(dt[i][j], c);
          }
        }
#pragma unroll
        for (int i = 0; i < QT; ++i) acc[i][j] = 0.0f;
      }
      ++t;
      sl = 0;
    } else {
      ++sl;
    }
    __syncthreads();  // this buffer is refilled two steps on
  }

#pragma unroll
  for (int i = 0; i < QT; ++i) {
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
        if constexpr (kPay) pool_d[(row * DEPTH + d) * BINS + b] = pay[d][i][j];
      }
    }
  }
}

template <int DEPTH, int BINS, int QT, class Score>
int launch_fold(const Score& score, const float* qrows, const float* xrows,
                int n, int B, int F, int n_chunks, int tiles_per_chunk,
                float* pool_s, int* pool_i, float* pool_d, float* det,
                cudaStream_t stream) {
  constexpr int QB = query_block<BINS, QT>();
  const int qs_stride = ((F + 3) & ~3) + 4;
  const size_t smem =
      (size_t)(QB * qs_stride + 2 * BINS * slice_stride<BINS>()) *
      sizeof(float);
  cudaError_t err = asp_allow_smem(fold_kernel<DEPTH, BINS, QT, Score>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec =
      F % 4 == 0 && reinterpret_cast<uintptr_t>(xrows) % 16 == 0;
  const int n_tiles = (n + BINS - 1) / BINS;
  dim3 grid((B + QB - 1) / QB, n_chunks);
  fold_kernel<DEPTH, BINS, QT, Score><<<grid, kThreads, smem, stream>>>(
      score, qrows, xrows, n, n_tiles, tiles_per_chunk, B, F, n_chunks, vec,
      pool_s, pool_i, pool_d, det);
  return (int)cudaGetLastError();
}

template <int DEPTH, int QT, class Score>
int launch_bins(int bins, const Score& score, const float* qrows,
                const float* xrows, int n, int B, int F, int n_chunks,
                int tiles_per_chunk, float* pool_s, int* pool_i,
                float* pool_d, float* det, cudaStream_t stream) {
  switch (bins) {
    case 128:
      return launch_fold<DEPTH, 128, QT>(score, qrows, xrows, n, B, F,
                                         n_chunks, tiles_per_chunk, pool_s,
                                         pool_i, pool_d, det, stream);
    case 256:
      return launch_fold<DEPTH, 256, QT>(score, qrows, xrows, n, B, F,
                                         n_chunks, tiles_per_chunk, pool_s,
                                         pool_i, pool_d, det, stream);
    case 512:
      return launch_fold<DEPTH, 512, QT>(score, qrows, xrows, n, B, F,
                                         n_chunks, tiles_per_chunk, pool_s,
                                         pool_i, pool_d, det, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pool of one score policy at any (depth, bins) the wrappers use:
// depth in {2, 3, 4}, bins in {128, 256, 512}.
template <int QT, class Score>
int launch_pool(int depth, int bins, const Score& score, const float* qrows,
                const float* xrows, int n, int B, int F, int n_chunks,
                int tiles_per_chunk, float* pool_s, int* pool_i,
                float* pool_d, float* det, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return 0;
  switch (depth) {
    case 2:
      return launch_bins<2, QT>(bins, score, qrows, xrows, n, B, F, n_chunks,
                                tiles_per_chunk, pool_s, pool_i, pool_d, det,
                                stream);
    case 3:
      return launch_bins<3, QT>(bins, score, qrows, xrows, n, B, F, n_chunks,
                                tiles_per_chunk, pool_s, pool_i, pool_d, det,
                                stream);
    case 4:
      return launch_bins<4, QT>(bins, score, qrows, xrows, n, B, F, n_chunks,
                                tiles_per_chunk, pool_s, pool_i, pool_d, det,
                                stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace asp_fold
