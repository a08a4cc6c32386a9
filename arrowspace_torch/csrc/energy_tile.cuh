// The binned energy tile on the tensor cores: K6 (energy_bintopk.cu,
// EnergyScore) and K7 (energy_chord.cu, ChordScore with a d² payload)
// are this kernel instantiated with a score policy.
//
// What it computes: for every query z_q and every corpus row z_g (g < n)
// of the z-plane, the dot product z_q·z_g, and from it the policy's
// score (both policies first form d² = (|z_q|² + |z_g|²) - 2·z_q·z_g);
// row g belongs to bin g mod bins.  Per (query, chunk, bin) it keeps the
// top-DEPTH scores by (-score, lowest id), optionally each entry's
// payload, and det, the largest score the chunk dropped, in K1's pool
// layout, so the flush and the strided repair serve all three kernels.
//
// What bounds it on an H100: the B×N×G products, 134 GFMA at 1M×64 and
// B = 2048, on the tensor cores as 3×TF32 mma.sync (binned_fold.cuh's
// mma_kstep: 1.6e15 TF32 flops, 1.6 ms at 494.7 TFLOP/s); then, per
// pair, the policy's tail (K6: d², a clamp and two rsqrtf on the SFUs,
// 4.2 G at that shape) and the insertion network.  The design is K1's
// (bintopk.cu):
// - a CTA is 8 warps, each on a 16-query × 8·NT-bin tile (K6 NT = 4:
//   16 pairs a thread; K7 NT = 2, since its d² payload adds DEPTH
//   registers a pair), so it holds 1024·NT pairs as QB queries × 1024·NT
//   / QB bins, with a grid axis over the groups of bins;
// - the corpus tile's 64-feature slice is staged by stage_slice, and the
//   query block's slice beside it, into two cp.async buffers each, one
//   barrier a step.  With G ≤ 64 (one slice: the serving z-plane) the
//   query block is staged once per CTA and QB is 128 where the batch
//   fills it; with more slices it is staged with every corpus slice and
//   QB is 64, so that shared memory does not grow with G (any G ≥ 1);
// - the fold stays where the accumulators are: a C fragment gives each
//   thread 2 queries × 2·NT bins, fixed for the whole walk; their row
//   data (|z_g|², λ_g) is loaded at a tile's first slice, the query data
//   once, and after a tile's last slice the policy scores each pair and
//   the branch-free insertion network (strict >: equal scores keep the
//   lower id) and det run in registers.
// Precision: d² cancels for near neighbours (|z|² ≈ 40 on the serving
// plane, d² ≈ 0.01), and u = w_D/(1+√d²) magnifies its error by
// w_D/(2√d²(1+√d²)²) ≈ 1.9 there.  The tensor core's accumulate
// truncates, so each run of kPartial = 32 features sums into a zeroed
// partial folded into the dot product by one rounded fp32 add; the
// binned engine also centres the z-plane on the corpus mean
// (ops/bin_repair BinnedEnergyTopK), which cuts |z|² and with it every
// rounding of d² about tenfold.  Every column runs the same instruction
// sequence, so identical corpus rows get bitwise identical scores;
// features past G are staged as zeros and add exact zeros; the policies
// round every step explicitly, so the tail equals energy_plane /
// chord_plane once the dot product is given.
//
// A score policy provides a Query type loaded once per (thread, query) by
// query(gq), a Row type loaded per corpus row by row(g), and
// operator()(dot, query, row, payload) returning the score (and, when
// kPayload, a float payload kept beside each pool entry).
#pragma once

#include "binned_fold.cuh"

namespace asp_energy {

using asp_fold::kThreads;
constexpr int kFK = asp_fold::kTileFK;  // features a staged slice holds
constexpr int kXS = asp_fold::kTileXS;  // row stride of a staged slice
// Features summed into one zeroed partial of the truncating accumulate:
// on the centred serving plane u's error against float64 measured
// 2.4e-5 with one partial per 64-feature slice (K1's scheme), 1.1e-5
// with 32, 6.5e-6 with 16 (tools/kernel_ablation.py); 32 costs 0-2 %.
constexpr int kPartial = 32;
static_assert(kFK % kPartial == 0 && kPartial % 8 == 0, "whole k-steps");

struct TileArgs {
  const float* qrows;
  const float* xrows;
  int n, B, G, bins, n_chunks, tiles_per_chunk;
  float* pool_s;
  int* pool_i;
  float* pool_d;
  float* det;
};

// acc += the 3×TF32 products of features [0, fk) of the staged slices,
// in zeroed partials of kPartial features.
template <int NT>
__device__ __forceinline__ void tile_product(float (&acc)[NT][4],
                                             const float* qa,
                                             const float* xb, int fk) {
  for (int kp = 0; kp < fk; kp += kPartial) {
    float part[NT][4] = {};
    const int kend = min(kp + kPartial, fk);
#pragma unroll 2
    for (int kk = kp; kk < kend; kk += 8)
      asp_fold::mma_kstep(part, qa + kk, kXS, xb + kk);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[j][r]);
  }
}

// The same over a whole slice, fully unrolled (kept apart: one helper
// for both cases measured K7 7 % slower on an H100).
template <int NT>
__device__ __forceinline__ void tile_product_full(float (&acc)[NT][4],
                                                  const float* qa,
                                                  const float* xb) {
#pragma unroll
  for (int kp = 0; kp < kFK; kp += kPartial) {
    float part[NT][4] = {};
#pragma unroll
    for (int kk = kp; kk < kp + kPartial; kk += 8)
      asp_fold::mma_kstep(part, qa + kk, kXS, xb + kk);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[j][r]);
  }
}

template <int DEPTH, int QB, int NT, class Score>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const Score score, const TileArgs a, int n_tiles, bool xvec,
                bool qvec) {
  constexpr int kBG = 1024 * NT / QB;  // bins per CTA
  constexpr int kBW = kBG / (8 * NT);  // warps along the bins
  constexpr bool kPay = Score::kPayload;
  static_assert(kBW >= 1 && 8 % kBW == 0, "8 warps tile the CTA");
  static_assert(asp_fold::slice_features<kBG>() == kFK &&
                    asp_fold::slice_stride<kBG>() == kXS,
                "stage_slice's layout");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [2][QB][kXS]
  float* xs = qs + 2 * QB * kXS;                // [2][kBG][kXS]

  const int bins = a.bins;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (warp / kBW) * 16;        // the warp's m16 tile of queries
  const int wcol = (warp % kBW) * (8 * NT);  // the warp's bins of the group
  const int q0 = blockIdx.x * QB;
  const int ch = blockIdx.y;
  const int b0 = blockIdx.z * kBG;  // the CTA's first bin

  const int GP = (a.G + 7) & ~7;  // G rounded up to whole k-steps
  const int n_slices = (GP + kFK - 1) / kFK;
  const bool restage = n_slices > 1;  // else the query slice stays put
  const int t_begin = ch * a.tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_chunk);
  const int steps = max(0, t_end - t_begin) * n_slices;
  if (steps > 0) {
    asp_fold::stage_slice<kBG>(xs, a.xrows, (int64_t)t_begin * bins + b0,
                               a.G, 0, xvec, tid);
    asp_fold::stage_rows<QB>(qs, a.qrows, q0, a.B, a.G, 0, qvec, tid);
  }
  asp_fold::cp_async_commit();

  typename Score::Query qd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    qd[i] = gq < a.B ? score.query(gq) : typename Score::Query{};
  }

  // [j][r]: n-tile j, C-fragment register r = query (r >> 1) × bin (r & 1)
  float s[DEPTH][NT][4];
  int id[DEPTH][NT][4];
  float pay[kPay ? DEPTH : 1][NT][4];
  float dt[NT][4];
  float acc[NT][4];
  typename Score::Row rd[NT][2];  // the tile's rows, loaded at its first slice
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dt[j][r] = ASP_NEG_INF;
      acc[j][r] = 0.0f;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        s[d][j][r] = ASP_NEG_INF;
        id[d][j][r] = ASP_INT_MAX;
        if constexpr (kPay) pay[d][j][r] = 0.0f;
      }
    }

  int t = t_begin, sl = 0;  // tile and feature slice of this step
  for (int step = 0; step < steps; ++step) {
    // wait for this step's slices; the barrier also frees the other
    // buffers, which the last step read, for the next step's slices
    asp_fold::cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      const bool wrap = sl + 1 == n_slices;
      const int nb = (step + 1) & 1;
      const int f1 = wrap ? 0 : (sl + 1) * kFK;
      asp_fold::stage_slice<kBG>(xs + nb * kBG * kXS, a.xrows,
                                 (int64_t)(wrap ? t + 1 : t) * bins + b0,
                                 a.G, f1, xvec, tid);
      if (restage)
        asp_fold::stage_rows<QB>(qs + nb * QB * kXS, a.qrows, q0, a.B, a.G,
                                 f1, qvec, tid);
    }
    asp_fold::cp_async_commit();

    const int64_t gt = (int64_t)t * bins + b0 + wcol + 2 * t4;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int64_t gr = gt + 8 * j + c;
          rd[j][c] = gr < a.n ? score.row(gr) : typename Score::Row{};
        }
    }

    const int buf = step & 1;
    const float* xb = xs + buf * kBG * kXS + (wcol + g) * kXS + t4;
    const float* qa =
        qs + (restage ? buf : 0) * QB * kXS + (mrow + g) * kXS + t4;
    const int fk = min(kFK, GP - sl * kFK);
    if (fk == kFK)
      tile_product_full<NT>(acc, qa, xb);
    else
      tile_product<NT>(acc, qa, xb, fk);

    if (++sl < n_slices) continue;
    // tile complete: score and fold its pairs
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t gr = gt + 8 * j + c;
        if (gr < a.n) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 2 * i + c;
            float cp = 0.0f;
            float cs = score(acc[j][r], qd[i], rd[j][c], cp);
            int ci = (int)gr;
#pragma unroll
            for (int d = 0; d < DEPTH; ++d) {
              const bool up = cs > s[d][j][r];
              const float ts = s[d][j][r];
              const int ti = id[d][j][r];
              s[d][j][r] = up ? cs : ts;
              id[d][j][r] = up ? ci : ti;
              cs = up ? ts : cs;
              ci = up ? ti : ci;
              if constexpr (kPay) {
                const float tp = pay[d][j][r];
                pay[d][j][r] = up ? cp : tp;
                cp = up ? tp : cp;
              }
            }
            dt[j][r] = fmaxf(dt[j][r], cs);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    }
    ++t;
    sl = 0;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    if (gq >= a.B) continue;
    const int64_t row = (int64_t)gq * a.n_chunks + ch;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = b0 + wcol + 8 * j + 2 * t4 + c;
        const int r = 2 * i + c;
        a.det[row * bins + b] = dt[j][r];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          a.pool_s[(row * DEPTH + d) * bins + b] = s[d][j][r];
          a.pool_i[(row * DEPTH + d) * bins + b] = id[d][j][r];
          if constexpr (kPay) a.pool_d[(row * DEPTH + d) * bins + b] = pay[d][j][r];
        }
      }
  }
}

// The query block: 128 where the z-plane is one slice wide (the block is
// then staged once) and the batch, rounded up to a multiple of 32, fills
// it; else 64 where the batch fills it, else 32 (ops/energy_bintopk.py
// energy_query_block is the same rule).
inline int query_block(int G, int B) {
  const int cap = (B + 31) / 32 * 32;
  if (cap >= 128 && G <= kFK) return 128;
  return cap >= 64 ? 64 : 32;
}

template <int DEPTH, int QB, int NT, class Score>
int launch(const Score& score, const TileArgs& a, cudaStream_t stream) {
  constexpr int kBG = 1024 * NT / QB;
  const size_t smem = (size_t)2 * (QB + kBG) * kXS * sizeof(float);
  const cudaError_t err =
      asp_allow_smem(tile_kernel<DEPTH, QB, NT, Score>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool xvec =
      a.G % 4 == 0 && reinterpret_cast<uintptr_t>(a.xrows) % 16 == 0;
  const bool qvec =
      a.G % 4 == 0 && reinterpret_cast<uintptr_t>(a.qrows) % 16 == 0;
  const int n_tiles = (a.n + a.bins - 1) / a.bins;
  const dim3 grid((a.B + QB - 1) / QB, a.n_chunks, a.bins / kBG);
  tile_kernel<DEPTH, QB, NT, Score><<<grid, kThreads, smem, stream>>>(
      score, a, n_tiles, xvec, qvec);
  return (int)cudaGetLastError();
}

template <int DEPTH, int NT, class Score>
int launch_qb(const Score& score, const TileArgs& a, cudaStream_t stream) {
  switch (query_block(a.G, a.B)) {
    case 128: return launch<DEPTH, 128, NT>(score, a, stream);
    case 64: return launch<DEPTH, 64, NT>(score, a, stream);
    default: return launch<DEPTH, 32, NT>(score, a, stream);
  }
}

// The pool of one score policy at depth 2, 3 or 4 and 128, 256 or 512
// bins.
template <int NT, class Score>
int launch_pool(const Score& score, const TileArgs& a, int depth,
                cudaStream_t stream) {
  if (a.B <= 0 || a.n <= 0) return 0;
  if ((a.bins != 128 && a.bins != 256 && a.bins != 512) || a.G < 1)
    return (int)cudaErrorInvalidValue;
  switch (depth) {
    case 2: return launch_qb<2, NT>(score, a, stream);
    case 3: return launch_qb<3, NT>(score, a, stream);
    case 4: return launch_qb<4, NT>(score, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace asp_energy
