// K1: bin-accumulator streaming λ-aware top-k, on the tensor cores.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_lambda_topk
// (pallas_call :667, body _kernel :387, _fold_subtiles :464, _fold_tile
// :359).
//
// What it computes: for every query q and every corpus row g < n, the
// shifted score s = (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|, 1); row g belongs to
// bin g mod bins.  Per (query, chunk, bin) it keeps the top-DEPTH scores
// by (-score, lowest id) and det, the largest score the chunk dropped,
// in the layout the energy tile (energy_tile.cuh) shares; the staging
// and the 3×TF32 k-step are binned_fold.cuh's.
//
// What bounds it on an H100: the B×N×F products, 268 GFMA at 1M×128 and
// B=2048.  On the fp32 CUDA cores (33.5 TFMA/s) they took 98 % of a
// serving batch; here they run on the tensor cores as TF32 m16n8k8
// mma.sync.  One TF32 product keeps 11 significant bits and misses the
// exact top-k's 1e-5 score tolerance, so every fp32 value v is split in
// registers into hi = rna(v) and lo = rna(v - hi), and lo_q·hi_x, then
// hi_q·lo_x, then hi_q·hi_x are accumulated in fp32 at every 8-feature
// k-step (3×TF32: 1.6e15 TF32 flops at 1M×128, 3.2 ms at 494.7 TFLOP/s).
// The tensor core's accumulate truncates rather than rounds, so over the
// 288 accumulations of F = 768 its error grows one-sided (8.9e-6 against
// the 1e-5 tolerance, measured on the card): each 64-feature slice
// therefore sums into a zeroed partial that one rounded fp32 add folds
// into the tile's dot product.  What bounds it now is the rate of the
// mma.sync pipe (3×TF32 alone takes two thirds to three quarters of the
// kernel's time, tools/kernel_ablation.py), then the corpus reads from L2
// and the fold.  The design:
// - a CTA is 8 warps, each on a 16-query × 32-bin tile, holding 4096
//   (query, bin) pairs: QB = 128, 64 or 32 queries × 4096/QB bins, the
//   largest QB whose shared memory fits at this F (and that the batch
//   fills); a grid axis walks the groups of bins.  Every corpus slice
//   staged is read for QB queries, so a larger QB reads L2 less;
// - the α-prescaled query block is staged once per CTA, unsplit, with
//   row stride FP + 4 ≡ 4 (mod 8) floats, and the corpus tile's slice of
//   4096/QB rows by binned_fold.cuh's stage_slice into two cp.async
//   buffers (stride 68), one barrier a step: lane (g, t) of a fragment
//   load reads bank 4g + t (+ const), no conflicts;
// - the fold stays where the accumulators are: a C fragment gives each
//   thread 2 queries × 8 bins, fixed for the whole walk, so it keeps
//   their running top-DEPTH, ids and det in registers, applies the λ
//   term (its row λ loaded at the tile's first slice) after the tile's
//   last k-step, and runs the fold's branch-free insertion network
//   (strict >: equal scores keep the lower id).
// Every column runs the same instruction sequence, so identical corpus
// rows get bitwise identical dot products.  Features past F are staged as
// zeros (F padded to a multiple of 8) and add exact zeros.  The λ term is
// rounded with __fsub_rn/__fmul_rn (common.cuh) as the PyTorch expression
// rounds it.  wgmma and TMA rings are later work.
//
// bf16 mode (asp_bintopk_bf16; the TPU kernel's use_bf16): the same kernel
// on bf16 query and corpus operands, T = __nv_bfloat16.  Its product is
// mma.sync m16n8k16 bf16 with fp32 accumulation, one instruction per 16
// features and no split (binned_fold.cuh mma_kstep_bf16): 2·B·N·F dense
// bf16 operations, 0.53 ms at 1M×128 and B = 2048 at 989.4 TFLOP/s, and
// half the corpus bytes.  The query block is staged as bf16 at a row
// stride of FP + 8 (FP = F rounded up to 16 features), the corpus slices
// at 72 bf16 by 16-byte cp.async (F a multiple of 8); the λ term, the
// fold and the zeroed partial per 64-feature slice are the float32 mode's,
// so identical bf16 rows score bitwise alike, and a shared memory of
// 216,064 bytes at QB = 64 admits F = 1536 (the gate, ops/bintopk.py).
#include "binned_fold.cuh"

namespace {

constexpr int kThreads = asp_fold::kThreads;  // 8 warps (stage_slice's)
constexpr int kPairs = 4096;  // (query, bin) pairs a CTA holds: 16 a thread
constexpr int kFK = 64;       // features a staged slice holds
static_assert(kFK == asp_fold::kTileFK, "mma_kstep's slice");
constexpr size_t kSmemLimit = 227 * 1024;

using bf16 = __nv_bfloat16;
using asp_fold::Operand;

// A CTA holds QB queries × BG = kPairs / QB bins (QB 32, 64 or 128); each
// warp a 16-query × 32-bin tile.  Its shared memory: the query block at
// row stride FP + kPad (FP = F rounded up to whole k-steps), and two
// corpus slices of BG rows at stride tile_stride<T>.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int F, int QB) {
  constexpr int kK = Operand<T>::kStep;
  return (size_t)(QB * ((F + kK - 1) / kK * kK + Operand<T>::kPad) +
                  2 * (kPairs / QB) * asp_fold::tile_stride<T>()) *
         sizeof(T);
}

// The cp.async wait of binned_fold.cuh.
using asp_fold::cp_async_wait_all;

template <typename T>
struct Args {
  const T* qrows;
  const float* qlam;
  const T* xrows;
  const float* xlam;
  float c1;
  int n, B, F, bins, n_chunks, tiles_per_chunk;
  float* pool_s;
  int* pool_i;
  float* det;
};

// Stages the query block's rows q0 .. q0+QB-1, features 0 .. FP-1, into
// qs[QB][QS]; rows at or past B and features at or past F as zeros.
template <int QB>
__device__ __forceinline__ void stage_queries(float* qs, const Args<float>& a,
                                              int q0, int FP, int QS,
                                              int tid) {
  for (int idx = tid; idx < QB * FP; idx += kThreads) {
    const int q = idx / FP, f = idx % FP;
    const int gq = q0 + q;
    qs[q * QS + f] =
        (gq < a.B && f < a.F) ? a.qrows[(size_t)gq * a.F + f] : 0.0f;
  }
}

// bf16 rows (F a multiple of 8, rows 16-byte aligned): 8 values a load.
template <int QB>
__device__ __forceinline__ void stage_queries(bf16* qs, const Args<bf16>& a,
                                              int q0, int FP, int QS,
                                              int tid) {
  const int c8 = FP / 8;
  for (int idx = tid; idx < QB * c8; idx += kThreads) {
    const int q = idx / c8, f = 8 * (idx % c8);
    const int gq = q0 + q;
    *reinterpret_cast<uint4*>(qs + q * QS + f) =
        (gq < a.B && f < a.F)
            ? __ldg(reinterpret_cast<const uint4*>(a.qrows +
                                                   (size_t)gq * a.F + f))
            : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int DEPTH, int QB, typename T>
__global__ void __launch_bounds__(kThreads)
    bintopk_kernel(const Args<T> a, int n_tiles, bool vec) {
  constexpr int kBG = kPairs / QB;  // bins per CTA
  constexpr int kBW = kBG / 32;     // warps along the bins
  constexpr int kXS = asp_fold::tile_stride<T>();  // staged slice's stride
  constexpr int kK = Operand<T>::kStep;            // features a k-step
  static_assert(asp_fold::slice_features<kBG>() == kFK &&
                    asp_fold::slice_stride<kBG, T>() == kXS,
                "stage_slice's layout");
  extern __shared__ float4 smem4[];
  const int FP = (a.F + kK - 1) / kK * kK;  // F rounded up to whole k-steps
  const int QS = FP + Operand<T>::kPad;     // row stride of the staged queries
  T* qs = reinterpret_cast<T*>(smem4);  // [QB][QS]
  T* xs = qs + QB * QS;                 // [2][kBG][kXS]

  const int bins = a.bins;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (warp / kBW) * 16;  // the warp's m16 tile of queries
  const int wcol = (warp % kBW) * 32;  // the warp's 32 bins of the group
  const int q0 = blockIdx.x * QB;
  const int ch = blockIdx.y;
  const int b0 = blockIdx.z * kBG;    // the CTA's first bin

  const int t_begin = ch * a.tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_chunk);
  const int n_slices = (FP + kFK - 1) / kFK;
  const int steps = max(0, t_end - t_begin) * n_slices;
  if (steps > 0)
    asp_fold::stage_slice<kBG>(xs, a.xrows, (int64_t)t_begin * bins + b0,
                               a.F, 0, vec, tid);
  asp_fold::cp_async_commit();

  stage_queries<QB>(qs, a, q0, FP, QS, tid);
  float ql[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    ql[i] = gq < a.B ? __ldg(a.qlam + gq) : 0.0f;
  }

  // [j][r]: n-tile j, C-fragment register r = query (r >> 1) × bin (r & 1)
  float s[DEPTH][4][4];
  int id[DEPTH][4][4];
  float dt[4][4];
  float acc[4][4];
  float xl[4][2];  // λ of the tile's rows, loaded at its first slice
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dt[j][r] = ASP_NEG_INF;
      acc[j][r] = 0.0f;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        s[d][j][r] = ASP_NEG_INF;
        id[d][j][r] = ASP_INT_MAX;
      }
    }

  int t = t_begin, sl = 0;  // tile and feature slice of this step
  for (int step = 0; step < steps; ++step) {
    // wait for this step's slice; the barrier also frees the other buffer,
    // which the last step read, for the next step's slice
    cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      const bool wrap = sl + 1 == n_slices;
      asp_fold::stage_slice<kBG>(xs + ((step + 1) & 1) * kBG * kXS, a.xrows,
                                 (int64_t)(wrap ? t + 1 : t) * bins + b0,
                                 a.F, wrap ? 0 : (sl + 1) * kFK, vec, tid);
    }
    asp_fold::cp_async_commit();

    const int64_t gt = (int64_t)t * bins + b0 + wcol + 2 * t4;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int64_t gr = gt + 8 * j + c;
          xl[j][c] = gr < a.n ? __ldg(a.xlam + gr) : 0.0f;
        }
    }

    const int lane_k = Operand<T>::kLane * t4;  // the thread's column
    const T* xb = xs + (step & 1) * kBG * kXS + (wcol + g) * kXS + lane_k;
    const T* qa = qs + (mrow + g) * QS + sl * kFK + lane_k;
    const int fk = min(kFK, FP - sl * kFK);
    float part[4][4] = {};
    if (fk == kFK) {
#pragma unroll
      for (int kk = 0; kk < kFK; kk += kK)
        asp_fold::kstep(part, qa + kk, QS, xb + kk);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < fk; kk += kK)
        asp_fold::kstep(part, qa + kk, QS, xb + kk);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[j][r]);

    if (++sl < n_slices) continue;
    // tile complete: fold its scores
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t gr = gt + 8 * j + c;
        if (gr < a.n) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 2 * i + c;
            float cs = asp_shifted_score(acc[j][r], ql[i], xl[j][c], a.c1);
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
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = b0 + wcol + 8 * j + 2 * t4 + c;
        const int r = 2 * i + c;
        a.det[row * bins + b] = dt[j][r];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          a.pool_s[(row * DEPTH + d) * bins + b] = s[d][j][r];
          a.pool_i[(row * DEPTH + d) * bins + b] = id[d][j][r];
        }
      }
  }
}

template <int DEPTH, int QB, typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.F, QB);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      asp_allow_smem(bintopk_kernel<DEPTH, QB, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec =
      a.F % 4 == 0 && reinterpret_cast<uintptr_t>(a.xrows) % 16 == 0;
  const int n_tiles = (a.n + a.bins - 1) / a.bins;
  const dim3 grid((a.B + QB - 1) / QB, a.n_chunks, a.bins / (kPairs / QB));
  bintopk_kernel<DEPTH, QB, T><<<grid, kThreads, smem, stream>>>(a, n_tiles,
                                                                 vec);
  return (int)cudaGetLastError();
}

// The query block: the largest of 128, 64 and 32 whose shared memory fits
// at this F and that B, rounded up to a multiple of 32, fills.  A larger
// block reads each corpus slice for more queries (ops/bintopk.py
// query_block is the same rule).
template <typename T>
inline int query_block(int F, int B) {
  const int cap = (B + 31) / 32 * 32;
  for (int qb = 128; qb > 32; qb /= 2)
    if (qb <= cap && smem_bytes<T>(F, qb) <= kSmemLimit) return qb;
  return 32;
}

template <int DEPTH, typename T>
int launch_qb(const Args<T>& a, cudaStream_t stream) {
  switch (query_block<T>(a.F, a.B)) {
    case 128: return launch<DEPTH, 128>(a, stream);
    case 64: return launch<DEPTH, 64>(a, stream);
    default: return launch<DEPTH, 32>(a, stream);
  }
}

template <typename T>
int bintopk(const void* qhat, const void* qlam, const void* xhat,
            const void* xlam, float c1, int n, int B, int F, int bins,
            int depth, int n_chunks, int tiles_per_chunk, void* pool_s,
            void* pool_i, void* det, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (bins != 128 && bins != 256 && bins != 512)
    return (int)cudaErrorInvalidValue;
  const Args<T> a{static_cast<const T*>(qhat),
                  static_cast<const float*>(qlam),
                  static_cast<const T*>(xhat),
                  static_cast<const float*>(xlam),
                  c1, n, B, F, bins, n_chunks, tiles_per_chunk,
                  static_cast<float*>(pool_s), static_cast<int*>(pool_i),
                  static_cast<float*>(det)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 2: return launch_qb<2>(a, s);
    case 3: return launch_qb<3>(a, s);
    case 4: return launch_qb<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int asp_bintopk(const void* qhat, const void* qlam,
                           const void* xhat, const void* xlam, float c1,
                           int n, int B, int F, int bins, int depth,
                           int n_chunks, int tiles_per_chunk, void* pool_s,
                           void* pool_i, void* det, void* stream) {
  return bintopk<float>(qhat, qlam, xhat, xlam, c1, n, B, F, bins, depth,
                        n_chunks, tiles_per_chunk, pool_s, pool_i, det,
                        stream);
}

// bf16 operands: F a multiple of 8, qhat and xhat 16-byte aligned (the
// 16-byte copies); qlam, xlam and the outputs float32.
extern "C" int asp_bintopk_bf16(const void* qhat, const void* qlam,
                                const void* xhat, const void* xlam, float c1,
                                int n, int B, int F, int bins, int depth,
                                int n_chunks, int tiles_per_chunk,
                                void* pool_s, void* pool_i, void* det,
                                void* stream) {
  if (F % 8 != 0 || reinterpret_cast<uintptr_t>(qhat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xhat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return bintopk<bf16>(qhat, qlam, xhat, xlam, c1, n, B, F, bins, depth,
                       n_chunks, tiles_per_chunk, pool_s, pool_i, det,
                       stream);
}
