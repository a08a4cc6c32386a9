// K3: exact streaming merge top-k, on the tensor cores.
//
// Replaces arrowspace_tpu/ops/pallas_topk.py fused_lambda_topk
// (pallas_call :263, body _kernel :90, _merge_topk :74).
//
// What it computes: for every query q and every corpus row g of each
// chunk of rows_per_chunk rows, the shifted score (α·q̂)·x̂_g -
// c1·min(|λ_q - λ_g|, 1), and per (query, chunk) the exact top-k by
// (-score, lowest id), any k ≤ 128, any F.  The plain two-key sort merges
// the chunks' partials (ops/topk.py).  It serves the cosine search where
// K1's gate does not admit F (F > 1264), the "merge" SearchSession, and
// the rows of K1's repair whose fired bins overflow.
//
// What bounds it on an H100: the B×N×F products, 3.2 TFMA at 1M×1536 and
// B = 2048.  The design before this one ran them in fp32 FMA out of
// shared memory, 8 queries a CTA, so at B = 2048 the corpus streamed 256
// times a batch (15× its fp32 bound at 1M×128).  Here they run on the
// tensor cores as K1's 3×TF32 mma.sync k-step (binned_fold.cuh
// mma_kstep: 1.9e16 TF32 flops at 1M×1536, 38 ms at 494.7 TFLOP/s),
// with K1's zeroed partial per 64-feature slice joined by one rounded
// fp32 add (the tensor core's accumulate truncates).  So what bounds it
// is the mma.sync pipe, then the slices' reads from L2.  The design:
// - a CTA is 8 warps, each on a 16-query × 32-row tile of
//   mma_kstep<4>, holding 4096 (query, row) pairs as QB = 64 queries ×
//   64 rows (QB = 32 × 128 rows for batches of 32 or fewer): a corpus
//   slice staged is read for QB queries, so the corpus streams B/64
//   times a batch, not B/8.  Two CTAs share an SM where their shared
//   memory fits (k <= 24), so one stages while the other multiplies:
//   the chunk count fills both slots (ops/topk.py);
// - the query block's 64-feature slice is staged beside the corpus
//   tile's (binned_fold.cuh stage_rows, two cp.async buffers each, one
//   barrier a step), so shared memory does not grow with F;
// - selection: each query's running top-k (sorted by (-score, id)) and
//   its k-th entry live in shared memory.  After a tile's last slice a
//   thread scores its 16 pairs and appends those that beat their query's
//   k-th entry to the query's candidate buffer (an atomic slot; one
//   tile's rows fit, so it cannot overflow).  After a barrier, the warp
//   that owns a query with candidates merges buffer and list by rank
//   (each element's rank is the number of elements it loses to, by
//   (-score, id)) and updates the k-th entry.  Past the first tiles
//   nearly no score beats the k-th, so a tile costs its products;
//   visiting order does not matter for ties.
// Every column runs K1's instruction sequence, so identical rows score
// bitwise alike and K1 and K3 score a (query, row) pair bitwise alike
// (the repair merges K3's rows with K1's).  Features past F are staged as
// zeros and add exact zeros; the λ term rounds as common.cuh's
// asp_shifted_score.
//
// The bf16 mode (asp_merge_topk_bf16, the TPU kernel's use_bf16) is a
// kernel of its own, merge_topk_bf16.cu: wgmma from shared memory fed by
// a TMA ring, with this kernel's selection (merge_select.cuh).
#include "binned_fold.cuh"
#include "merge_select.cuh"

namespace {

constexpr int kThreads = asp_fold::kThreads;  // 8 warps (stage_rows')
constexpr int kPairs = 4096;  // (query, row) pairs a CTA holds: 16 a thread
constexpr int kNT = 4;        // n-tiles of 8 rows a warp
constexpr int kFK = asp_fold::kTileFK;  // features a staged slice holds
constexpr size_t kSmemLimit = 227 * 1024;

using asp_fold::Operand;
using asp_merge::ahead;
using asp_merge::kMaxK;
using asp_merge::merge_query;

// Shared memory of a CTA of QB queries at this k: two query slices and
// two corpus slices of kPairs / QB rows (of T, at stride tile_stride<T>),
// each query's top-k list and candidate buffer (one tile's rows) as
// (score, id), its k-th entry and its candidate count.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int QB, int k) {
  return (size_t)2 * (QB + kPairs / QB) * asp_fold::tile_stride<T>() *
             sizeof(T) +
         ((size_t)2 * QB * k + (size_t)2 * QB * (kPairs / QB) + 3 * QB) *
             sizeof(float);
}

template <typename T>
struct Args {
  const T* qrows;
  const float* qlam;
  const T* xrows;
  const float* xlam;
  float c1;
  int n, B, F, k, n_chunks, rows_per_chunk;
  float* out_s;
  int* out_i;
};

// Two CTAs fit an SM where their shared memory does (k <= 24 at QB = 64,
// ops/topk.py merge_ctas_per_sm); the launch bounds keep the registers
// within that.
template <int QB, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    merge_topk_kernel(const Args<T> a, bool xvec, bool qvec) {
  constexpr int kTR = kPairs / QB;     // corpus rows a tile
  constexpr int kBW = kTR / (8 * kNT);  // warps along the rows
  constexpr int kXS = asp_fold::tile_stride<T>();  // staged slice's stride
  constexpr int kK = Operand<T>::kStep;            // features a k-step
  static_assert((QB / 16) * kBW == kThreads / 32, "8 warps tile the CTA");
  extern __shared__ float4 smem4[];
  const int k = a.k;
  T* qs = reinterpret_cast<T*>(smem4);  // [2][QB][kXS]
  T* xs = qs + 2 * QB * kXS;            // [2][kTR][kXS]
  float* ls = reinterpret_cast<float*>(xs + 2 * kTR * kXS);  // [QB][k] list scores
  int* li = reinterpret_cast<int*>(ls + QB * k);  // [QB][k] list ids
  float* cs = reinterpret_cast<float*>(li + QB * k);  // [QB][kTR]
  int* ci = reinterpret_cast<int*>(cs + QB * kTR);    // [QB][kTR]
  float* ks = reinterpret_cast<float*>(ci + QB * kTR);  // [QB] k-th score
  int* ki = reinterpret_cast<int*>(ks + QB);            // [QB] k-th id
  int* cnt = ki + QB;                                   // [QB]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (warp / kBW) * 16;        // the warp's m16 tile of queries
  const int wcol = (warp % kBW) * (8 * kNT);  // the warp's rows of the tile
  const int q0 = blockIdx.x * QB;
  const int ch = blockIdx.y;
  const int r0 = ch * a.rows_per_chunk;
  const int r1 = min(a.n, r0 + a.rows_per_chunk);

  const int FP = (a.F + kK - 1) / kK * kK;  // F rounded up to whole k-steps
  const int n_slices = (FP + kFK - 1) / kFK;
  const int steps = max(0, (r1 - r0 + kTR - 1) / kTR) * n_slices;
  if (steps > 0) {
    asp_fold::stage_rows<kTR>(xs, a.xrows, r0, r1, a.F, 0, xvec, tid);
    asp_fold::stage_rows<QB>(qs, a.qrows, q0, a.B, a.F, 0, qvec, tid);
  }
  asp_fold::cp_async_commit();

  for (int idx = tid; idx < QB * k; idx += kThreads) {
    ls[idx] = ASP_NEG_INF;
    li[idx] = ASP_INT_MAX;
  }
  for (int q = tid; q < QB; q += kThreads) {
    ks[q] = ASP_NEG_INF;
    ki[q] = ASP_INT_MAX;
    cnt[q] = 0;
  }
  float ql[2];
  bool live_q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    live_q[i] = gq < a.B;
    ql[i] = live_q[i] ? __ldg(a.qlam + gq) : 0.0f;
  }

  // [j][r]: n-tile j, C-fragment register r = query (r >> 1) × row (r & 1)
  float acc[kNT][4];
  float xl[kNT][2];  // λ of the tile's rows, loaded at its first slice
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;

  int t0 = r0, sl = 0;  // first row of this step's tile, and its slice
  for (int step = 0; step < steps; ++step) {
    // wait for this step's slices; the barrier also frees the other
    // buffers, which the last step read, for the next step's slices (and
    // orders the last tile's merge before this tile's candidates)
    asp_fold::cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      const bool wrap = sl + 1 == n_slices;
      const int nb = (step + 1) & 1;
      const int f1 = wrap ? 0 : (sl + 1) * kFK;
      asp_fold::stage_rows<kTR>(xs + nb * kTR * kXS, a.xrows,
                                wrap ? t0 + kTR : t0, r1, a.F, f1, xvec, tid);
      asp_fold::stage_rows<QB>(qs + nb * QB * kXS, a.qrows, q0, a.B, a.F, f1,
                               qvec, tid);
    }
    asp_fold::cp_async_commit();

    const int gt = t0 + wcol + 2 * t4;
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int gr = gt + 8 * j + c;
          xl[j][c] = gr < r1 ? __ldg(a.xlam + gr) : 0.0f;
        }
    }

    const int buf = step & 1;
    const int lane_k = Operand<T>::kLane * t4;  // the thread's column
    const T* xb = xs + buf * kTR * kXS + (wcol + g) * kXS + lane_k;
    const T* qa = qs + buf * QB * kXS + (mrow + g) * kXS + lane_k;
    const int fk = min(kFK, FP - sl * kFK);
    float part[kNT][4] = {};
    if (fk == kFK) {
#pragma unroll
      for (int kk = 0; kk < kFK; kk += kK)
        asp_fold::kstep(part, qa + kk, kXS, xb + kk);
    } else {
#pragma unroll 2
      for (int kk = 0; kk < fk; kk += kK)
        asp_fold::kstep(part, qa + kk, kXS, xb + kk);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[j][r]);

    if (++sl < n_slices) continue;
    // tile complete: the pairs that beat their query's k-th entry become
    // candidates
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = mrow + g + 8 * i;
      const float kth_s = ks[q];
      const int kth_i = ki[q];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int gr = gt + 8 * j + c;
          const float sc =
              asp_shifted_score(acc[j][2 * i + c], ql[i], xl[j][c], a.c1);
          if (live_q[i] && gr < r1 && ahead(sc, gr, kth_s, kth_i)) {
            const int slot = atomicAdd(cnt + q, 1);
            cs[q * kTR + slot] = sc;
            ci[q * kTR + slot] = gr;
          }
        }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    __syncthreads();
    for (int q = warp; q < QB; q += kThreads / 32) {
      const int n_c = cnt[q];
      if (n_c == 0) continue;
      merge_query<kTR>(ls + q * k, li + q * k, cs + q * kTR, ci + q * kTR, k,
                       n_c, lane);
      if (lane == 0) {
        ks[q] = ls[q * k + k - 1];
        ki[q] = li[q * k + k - 1];
        cnt[q] = 0;
      }
    }
    t0 += kTR;
    sl = 0;
  }

  __syncthreads();
  for (int idx = tid; idx < QB * k; idx += kThreads) {
    const int q = idx / k, p = idx % k;
    const int gq = q0 + q;
    if (gq >= a.B) continue;
    const int64_t row = (int64_t)gq * a.n_chunks + ch;
    a.out_s[row * k + p] = ls[idx];
    a.out_i[row * k + p] = li[idx];
  }
}

template <int QB, typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(QB, a.k);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = asp_allow_smem(merge_topk_kernel<QB, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const bool xvec =
      a.F % 4 == 0 && reinterpret_cast<uintptr_t>(a.xrows) % 16 == 0;
  const bool qvec =
      a.F % 4 == 0 && reinterpret_cast<uintptr_t>(a.qrows) % 16 == 0;
  const dim3 grid((a.B + QB - 1) / QB, a.n_chunks);
  merge_topk_kernel<QB, T><<<grid, kThreads, smem, stream>>>(a, xvec, qvec);
  return (int)cudaGetLastError();
}

// The query block: 64 where the batch, rounded up to a multiple of 32,
// fills it, else 32 (ops/topk.py merge_query_block is the same rule).
inline int query_block(int B) { return (B + 31) / 32 * 32 >= 64 ? 64 : 32; }

template <typename T>
int merge_topk(const void* qhat, const void* qlam, const void* xhat,
               const void* xlam, float c1, int n, int B, int F, int k,
               int n_chunks, int rows_per_chunk, void* out_s, void* out_i,
               void* stream) {
  if (k < 1 || k > kMaxK || F < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return 0;
  const Args<T> a{static_cast<const T*>(qhat),
                  static_cast<const float*>(qlam),
                  static_cast<const T*>(xhat),
                  static_cast<const float*>(xlam),
                  c1, n, B, F, k, n_chunks, rows_per_chunk,
                  static_cast<float*>(out_s), static_cast<int*>(out_i)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return query_block(B) == 64 ? launch<64>(a, s) : launch<32>(a, s);
}

}  // namespace

extern "C" int asp_merge_topk(const void* qhat, const void* qlam,
                              const void* xhat, const void* xlam, float c1,
                              int n, int B, int F, int k, int n_chunks,
                              int rows_per_chunk, void* out_s, void* out_i,
                              void* stream) {
  return merge_topk<float>(qhat, qlam, xhat, xlam, c1, n, B, F, k, n_chunks,
                           rows_per_chunk, out_s, out_i, stream);
}
