// K3's bf16 mode: exact streaming merge top-k on bf16 operands, with
// wgmma fed by a TMA ring.
//
// Replaces arrowspace_tpu/ops/pallas_topk.py fused_lambda_topk with
// use_bf16=True (pallas_call :263).  It computes what merge_topk_tf32.cu
// computes (for every query q and corpus row g < n of each chunk of
// rows_per_chunk rows, the shifted score (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|,
// 1), and per (query, chunk) the exact top-k by (-score, lowest id), any
// k ≤ 128, any B ≥ 1) on bf16 query and corpus rows, F a multiple of 8,
// products exact in fp32.  It serves bf16 search and the bf16 "merge"
// session above K1's bf16 gate (F > 1536), and is the exact fallback of
// K1's bf16 repair.
//
// What bounds it on an H100: 2·B·N·F dense bf16 operations, 6.4 ms at
// 1M×1536 and 12.7 ms at 1M×3072 (B = 2048, 989.4 TFLOP/s).  An mma.sync
// design (m16n8k16 on staged slices) began every
// 64-feature slice with a cp.async wait and a block-wide barrier, staged
// the query block's slice again beside the corpus slice, and then gave
// each warp 16 mma.sync: a round trip to L2 a slice.  Here:
// - a CTA is two consumer warpgroups and one producer warp (288
//   threads).  Both warpgroups multiply the same 64 queries (wgmma's M);
//   each takes 64 corpus rows of the tile (wgmma's N), 128 rows a tile;
// - the producer's lane 0 keeps a ring of S stages full by TMA (hopper.cuh:
//   128-byte swizzle, one full and one empty mbarrier a stage), each
//   stage one 64-feature slice of the tile's rows; where the query
//   block's ceil(F/64) slices fit beside a ring of 3 stages, they arrive
//   once per CTA and stay resident, else each stage carries the query
//   slice beside the corpus slice.  The consumers wait only on a stage's
//   full barrier and release it by one arrival a warp: no barrier a
//   slice;
// - a slice is one wgmma m64n64k16 chain a warpgroup (the k16 steps
//   holding features below F, the first with scale-d = 0, so each
//   64-feature slice sums into a zeroed partial), commit, wait; then one
//   rounded fp32 add joins the partial to the running dot product.  This
//   is K1's bf16 step, so K1's and K3's bf16 modes score a (query, row)
//   pair bitwise alike (the repair merges K3's rows with K1's).  The k16
//   count passes through a shuffle, so the compiler sees it uniform;
//   guarded by a count it cannot prove uniform, the chain's wgmma are
//   serialized (ptxas C7520), and the kernel took up to 1.2× as long;
// - selection (merge_select.cuh, as merge_topk_tf32.cu): a thread holds 2
//   queries × 16 rows of the tile.  A pair whose dot product is below its
//   query's k-th score (the λ term only lowers a score) is dropped at
//   once; the others are scored, their row's λ loaded then, and those
//   that beat the k-th (score, id), one 64-bit word, are appended to the
//   query's candidate buffer (an atomic slot; one tile's rows fit, so it
//   cannot overflow).  One consumer barrier, which also tells whether
//   any thread appended; only then the warp that owns a query merges
//   buffer and list by rank, updates the k-th word, and a second barrier
//   ends the merges.  Past the first tiles few pairs survive the dot
//   test; a tile with no candidate in the CTA costs one barrier.  (At
//   1M×128, k = 10, most tiles still bring one of the 64 queries a
//   candidate, and the selection is half of the kernel's time.)
// Every column runs the same instruction sequence, so identical bf16 rows
// score bitwise alike.  Features past F, queries past B and rows past n
// (the maps end there) arrive as zeros; a row at or past the chunk's end
// never becomes a candidate.
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"
#include "merge_select.cuh"

namespace {

using namespace asp_hopper;
using asp_merge::ahead;
using asp_merge::kMaxK;
using asp_merge::merge_query;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kQB = 64;                    // queries a CTA: wgmma's M
constexpr int kN = 64;                     // rows a warpgroup: wgmma's N
constexpr int kTR = 2 * kN;                // corpus rows a tile
constexpr int kAcc = kN / 2;               // accumulators a thread
constexpr int kFK = kRowBytes / 2;         // features a slice: 64
constexpr uint32_t kQSlice = kQB * kRowBytes;  // a query slice's bytes
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr long kSmemLimit = 227 * 1024;
constexpr int kSelectBar = 1;  // the consumers' named barrier

__host__ __device__ constexpr int n_slices(int F) {
  return (F + kFK - 1) / kFK;
}
__host__ __device__ constexpr long stage_bytes(bool resident) {
  return (long)kTR * kRowBytes + (resident ? 0 : kQSlice);
}
// Each query's k-th word, top-k list and candidate buffer of one tile's
// rows, as (score, id), and its candidate count.
__host__ __device__ constexpr long select_bytes(int k) {
  return (long)kQB * 8 + (long)kQB * k * 8 + (long)kQB * kTR * 8 +
         (long)kQB * 4;
}
// The dynamic shared memory of a CTA: room to align to 1024 bytes, the
// resident query block, S stages, a full and an empty barrier a stage
// plus the query block's, and the selection state.
__host__ __device__ constexpr long smem_bytes(int F, int k, bool resident,
                                              int S) {
  return kAtomBytes + (resident ? (long)n_slices(F) * kQSlice : 0) +
         S * stage_bytes(resident) + (2L * S + 1) * 8 + select_bytes(k);
}

// What a launch at (F, k) runs: whether the query block is resident (where
// a ring of kMinStages fits beside it) and the ring's stages, as many as
// fit, at most kMaxStages; ops/topk.py merge_bf16_plan is the same rule.
// The streamed plan has a ring of kMinStages at every F and k <= kMaxK.
struct Plan {
  bool resident;
  int stages;
};
inline Plan plan(int F, int k) {
  for (bool resident : {true, false}) {
    const long room = kSmemLimit - smem_bytes(F, k, resident, 0);
    const long fit = room < 0 ? 0 : room / (stage_bytes(resident) + 16);
    const int S = (int)(fit < kMaxStages ? fit : kMaxStages);
    if (S >= kMinStages) return Plan{resident, S};
  }
  return Plan{false, 0};
}

struct Args {
  const float* qlam;
  const float* xlam;
  float c1;
  int n, B, F, k, n_chunks, rows_per_chunk, stages;
  float* out_s;
  int* out_i;
};

// d = a · bᵀ of a warpgroup's 64 queries × N rows × 16 features (+ d when
// accumulate).
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n64k16_bf16(d, a, b, accumulate);
  else
    wgmma_m64n32k16_bf16(d, a, b, accumulate);
}

// A warpgroup's slice: one wgmma chain into the zeroed partial p, the
// k16 steps that hold features below F (nk, warp-uniform; the rest are
// zeros), committed and waited for.
__device__ __forceinline__ void slice_product(float (&p)[kAcc], uint64_t da,
                                              uint64_t db, int nk) {
  fence_operands(p);
  wgmma_fence();
  wgmma_rows<kN>(p, da, db, 0);
  if (nk > 1) wgmma_rows<kN>(p, desc_k16(da, 1), desc_k16(db, 1), 1);
  if (nk > 2) wgmma_rows<kN>(p, desc_k16(da, 2), desc_k16(db, 2), 1);
  if (nk > 3) wgmma_rows<kN>(p, desc_k16(da, 3), desc_k16(db, 3), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(p);
}

__device__ __forceinline__ unsigned long long kth_word(float s, int id) {
  return (unsigned long long)__float_as_uint(s) << 32 | (unsigned)id;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    merge_topk_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap xmap,
                           const Args a) {
  constexpr uint32_t kStage = (uint32_t)stage_bytes(RESIDENT);
  constexpr uint32_t kXOff = RESIDENT ? 0 : kQSlice;  // corpus in a stage
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const int S = a.stages, k = a.k;
  const int ns = n_slices(a.F);
  const uint32_t qs = base;  // resident query block: [ns][kQB rows]
  const uint32_t xs = qs + (RESIDENT ? ns * kQSlice : 0);  // [S] stages
  const uint32_t full = xs + S * kStage;                   // [S] barriers
  const uint32_t empty = full + 8 * S;                     // [S]
  const uint32_t qbar = empty + 8 * S;
  uint8_t* sel = smem + (qbar + 8 - raw);  // the selection state
  unsigned long long* kth =  // [kQB] k-th (score, id) words
      reinterpret_cast<unsigned long long*>(sel);
  float* ls = reinterpret_cast<float*>(sel + kQB * 8);  // [kQB][k] scores
  int* li = reinterpret_cast<int*>(ls + kQB * k);       // [kQB][k] ids
  float* cs = reinterpret_cast<float*>(li + kQB * k);   // [kQB][kTR]
  int* ci = reinterpret_cast<int*>(cs + kQB * kTR);     // [kQB][kTR]
  int* cnt = ci + kQB * kTR;                            // [kQB]

  const int tid = threadIdx.x;
  // the warp's index, uniform to the compiler (a shuffle), as the roles
  // of the warps are
  const int lane = tid & 31, warp = __shfl_sync(ASP_FULL_MASK, tid >> 5, 0);
  const int q0 = blockIdx.x * kQB;
  const int ch = blockIdx.y;
  const int r0 = ch * a.rows_per_chunk;
  const int r1 = min(a.n, r0 + a.rows_per_chunk);
  const int total = max(0, (r1 - r0 + kTR - 1) / kTR) * ns;  // a slice each

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  for (int idx = tid; idx < kQB * k; idx += kThreads) {
    ls[idx] = ASP_NEG_INF;
    li[idx] = ASP_INT_MAX;
  }
  for (int q = tid; q < kQB; q += kThreads) {
    kth[q] = kth_word(ASP_NEG_INF, ASP_INT_MAX);
    cnt[q] = 0;
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0 && total > 0) {
      if (RESIDENT) {
        mbar_expect_tx(qbar, ns * kQSlice);
        for (int s = 0; s < ns; ++s)
          tma_load_2d(qs + s * kQSlice, &qmap, s * kFK, q0, qbar);
      }
      const int loads = total;
      for (int step = 0; step < loads; ++step) {
        const int st = step % S;
        // the stage's previous use, once every consumer warp released it
        if (step >= S) mbar_wait(empty + 8 * st, (step / S + 1) & 1);
        const int f0 = (step % ns) * kFK;
        const uint32_t bar = full + 8 * st, dst = xs + st * kStage;
        mbar_expect_tx(bar, kStage);
        if (!RESIDENT) tma_load_2d(dst, &qmap, f0, q0, bar);
        tma_load_2d(dst + kXOff, &xmap, f0, r0 + (step / ns) * kTR, bar);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = 16 * (warp & 3);  // the warp's 16 queries
  float ql[2];
  bool live_q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    live_q[i] = gq < a.B;
    ql[i] = live_q[i] ? __ldg(a.qlam + gq) : 0.0f;
  }
  // a score is at most fl(dot - lift): the λ term c1·min(|Δλ|, 1) lies
  // between min(c1, 0) and max(c1, 0)
  const float lift = fminf(a.c1, 0.0f);

  // acc[4j + r]: n8 block j, accumulator r = query (r >> 1) × row (r & 1)
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = part[r] = 0.0f;

  if (RESIDENT && total > 0) mbar_wait(qbar, 0);
  int t0 = r0, sl = 0;  // first row of this step's tile, and its slice
  int st = 0;           // the step's stage
  uint32_t phase = 0;   // its stage's use count, mod 2
  for (int step = 0; step < total; ++step) {
    mbar_wait(full + 8 * st, phase);
    __syncwarp();
    const int nk =
        __shfl_sync(ASP_FULL_MASK, min(kFK, a.F - sl * kFK + 15) / 16, 0);
    const uint32_t stage = xs + st * kStage;
    const uint64_t da = desc_sw128(RESIDENT ? qs + sl * kQSlice : stage);
    const uint64_t db = desc_sw128(stage + kXOff + wg * kN * kRowBytes);
    slice_product(part, da, db, nk);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
    if (++sl < ns) continue;

    // tile complete: select its candidates and merge them
    const int gt = t0 + wg * kN + 2 * t4;  // the thread's first row
    bool any = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = mrow + g + 8 * i;
      const unsigned long long w = kth[q];
      const float kth_s = __uint_as_float((unsigned)(w >> 32));
      const int kth_i = (int)(unsigned)w;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dot = acc[4 * j + 2 * i + c];
          if (live_q[i] && __fsub_rn(dot, lift) >= kth_s) {
            const int gr = gt + 8 * j + c;
            if (gr >= r1) continue;
            const float sc =
                asp_shifted_score(dot, ql[i], __ldg(a.xlam + gr), a.c1);
            if (ahead(sc, gr, kth_s, kth_i)) {
              const int slot = atomicAdd(cnt + q, 1);
              cs[q * kTR + slot] = sc;
              ci[q * kTR + slot] = gr;
              any = true;
            }
          }
        }
    }
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] = 0.0f;
    if (bar_sync_or(kSelectBar, kConsumers, any)) {
      for (int q = warp; q < kQB; q += kConsumers / 32) {
        const int n_c = cnt[q];
        if (n_c == 0) continue;
        merge_query<kTR>(ls + q * k, li + q * k, cs + q * kTR, ci + q * kTR,
                         k, n_c, lane);
        if (lane == 0) {
          kth[q] = kth_word(ls[q * k + k - 1], li[q * k + k - 1]);
          cnt[q] = 0;
        }
      }
      bar_sync(kSelectBar, kConsumers);  // the merges, before new appends
    }
    t0 += kTR;
    sl = 0;
  }

  bar_sync(kSelectBar, kConsumers);
  for (int idx = tid; idx < kQB * k; idx += kConsumers) {
    const int q = idx / k, p = idx % k;
    const int gq = q0 + q;
    if (gq >= a.B) continue;
    const int64_t row = (int64_t)gq * a.n_chunks + ch;
    a.out_s[row * k + p] = ls[idx];
    a.out_i[row * k + p] = li[idx];
  }
}

template <bool RESIDENT>
int launch(const void* qhat, const void* xhat, const Args& a,
           cudaStream_t stream) {
  const long smem = smem_bytes(a.F, a.k, RESIDENT, a.stages);
  const cudaError_t err =
      asp_allow_smem(merge_topk_bf16_kernel<RESIDENT>, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qmap, xmap;
  int rc = encode_bf16_rows(&qmap, qhat, a.B, a.F, kQB);
  if (rc == 0) rc = encode_bf16_rows(&xmap, xhat, a.n, a.F, kTR);
  if (rc != 0) return rc;
  const dim3 grid((a.B + kQB - 1) / kQB, a.n_chunks);
  merge_topk_bf16_kernel<RESIDENT>
      <<<grid, kThreads, (size_t)smem, stream>>>(qmap, xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 qhat (B, F) and xhat (at least n rows of F), F a multiple of 8 and
// both 16-byte aligned (the tensor maps' rule); qlam, xlam and the
// outputs (B, n_chunks, k) float32 and int32.  Returns 0, a cudaError_t,
// or the CUresult of a failed tensor-map encoding.
extern "C" int asp_merge_topk_bf16(const void* qhat, const void* qlam,
                                   const void* xhat, const void* xlam,
                                   float c1, int n, int B, int F, int k,
                                   int n_chunks, int rows_per_chunk,
                                   void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || F <= 0 || F % 8 != 0 ||
      reinterpret_cast<uintptr_t>(qhat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xhat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return 0;
  const Plan p = plan(F, k);
  if (p.stages < kMinStages) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(qlam),
               static_cast<const float*>(xlam),
               c1, n, B, F, k, n_chunks, rows_per_chunk, p.stages,
               static_cast<float*>(out_s), static_cast<int*>(out_i)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.resident ? launch<true>(qhat, xhat, a, s)
                    : launch<false>(qhat, xhat, a, s);
}

// What a launch at (F, k) runs: out[0..7] = query block, corpus rows a
// tile, stages, dynamic shared bytes, registers a thread, local (spilled)
// bytes a thread, whether the query block is resident, and the CTAs an
// SM holds.  Returns a cudaError_t.
extern "C" int asp_merge_topk_bf16_config(int F, int k, int* out) {
  if (k < 1 || k > kMaxK || F <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(F, k);
  const long smem = smem_bytes(F, k, p.resident, p.stages);
  const void* fn =
      p.resident
          ? reinterpret_cast<const void*>(&merge_topk_bf16_kernel<true>)
          : reinterpret_cast<const void*>(&merge_topk_bf16_kernel<false>);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads,
                                                        (size_t)smem);
  out[0] = kQB;
  out[1] = kTR;
  out[2] = p.stages;
  out[3] = (int)smem;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = p.resident ? 1 : 0;
  out[7] = ctas;
  return (int)err;
}
