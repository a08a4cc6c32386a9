// K3: exact streaming merge top-k on float32 operands, its 3×TF32
// product on wgmma fed by a TMA ring.
//
// Replaces arrowspace_tpu/ops/pallas_topk.py fused_lambda_topk
// (pallas_call :263, body _kernel :90, _merge_topk :74).  What it
// computes: for every query q and corpus row g < n of each chunk of
// rows_per_chunk rows the shifted score (α·q̂)·x̂_g - c1·min(|λ_q - λ_g|,
// 1), and per (query, chunk) the exact top-k by (-score, lowest id), any
// k <= 128, any B >= 1, rows of F features zero-padded to whole 16 bytes
// (F a multiple of 4: ops/bintopk.py operand_width).  The plain two-key
// sort merges the chunks' partials (ops/topk.py).  It serves the cosine
// search where K1's gate does not admit F (F > 1264), the "merge"
// SearchSession, and the rows of K1's repair whose fired bins overflow.
//
// What bounds it on an H100: the B×N×F products in 3×TF32, 38.2 ms at
// 1M × 1536 and B = 2048 (494.7 TFLOP/s).  mma.sync m16n8k8 from staged
// slices, with a block-wide barrier a slice, reaches a quarter of that
// rate; wgmma is the only way to the full rate.  The design:
// - a CTA is two consumer warpgroups and one producer warp (288
//   threads).  Both warpgroups multiply the same 64 queries (wgmma's N);
//   each takes 64 corpus rows of the tile (wgmma's M), 128 rows a tile,
//   so a thread holds 2 rows × 16 queries;
// - the corpus is the A operand, from registers: each thread loads its
//   fragment of a k8 step from the staged float32 box and splits it
//   there, hi = rna(v) and lo = rna(v - hi) (binned_fold.cuh split_tf32),
//   so the corpus is read as float32 and never stored split;
// - the queries are the B operand, from shared memory.  wgmma reads B as
//   tf32 values, and the query block at F = 1536 (split, 786 KB) cannot
//   stay resident, so split_queries first splits the batch once into a hi
//   and a lo plane in global memory (the caller's workspace, on the same
//   stream), and each stage carries the query block's boxes of both
//   planes beside the corpus box;
// - the producer warp's lane 0 keeps a ring of S stages full by TMA
//   (hopper.cuh: 128-byte swizzle, one full and one empty mbarrier a
//   stage).  A stage is one 32-feature box: 128 corpus rows (16 KB) and
//   64 queries of each plane (8 KB each), so every (query, row) pair
//   costs 8 bytes of L2 reads a 64-feature slice.
//   Half-slice stages let a ring of 3 or more fit beside the selection
//   state at every k <= 128.  The consumers wait only on a stage's full
//   barrier and release it by one arrival a warp once the chain that
//   reads it has completed: no barrier a slice, and a stage is held
//   for one chain;
// - a 64-feature slice is two stages, each one wgmma m64n64k8 chain a
//   warpgroup (4 k8 steps, 32 fragment registers; a chain over the whole
//   slice held 64 and spilled, and took 1.15× as long): at each k8 step
//   below F, hi_x·lo_q, then lo_x·hi_q, then hi_x·hi_q, the slice's first
//   with scale-d = 0, so the slice sums into a zeroed partial that one
//   rounded fp32 add joins to the running dot product.  That is K1's
//   sequence (binned_fold.cuh mma_kstep) with A and B exchanged, as
//   bintopk_tf32.cu runs it (each product is exact in fp32, and the
//   tensor core sums a k8 step's products alike either way), so K1 and
//   K3 score a pair bitwise alike (the repair merges K3's rows with
//   K1's).  The k8 count
//   passes through a shuffle, so that the compiler sees it uniform and
//   does not serialize the chain (ptxas C7520: 1.2× as long);
// - selection (merge_select.cuh, as merge_topk_bf16.cu): after a tile's
//   last slice a pair whose dot product is below its query's k-th score
//   (the λ term only lowers a score) is dropped at once; the others are
//   scored, their λ loaded then, and those that beat the k-th (score,
//   id), one 64-bit word, are appended to the query's candidate buffer
//   (an atomic slot; one tile's rows fit, so it cannot overflow).  One
//   consumer barrier, which also tells whether any thread appended; only
//   then the warp that owns a query merges buffer and list by rank,
//   updates the k-th word, and a second barrier ends the merges.  At F =
//   1536 a tile's selection follows 24 slices of products.
// Every column runs the same instruction sequence, so identical corpus
// rows score bitwise alike.  Features past F, queries past B and rows
// past n (the maps end there) arrive as zeros; a row at or past the
// chunk's end never becomes a candidate.
// What bounds it now (tools/kernel_ablation.py --kernels k3tf32, H100 at
// its 700 W cap): at 1M × 1536, B = 2048, k = 10 the kernel takes 2.3×
// its bound, the product path alone 2.0× (a warpgroup's chain waits for
// its fragments, then drains), the ring alone 1.4× (393 GB of L2 reads a
// batch at 7.2 TB/s).  Keeping two half-stage chains in flight (a
// fragment buffer each, wgmma.wait_group 1) gained nothing at k = 10
// and, holding a slice's two stages of the 3 that fit, ran 1.4× as long
// at k = 100.
#include "binned_fold.cuh"
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
constexpr int kQB = 64;                    // queries a CTA: wgmma's N
constexpr int kM = 64;                     // rows a warpgroup: wgmma's M
constexpr int kTR = 2 * kM;                // corpus rows a tile
constexpr int kAcc = kQB / 2;              // accumulators a thread
constexpr int kBox = kRowBytes / 4;        // tf32 features a box: 32
constexpr uint32_t kXBox = kTR * kRowBytes;    // a stage's corpus box
constexpr uint32_t kQBox = kQB * kRowBytes;    // a stage's box of a plane
constexpr uint32_t kStage = kXBox + 2 * kQBox;  // 32 KB
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr long kSmemLimit = 227 * 1024;
constexpr int kSelectBar = 1;  // the consumers' named barrier

// Each query's k-th word, top-k list and candidate buffer of one tile's
// rows, as (score, id), and its candidate count.
__host__ __device__ constexpr long select_bytes(int k) {
  return (long)kQB * 8 + (long)kQB * k * 8 + (long)kQB * kTR * 8 +
         (long)kQB * 4;
}
// The dynamic shared memory of a CTA: room to align to 1024 bytes, S
// stages with a full and an empty barrier each, and the selection state.
__host__ __device__ constexpr long smem_bytes(int k, int S) {
  return kAtomBytes + (long)S * (kStage + 16) + select_bytes(k);
}
// Stages of the ring at k: as many as fit beside the selection state, at
// most kMaxStages (3 at k = 128); ops/topk.py merge_tf32_stages is the
// same rule.
inline int stages(int k) {
  const long room = kSmemLimit - smem_bytes(k, 0);
  const long fit = room < 0 ? 0 : room / (kStage + 16);
  return (int)(fit < kMaxStages ? fit : kMaxStages);
}

struct Args {
  const float* qlam;
  const float* xlam;
  float c1;
  int n, B, F, k, n_chunks, rows_per_chunk, stages;
  float* out_s;
  int* out_i;
};

// The batch's query rows split into their tf32 planes: hi = rna(v), lo =
// rna(v - hi), as K1's mma.sync kernel splits them in registers.
__global__ void split_queries(const float* __restrict__ q,
                              float* __restrict__ hi, float* __restrict__ lo,
                              long count) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < count;
       i += (long)gridDim.x * blockDim.x) {
    uint32_t h, l;
    asp_fold::split_tf32(q[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// The thread's A fragment of k8 step kk of a staged corpus box, split:
// rows r and r + 8, features 8kk + t and 8kk + t + 4 of the box.
__device__ __forceinline__ void load_fragment(const uint8_t* box, int r,
                                              int t, int kk,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const int c = 8 * kk + t;
  const float v[4] = {
      *reinterpret_cast<const float*>(box + sw128_offset(r, c)),
      *reinterpret_cast<const float*>(box + sw128_offset(r + 8, c)),
      *reinterpret_cast<const float*>(box + sw128_offset(r, c + 4)),
      *reinterpret_cast<const float*>(box + sw128_offset(r + 8, c + 4))};
#pragma unroll
  for (int e = 0; e < 4; ++e) asp_fold::split_tf32(v[e], hi[e], lo[e]);
}

__device__ __forceinline__ unsigned long long kth_word(float s, int id) {
  return (unsigned long long)__float_as_uint(s) << 32 | (unsigned)id;
}

__global__ void __launch_bounds__(kThreads, 1)
    merge_topk_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap lmap,
                           const Args a) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  uint8_t* const gbase = smem + (base - raw);  // base, as a pointer
  const int S = a.stages, k = a.k;
  const int nb = (a.F + kBox - 1) / kBox;  // boxes a tile
  const uint32_t xs = base;                // [S] stages
  const uint32_t full = xs + S * kStage;   // [S] barriers
  const uint32_t empty = full + 8 * S;     // [S]
  uint8_t* sel = smem + (empty + 8 * S - raw);  // the selection state
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
  const int tiles = max(0, (r1 - r0 + kTR - 1) / kTR);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
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
    if (lane == 0) {
      const int loads = tiles * nb;
      for (int step = 0; step < loads; ++step) {
        const int st = step % S;
        // the stage's previous use, once every consumer warp released it
        if (step >= S) mbar_wait(empty + 8 * st, (step / S + 1) & 1);
        const int f0 = (step % nb) * kBox;
        const uint32_t bar = full + 8 * st, dst = xs + st * kStage;
        mbar_expect_tx(bar, kStage);
        tma_load_2d(dst, &xmap, f0, r0 + (step / nb) * kTR, bar);
        tma_load_2d(dst + kXBox, &hmap, f0, q0, bar);
        tma_load_2d(dst + kXBox + kQBox, &lmap, f0, q0, bar);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = wg * kM + 16 * (warp & 3) + g;  // the thread's rows: rw, +8
  // a score is at most fl(dot - lift): the λ term c1·min(|Δλ|, 1) lies
  // between min(c1, 0) and max(c1, 0)
  const float lift = fminf(a.c1, 0.0f);

  // acc[4j + 2i + c]: row rw + 8i × query 8j + 2·t4 + c
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = part[r] = 0.0f;

  int st = 0;          // the box's stage
  uint32_t phase = 0;  // its stage's use count, mod 2
  for (int tile = 0; tile < tiles; ++tile) {
    for (int bx = 0; bx < nb; ++bx) {
      // the k8 steps of the box that hold features below F
      const int nk =
          __shfl_sync(ASP_FULL_MASK, min(kBox, a.F - bx * kBox + 7) / 8, 0);
      mbar_wait(full + 8 * st, phase);
      __syncwarp();
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) {
          load_fragment(gbase + st * kStage, rw, t4, kk, ahi[kk], alo[kk]);
          fence_operands(ahi[kk]);
          fence_operands(alo[kk]);
        }
      // the box's planes; 32 bytes a k8 step, 2 in descriptor units
      const uint32_t qhi = xs + st * kStage + kXBox;
      const uint64_t dhi = desc_sw128(qhi), dlo = desc_sw128(qhi + kQBox);
      // a slice's first k8 step starts its partial from zero
      const int odd = bx & 1;
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) {
          wgmma_m64n64k8_tf32(part, ahi[kk], dlo + 2 * kk, odd + kk > 0);
          wgmma_m64n64k8_tf32(part, alo[kk], dhi + 2 * kk, 1);
          wgmma_m64n64k8_tf32(part, ahi[kk], dhi + 2 * kk, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(part);
      // the chain has read the stage: release it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
      if (!odd && bx + 1 < nb) continue;  // the slice's second box
#pragma unroll
      for (int r = 0; r < kAcc; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
    }

    // tile complete: select its candidates and merge them
    const int gt = r0 + tile * kTR + rw;  // the thread's first row
    bool any = false;
#pragma unroll
    for (int j = 0; j < kQB / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 8 * j + 2 * t4 + c;
        const int gq = q0 + q;
        if (gq >= a.B) continue;
        const unsigned long long w = kth[q];
        const float kth_s = __uint_as_float((unsigned)(w >> 32));
        const int kth_i = (int)(unsigned)w;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float dot = acc[4 * j + 2 * i + c];
          if (__fsub_rn(dot, lift) >= kth_s) {
            const int gr = gt + 8 * i;
            if (gr >= r1) continue;
            const float sc = asp_shifted_score(dot, __ldg(a.qlam + gq),
                                               __ldg(a.xlam + gr), a.c1);
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

}  // namespace

// float32 qhat (B, F) and xhat (at least n rows of F), F a multiple of 4
// and xhat 16-byte aligned (the tensor map's rule); qlam and xlam (B,)
// and (n,) float32; out_s and out_i (B, n_chunks, k) float32 and int32;
// planes: a 16-byte-aligned float32 workspace of 2·B·F values, where the
// query rows are split (hi, then lo) on the same stream before the merge.
// Returns 0, a cudaError_t, or the CUresult of a failed tensor-map
// encoding.
extern "C" int asp_merge_topk_tf32(const void* qhat, const void* qlam,
                                   const void* xhat, const void* xlam,
                                   float c1, int n, int B, int F, int k,
                                   int n_chunks, int rows_per_chunk,
                                   void* out_s, void* out_i, void* planes,
                                   void* stream) {
  if (k < 1 || k > kMaxK || F <= 0 || F % 4 != 0 ||
      reinterpret_cast<uintptr_t>(xhat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(planes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || n <= 0) return 0;
  const int S = stages(k);
  if (S < kMinStages) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hi = static_cast<float*>(planes);
  float* lo = hi + (size_t)B * F;
  const long count = (long)B * F;
  const long blocks = (count + 255) / 256;
  split_queries<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(qhat), hi, lo, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long smem = smem_bytes(k, S);
  err = asp_allow_smem(merge_topk_tf32_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, hmap, lmap;
  int rc = encode_f32_rows(&xmap, xhat, n, F, kTR);
  if (rc == 0) rc = encode_f32_rows(&hmap, hi, B, F, kQB);
  if (rc == 0) rc = encode_f32_rows(&lmap, lo, B, F, kQB);
  if (rc != 0) return rc;
  const Args a{static_cast<const float*>(qlam),
               static_cast<const float*>(xlam),
               c1, n, B, F, k, n_chunks, rows_per_chunk, S,
               static_cast<float*>(out_s), static_cast<int*>(out_i)};
  const dim3 grid((B + kQB - 1) / kQB, n_chunks);
  merge_topk_tf32_kernel<<<grid, kThreads, (size_t)smem, s>>>(xmap, hmap,
                                                              lmap, a);
  return (int)cudaGetLastError();
}

// What a launch at (F, k) runs: out[0..6] = query block, corpus rows a
// tile, stages, dynamic shared bytes, registers a thread, local (spilled)
// bytes a thread, and the CTAs an SM holds; ops/topk.py merge_tf32_stages
// and _tf32_smem are the same rule.  Returns a cudaError_t (cudaErrorInvalidValue where F
// is not a multiple of 4 or k is outside [1, 128]).
extern "C" int asp_merge_topk_tf32_config(int F, int k, int* out) {
  if (k < 1 || k > kMaxK || F <= 0 || F % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int S = stages(k);
  const long smem = smem_bytes(k, S);
  const void* fn = reinterpret_cast<const void*>(&merge_topk_tf32_kernel);
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
  out[2] = S;
  out[3] = (int)smem;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = ctas;
  return (int)err;
}
