// K1's bf16 mode: bin-accumulator streaming λ-aware top-k on bf16
// operands, with wgmma fed by a TMA ring.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_lambda_topk with
// use_bf16=True (pallas_call :667).  It computes what bintopk.cu computes
// (the shifted score of every query and corpus row g < n, and per
// (query, chunk, bin) the top-DEPTH by (-score, lowest id) and det) on
// bf16 query and corpus rows, F a multiple of 8, products exact in fp32.
//
// What bounds it on an H100: 2·B·N·F dense bf16 operations, 6.4 ms at
// 1M×1536 and B = 2048 at 989.4 TFLOP/s.  The earlier design (bintopk.cu
// on bf16, mma.sync m16n8k16) waited on every 64-feature slice: a step
// began with a cp.async wait and a block-wide barrier, and the slice that
// arrived fed only 16 mma.sync a warp, far less than a round trip to L2;
// it ran at 11-15× this bound.  Here:
// - a CTA is two warpgroups (256 threads) holding 4096 (query, bin) pairs,
//   16 a thread, as QB = 128 queries × 32 bins (each warpgroup 64 queries
//   of the same bins) or QB = 64 × 64 bins (each warpgroup the 64 queries
//   and 32 bins of its own); a grid axis walks the groups of bins;
// - the query block arrives once per CTA by TMA, unpadded, as ceil(F/64)
//   tiles of QB rows × 64 features in the 128-byte swizzle (hopper.cuh);
//   the corpus slices of the CTA's bins arrive the same way into a ring
//   of S stages, as many as the shared memory beside the queries holds
//   (S = 8 at F = 768, QB = 128; S = 4 at F = 1536, QB = 64; at most 16);
// - each stage has a full barrier (the copy's bytes) and an empty one (a
//   release by each of the 8 warps).  At the top of each step thread 0
//   refills the stage that the previous step released, once every warp
//   has, with the slice S steps past it, so S - 1 slices are in flight
//   while one is multiplied; no block-wide barrier in the loop;
// - a slice is one wgmma.mma_async m64n32k16 bf16 chain a warpgroup (the
//   k16 steps holding features below F, the first with scale-d = 0, so
//   each 64-feature slice sums into a zeroed partial), commit, wait; then
//   one rounded fp32 add joins the partial to the running dot product, as
//   the float32 mode does (the tensor core's accumulate truncates), and
//   after a tile's last slice the fold runs;
// - wgmma's accumulators are mma.sync's m16n8 C fragment repeated over
//   four n8 blocks, so a thread holds the same 2 queries × 8 bins as the
//   mma.sync design, and the fold keeps its registers: the running
//   top-DEPTH, ids, det and λ term (common.cuh asp_shifted_score), the
//   strict-> insertion network, and the pool layout.
// Every column runs the same instruction sequence, so identical bf16 rows
// score bitwise alike.  Features past F and rows past n (the corpus map's
// row count is n) arrive as zeros; a row at or past n never enters a pool.
// What bounds it now (tools/kernel_ablation.py --kernels k1bf16, on an
// H100): a step's latency.  At 1M×1536 a 64-feature step takes 459 ns
// against 68 ns of product at the peak rate; the product alone takes 263,
// the ring alone 338.  The corpus reads from L2, (B / QB)·N·F·2 bytes a
// batch (98 GB at 1M×1536, QB = 64), run at 2.3 TB/s, below L2's rate;
// thread-block clusters with TMA multicast would cut them once the step
// is shorter.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace asp_hopper;

constexpr int kThreads = 256;      // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 4096;       // (query, bin) pairs a CTA: 16 a thread
constexpr int kFK = kRowBytes / 2; // features a slice: 64
constexpr int kMaxStages = 16;
constexpr int kMinStages = 3;
constexpr long kSmemLimit = 227 * 1024;

__host__ __device__ constexpr int n_slices(int F) {
  return (F + kFK - 1) / kFK;
}
__host__ __device__ constexpr long query_bytes(int F, int QB) {
  return (long)n_slices(F) * QB * kRowBytes;
}
__host__ __device__ constexpr long stage_bytes(int QB) {
  return (long)(kPairs / QB) * kRowBytes;
}
// The dynamic shared memory of a CTA: room to align to 1024 bytes, the
// query tiles, S stages, and a full and an empty barrier a stage plus the
// query block's.
__host__ __device__ constexpr long smem_bytes(int F, int QB, int S) {
  return kAtomBytes + query_bytes(F, QB) + S * stage_bytes(QB) +
         (2 * S + 1) * 8;
}
// Stages of the ring: as many as fit beside the query block, at most
// kMaxStages (0 when none fits).
inline int stages(int F, int QB) {
  const long room = kSmemLimit - smem_bytes(F, QB, 0);
  const long fit = room < 0 ? 0 : room / (stage_bytes(QB) + 16);
  return (int)(fit < kMaxStages ? fit : kMaxStages);
}

// The query block: 128 where its ring has kMinStages stages and B,
// rounded up to a multiple of 32, fills it, else 64 (ops/bintopk.py
// query_block is the same rule).
inline int query_block(int F, int B) {
  const int cap = (B + 31) / 32 * 32;
  return cap >= 128 && stages(F, 128) >= kMinStages ? 128 : 64;
}

struct Args {
  const float* qlam;
  const float* xlam;
  float c1;
  int n, B, F, bins, n_chunks, tiles_per_chunk, n_tiles, stages;
  float* pool_s;
  int* pool_i;
  float* det;
};

// Starts the copy of the walk's slice k (tile k / ns of the chunk,
// features (k % ns)·64, the CTA's bins from row row0 on) into stage st.
template <uint32_t kStage>
__device__ __forceinline__ void load_slice(const CUtensorMap* xmap,
                                           uint32_t xs, uint32_t full, int k,
                                           int st, int ns, int row0,
                                           int bins) {
  const uint32_t bar = full + 8 * st;
  mbar_expect_tx(bar, kStage);
  tma_load_2d(xs + st * kStage, xmap, (k % ns) * kFK, row0 + (k / ns) * bins,
              bar);
}

// Folds a completed tile into the thread's running pools: acc holds its
// dot products, its rows are gt + 8j + c (n8 block j, column c), xl their
// λ.  The λ term, then the strict-> insertion network (equal scores keep
// the lower id) and det, as bintopk.cu folds; acc is zeroed for the next.
template <int DEPTH>
__device__ __forceinline__ void fold_tile(float (&s)[DEPTH][4][4],
                                          int (&id)[DEPTH][4][4],
                                          float (&dt)[4][4],
                                          float (&acc)[4][4],
                                          const float (&ql)[2],
                                          const float (&xl)[4][2],
                                          int64_t gt, int n, float c1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t gr = gt + 8 * j + c;
      if (gr < n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * i + c;
          float cs = asp_shifted_score(acc[j][r], ql[i], xl[j][c], c1);
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
}

template <int DEPTH, int QB>
__global__ void __launch_bounds__(kThreads, 1)
    bintopk_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const Args a) {
  constexpr int kBG = kPairs / QB;           // bins a CTA: 32 or 64
  constexpr bool kSplitQ = QB == 128;        // warpgroups split the queries
  constexpr uint32_t kStage = kBG * kRowBytes;
  constexpr uint32_t kQTile = QB * kRowBytes;
  extern __shared__ uint8_t smem[];
  const uint32_t base =
      (smem_u32(smem) + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const int S = a.stages;
  const int ns = n_slices(a.F);
  const uint32_t qs = base;                        // [ns][QB rows]
  const uint32_t xs = qs + ns * kQTile;            // [S][kBG rows]
  const uint32_t full = xs + S * kStage;           // [S] barriers
  const uint32_t empty = full + 8 * S;             // [S]
  const uint32_t qbar = empty + 8 * S;

  const int bins = a.bins;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int mrow = (kSplitQ ? 64 * wg : 0) + 16 * (warp & 3);  // 16 queries
  const int wcol = kSplitQ ? 0 : 32 * wg;  // the warpgroup's 32 bins
  const int q0 = blockIdx.x * QB;
  const int ch = blockIdx.y;
  const int b0 = blockIdx.z * kBG;  // the CTA's first bin

  const int t_begin = ch * a.tiles_per_chunk;
  const int t_end = min(a.n_tiles, t_begin + a.tiles_per_chunk);
  const int total = max(0, t_end - t_begin) * ns;  // steps: a slice each

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int row0 = t_begin * bins + b0;  // the chunk's first row of the bins
  if (tid == 0 && total > 0) {
    mbar_expect_tx(qbar, ns * kQTile);
    for (int s = 0; s < ns; ++s)
      tma_load_2d(qs + s * kQTile, &qmap, s * kFK, q0, qbar);
    for (int k = 0; k < min(S, total); ++k)
      load_slice<kStage>(&xmap, xs, full, k, k, ns, row0, bins);
  }

  float ql[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gq = q0 + mrow + g + 8 * i;
    ql[i] = gq < a.B ? __ldg(a.qlam + gq) : 0.0f;
  }

  // [j][r]: n8 block j, accumulator r = query (r >> 1) × bin (r & 1)
  float s[DEPTH][4][4];
  int id[DEPTH][4][4];
  float dt[4][4];
  float acc[4][4];
  float xl[4][2];  // λ of the tile's rows, loaded at its first slice
  float part[16];  // the slice's partial: part[4j + r] is acc[j][r]'s
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dt[j][r] = ASP_NEG_INF;
      acc[j][r] = 0.0f;
      part[4 * j + r] = 0.0f;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
        s[d][j][r] = ASP_NEG_INF;
        id[d][j][r] = ASP_INT_MAX;
      }
    }

  const uint32_t a_tile = qs + (kSplitQ ? wg * 64 * kRowBytes : 0);
  const uint32_t b_rows = kSplitQ ? 0 : wg * 32 * kRowBytes;
  if (total > 0) mbar_wait(qbar, 0);
  int t = t_begin, sl = 0;  // tile and feature slice of this step
  int st = 0;               // its stage
  uint32_t phase = 0;       // its stage's use count, mod 2
  for (int step = 0; step < total; ++step) {
    // the previous step's stage, once every warp has released it, takes
    // the slice S steps past that step
    if (tid == 0 && step > 0 && step - 1 + S < total) {
      const int prev = st == 0 ? S - 1 : st - 1;
      mbar_wait(empty + 8 * prev, st == 0 ? phase ^ 1 : phase);
      load_slice<kStage>(&xmap, xs, full, step - 1 + S, prev, ns, row0, bins);
    }
    __syncwarp();
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
    mbar_wait(full + 8 * st, phase);
    // the k16 steps that hold features below F (the rest are zeros)
    const int nk = min(kFK, a.F - sl * kFK + 15) / 16;
    const uint64_t da = desc_sw128(a_tile + sl * kQTile);
    const uint64_t db = desc_sw128(xs + st * kStage + b_rows);
    fence_operands(part);
    wgmma_fence();
    wgmma_m64n32k16_bf16(part, da, db, 0);
    if (nk > 1) wgmma_m64n32k16_bf16(part, desc_k16(da, 1), desc_k16(db, 1), 1);
    if (nk > 2) wgmma_m64n32k16_bf16(part, desc_k16(da, 2), desc_k16(db, 2), 1);
    if (nk > 3) wgmma_m64n32k16_bf16(part, desc_k16(da, 3), desc_k16(db, 3), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(part);
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[j][r] = __fadd_rn(acc[j][r], part[4 * j + r]);
    if (++sl < ns) continue;
    // tile complete: fold its scores
    fold_tile<DEPTH>(s, id, dt, acc, ql, xl, gt, a.n, a.c1);
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

template <int DEPTH, int QB>
int launch(const void* qhat, const void* xhat, Args a, cudaStream_t stream) {
  a.stages = stages(a.F, QB);
  if (a.stages < kMinStages) return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(a.F, QB, a.stages);
  const cudaError_t err =
      asp_allow_smem(bintopk_bf16_kernel<DEPTH, QB>, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qmap, xmap;
  int rc = encode_bf16_rows(&qmap, qhat, a.B, a.F, QB);
  if (rc == 0) rc = encode_bf16_rows(&xmap, xhat, a.n, a.F, kPairs / QB);
  if (rc != 0) return rc;
  const dim3 grid((a.B + QB - 1) / QB, a.n_chunks, a.bins / (kPairs / QB));
  bintopk_bf16_kernel<DEPTH, QB>
      <<<grid, kThreads, (size_t)smem, stream>>>(qmap, xmap, a);
  return (int)cudaGetLastError();
}

template <int DEPTH>
int launch_qb(const void* qhat, const void* xhat, const Args& a,
              cudaStream_t stream) {
  return query_block(a.F, a.B) == 128
             ? launch<DEPTH, 128>(qhat, xhat, a, stream)
             : launch<DEPTH, 64>(qhat, xhat, a, stream);
}

// The attributes of the instantiation a launch at (F, B, depth) takes.
template <int DEPTH>
cudaError_t attributes(int qb, cudaFuncAttributes* attr) {
  return qb == 128 ? cudaFuncGetAttributes(attr, bintopk_bf16_kernel<DEPTH, 128>)
                   : cudaFuncGetAttributes(attr, bintopk_bf16_kernel<DEPTH, 64>);
}

}  // namespace

// bf16 qhat (B, F) and xhat (at least ceil(n/bins)·bins rows of F), F a
// multiple of 8 and both 16-byte aligned (the tensor maps' rule); qlam,
// xlam and the outputs float32.  Returns 0, a cudaError_t, or the
// CUresult of a failed tensor-map encoding.
extern "C" int asp_bintopk_bf16(const void* qhat, const void* qlam,
                                const void* xhat, const void* xlam, float c1,
                                int n, int B, int F, int bins, int depth,
                                int n_chunks, int tiles_per_chunk,
                                void* pool_s, void* pool_i, void* det,
                                void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (F <= 0 || F % 8 != 0 || reinterpret_cast<uintptr_t>(qhat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xhat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (bins != 128 && bins != 256 && bins != 512)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(qlam),
               static_cast<const float*>(xlam),
               c1, n, B, F, bins, n_chunks, tiles_per_chunk,
               (n + bins - 1) / bins, 0,
               static_cast<float*>(pool_s), static_cast<int*>(pool_i),
               static_cast<float*>(det)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 2: return launch_qb<2>(qhat, xhat, a, s);
    case 3: return launch_qb<3>(qhat, xhat, a, s);
    case 4: return launch_qb<4>(qhat, xhat, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What a launch at (F, B, depth) runs: out[0..5] = query block, stages,
// dynamic shared bytes, registers a thread, local (spilled) bytes a
// thread, and the kernel's largest block.  Returns a cudaError_t.
extern "C" int asp_bintopk_bf16_config(int F, int B, int depth, int* out) {
  const int qb = query_block(F, B);
  const int S = stages(F, qb);
  cudaFuncAttributes attr{};
  cudaError_t err;
  switch (depth) {
    case 2: err = attributes<2>(qb, &attr); break;
    case 3: err = attributes<3>(qb, &attr); break;
    case 4: err = attributes<4>(qb, &attr); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = qb;
  out[1] = S;
  out[2] = (int)smem_bytes(F, qb, S);
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = attr.maxThreadsPerBlock;
  return (int)err;
}
