// K1's float32 route at narrow widths: bin-accumulator streaming λ-aware
// top-k, its 3×TF32 product on wgmma fed by a TMA ring.
//
// Replaces arrowspace_tpu/ops/pallas_bintopk.py binned_lambda_topk
// (pallas_call :667) where ops/bintopk.py tf32_route admits the launch:
// F a multiple of 4, the split query block and a ring of at least 3
// stages within the shared memory (F <= 352), and a batch of at least 64
// queries.  It computes what bintopk.cu computes, bitwise: the shifted
// score of every query and corpus row g < n, and per (query, chunk, bin)
// the top-DEPTH by (-score, lowest id) and det.
//
// What bounds it on an H100: the B×N×F products in 3×TF32 (2.94 ms at
// 1.18M × 100 and B = 2048, at 494.7 TFLOP/s).  bintopk.cu issues them as
// mma.sync m16n8k8 and runs at a sixth of that rate (the split product
// alone takes two thirds to three quarters of its time); wgmma is the
// only way to the full rate.  The design:
// - a CTA is two warpgroups (256 threads) holding 4096 (query, bin) pairs,
//   16 a thread, as 64 queries × 64 bins: each warpgroup multiplies the
//   same 64 corpus rows (the bins, wgmma's M) by its own 32 queries (N),
//   so a thread holds 2 bins × 8 queries; a grid axis walks the groups of
//   64 bins;
// - the corpus is the A operand, from registers: each thread loads its
//   fragment of a k8 step from the staged float32 slice and splits it
//   there, hi = rna(v) and lo = rna(v - hi) (binned_fold.cuh split_tf32),
//   so the corpus is read as float32 and never stored split;
// - the query block is the B operand, from shared memory: split once per
//   CTA into two resident planes, hi and lo, of ceil(ceil8(F)/32) boxes of
//   64 query rows × 32 tf32 features in the 128-byte swizzle;
// - the corpus slices (64 rows × 64 features of a tile, as two 32-feature
//   boxes) arrive by TMA, zeros past F and past row n, into a ring of S
//   stages (as many as fit beside the query planes, at most 16).  Each
//   stage has a full barrier (the copy's bytes) and an empty one (one
//   arrival a warp, once its chain is issued).  Thread 0 refills, at the
//   top of each step, the stage of the step `lag` steps back (S / 2) with
//   the slice S steps past that one, so the two warpgroups may drift
//   apart by up to lag steps (one folds while the other multiplies) and
//   S - lag slices are in flight; no block-wide barrier in the loop;
// - a 64-feature slice is one wgmma m64n32k8 chain a warpgroup: at each
//   k8 step below F, hi_x·lo_q, then lo_x·hi_q, then hi_x·hi_q, the first
//   with scale-d = 0, so the slice sums into a zeroed partial that one
//   rounded fp32 add joins to the running dot product.  That is
//   bintopk.cu's sequence with A and B exchanged (each product is exact
//   in fp32, and the tensor core sums a k8 step's products alike either
//   way), so the two kernels, and K3, score a pair bitwise alike (the
//   repair merges K3's rows with K1's).  DEPTH 4 issues a slice as two
//   chains of 4 k8 steps, waited for in turn, so that its pools and the
//   fragments fit the registers;
// - the fold is bintopk.cu's on the exchanged fragment: after a tile's
//   last slice each thread applies the λ term (common.cuh
//   asp_shifted_score) to its 16 pairs and runs the strict-> insertion
//   network (equal scores keep the lower id) and det in registers, and
//   the pools are written in the same layout.
// Every column runs the same instruction sequence, so identical corpus
// rows score bitwise alike; a row at or past n never enters a pool.
// What bounds it now (tools/kernel_ablation.py --kernels k1tf32, H100): a
// warpgroup's step is serial, the fragments' loads and split, then the
// chain of 24 dependent wgmma, then the fold, and the two warpgroups
// overlap each other only in part: at 1.18M × 100 the kernel takes 4.5×
// its bound, the product alone 2.9×, the ring alone 1.7× (15 GB of
// corpus slices from L2 a batch: each of the 32 query blocks reads the
// whole corpus), and taking out the fold, the split or two of the three
// products each saves a fifth.  A second slice's chain or a second set
// of fragments kept in flight beside a chain spilled registers or made
// ptxas serialize the wgmma (C7518); the fold deferred under the next
// chain saved nothing.
#include "binned_fold.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace asp_hopper;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;              // queries a CTA, 32 a warpgroup
constexpr int kBG = 64;              // bins a CTA, wgmma's M
constexpr int kBox = kRowBytes / 4;  // tf32 features a swizzled row: 32
constexpr int kFK = 2 * kBox;        // features a slice: 64
constexpr int kQBox = kQB * kRowBytes;  // a query plane's box: 8192 bytes
constexpr int kXBox = kBG * kRowBytes;  // a stage's box: 8192 bytes
constexpr int kStage = 2 * kXBox;
constexpr int kMaxStages = 16;
constexpr int kMinStages = 3;
constexpr long kSmemLimit = 227 * 1024;

// 32-feature boxes of a query plane: F rounded up to whole k8 steps.
__host__ __device__ constexpr int query_boxes(int F) {
  return ((F + 7) / 8 * 8 + kBox - 1) / kBox;
}
// The dynamic shared memory of a CTA: room to align to 1024 bytes, the
// hi and lo query planes, S stages, a full and an empty barrier a stage.
__host__ __device__ constexpr long smem_bytes(int F, int S) {
  return kAtomBytes + 2L * query_boxes(F) * kQBox + (long)S * (kStage + 16);
}
// Stages of the ring: as many as fit beside the query planes, at most
// kMaxStages (0 when none fits).
inline int stages(int F) {
  const long room = kSmemLimit - smem_bytes(F, 0);
  const long fit = room < 0 ? 0 : room / (kStage + 16);
  return (int)(fit < kMaxStages ? fit : kMaxStages);
}

struct Args {
  const float* qrows;
  const float* qlam;
  const float* xlam;
  float c1;
  int n, B, F, bins, n_chunks, tiles_per_chunk, n_tiles, stages;
  float* pool_s;
  int* pool_i;
  float* det;
};

// Starts the copy of the walk's slice k (tile k / ns of the chunk,
// features (k % ns)·64, the CTA's bins from row row0 on) into stage st:
// the boxes that hold a feature below F.
__device__ __forceinline__ void load_slice(const CUtensorMap* xmap,
                                           uint32_t xs, uint32_t full, int k,
                                           int st, int ns, int row0, int bins,
                                           int F) {
  const int f0 = (k % ns) * kFK;
  const int boxes = (min(kFK, F - f0) + kBox - 1) / kBox;
  const uint32_t bar = full + 8 * st;
  const int row = row0 + (k / ns) * bins;
  mbar_expect_tx(bar, boxes * kXBox);
  tma_load_2d(xs + st * kStage, xmap, f0, row, bar);
  if (boxes > 1)
    tma_load_2d(xs + st * kStage + kXBox, xmap, f0 + kBox, row, bar);
}

// What k8 step kk of a slice adds to a query plane's descriptor: its box
// (kk / 4, kQBox bytes on) and 32 bytes a step inside the box, in the
// descriptor's 16-byte units.
__device__ __forceinline__ uint64_t step_desc(int kk) {
  return (uint64_t)(((kk / 4) * kQBox + (kk % 4) * 32) >> 4);
}

// The thread's A fragment of k8 step kk of a staged slice, split: rows r
// and r + 8 (r mod 8 = g), features 8kk + t and 8kk + t + 4.
__device__ __forceinline__ void load_fragment(const uint8_t* stage, int r,
                                              int t, int kk,
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  const uint8_t* box = stage + (kk / 4) * kXBox;
  const int c = 8 * (kk % 4) + t;
  const float v[4] = {
      *reinterpret_cast<const float*>(box + sw128_offset(r, c)),
      *reinterpret_cast<const float*>(box + sw128_offset(r + 8, c)),
      *reinterpret_cast<const float*>(box + sw128_offset(r, c + 4)),
      *reinterpret_cast<const float*>(box + sw128_offset(r + 8, c + 4))};
#pragma unroll
  for (int e = 0; e < 4; ++e) asp_fold::split_tf32(v[e], hi[e], lo[e]);
}

template <int DEPTH>
__global__ void __launch_bounds__(kThreads, 1)
    bintopk_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                        const Args a) {
  // k8 steps a chain: a whole slice, or at DEPTH 4 half of one
  constexpr int kGroup = DEPTH >= 4 ? 4 : 8;
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  uint8_t* const gbase = smem + (base - raw);  // base, as a pointer
  const int S = a.stages;
  const int nb = query_boxes(a.F);
  const int ns = (a.F + kFK - 1) / kFK;       // slices a tile
  const uint32_t qhi = base;                  // [nb][kQB rows]
  const uint32_t qlo = qhi + nb * kQBox;      // [nb][kQB rows]
  const uint32_t xs = qlo + nb * kQBox;       // [S][2 boxes][kBG rows]
  const uint32_t full = xs + S * kStage;      // [S] barriers
  const uint32_t empty = full + 8 * S;        // [S]

  const int bins = a.bins;
  const int tid = threadIdx.x;
  // the warp's index, uniform to the compiler (a shuffle)
  const int lane = tid & 31, warp = __shfl_sync(ASP_FULL_MASK, tid >> 5, 0);
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // the thread's bins: r0 and r0 + 8
  const int qc = 32 * wg + 2 * t4;     // its queries: qc + 8j + c
  const int q0 = blockIdx.x * kQB;
  const int ch = blockIdx.y;
  const int b0 = blockIdx.z * kBG;  // the CTA's first bin

  const int t_begin = ch * a.tiles_per_chunk;
  const int t_end = min(a.n_tiles, t_begin + a.tiles_per_chunk);
  const int total = max(0, t_end - t_begin) * ns;  // steps: a slice each
  const int lag = max(1, S / 2);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWarps);
    }
    fence_barrier_init();
  }
  const int row0 = t_begin * bins + b0;  // the chunk's first row of the bins
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < min(S, total); ++k)
      load_slice(&xmap, xs, full, k, k, ns, row0, bins, a.F);

  // the query block, split into its planes (zeros past B and past F);
  // written by the generic proxy, read by wgmma's async proxy
  for (int idx = tid; idx < kQB * nb * kBox; idx += kThreads) {
    const int q = idx / (nb * kBox), f = idx % (nb * kBox);
    const int gq = q0 + q;
    const float v =
        gq < a.B && f < a.F ? __ldg(a.qrows + (size_t)gq * a.F + f) : 0.0f;
    uint32_t hi, lo;
    asp_fold::split_tf32(v, hi, lo);
    const uint32_t off = (f / kBox) * kQBox + sw128_offset(q, f % kBox);
    *reinterpret_cast<uint32_t*>(gbase + off) = hi;
    *reinterpret_cast<uint32_t*>(gbase + nb * kQBox + off) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float ql[8];  // λ of the thread's queries qc + 8j + c, at [2j + c]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gq = q0 + qc + 8 * j + c;
      ql[2 * j + c] = gq < a.B ? __ldg(a.qlam + gq) : 0.0f;
    }

  // [r]: accumulator r = 4j + 2i + c, bin r0 + 8i × query qc + 8j + c
  float s[DEPTH][16];
  int id[DEPTH][16];
  float dt[16];
  float acc[16];
  float part[16];  // the slice's partial
  float xl[2];     // λ of the tile's rows, loaded at its first slice
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    dt[r] = ASP_NEG_INF;
    acc[r] = 0.0f;
    part[r] = 0.0f;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      s[d][r] = ASP_NEG_INF;
      id[d][r] = ASP_INT_MAX;
    }
  }

  const uint32_t qrow = wg * 32 * kRowBytes;  // the warpgroup's queries
  int t = t_begin, sl = 0;  // tile and feature slice of this step
  int st = 0;               // its stage
  uint32_t phase = 0;       // its stage's use count, mod 2
  for (int step = 0; step < total; ++step) {
    // the stage of the step lag steps back, once every warp has released
    // it, takes the slice S steps past that step
    if (tid == 0 && step >= lag && step - lag + S < total) {
      const int k = step - lag;
      mbar_wait(empty + 8 * (k % S), (k / S) & 1);
      load_slice(&xmap, xs, full, k + S, k % S, ns, row0, bins, a.F);
    }
    __syncwarp();
    const int64_t gt = (int64_t)t * bins + b0 + r0;  // the thread's first row
    if (sl == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        xl[i] = gt + 8 * i < a.n ? __ldg(a.xlam + gt + 8 * i) : 0.0f;
    }
    // the k8 steps that hold features below F (the rest are zeros)
    const int nk = __shfl_sync(ASP_FULL_MASK,
                               (min(kFK, a.F - sl * kFK) + 7) / 8, 0);
    mbar_wait(full + 8 * st, phase);
    __syncwarp();
    const uint8_t* stage = gbase + (xs - base) + st * kStage;
    const uint64_t dhi = desc_sw128(qhi + 2 * sl * kQBox + qrow);
    const uint64_t dlo = desc_sw128(qlo + 2 * sl * kQBox + qrow);
#pragma unroll
    for (int k0 = 0; k0 < 8; k0 += kGroup) {
      if (k0 >= nk) break;
      uint32_t ahi[kGroup][4], alo[kGroup][4];
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk)
        if (k0 + kk < nk) {
          load_fragment(stage, r0, t4, k0 + kk, ahi[kk], alo[kk]);
          fence_operands(ahi[kk]);
          fence_operands(alo[kk]);
        }
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGroup; ++kk)
        if (k0 + kk < nk) {
          const uint64_t k8 = step_desc(k0 + kk);
          wgmma_m64n32k8_tf32(part, ahi[kk], dlo + k8, k0 + kk > 0);
          wgmma_m64n32k8_tf32(part, alo[kk], dhi + k8, 1);
          wgmma_m64n32k8_tf32(part, ahi[kk], dhi + k8, 1);
        }
      wgmma_commit();
      // the stage is free once the last chain of its slice is issued
      if (k0 + kGroup >= nk) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * st);
      }
      wgmma_wait_all();
      fence_operands(part);
    }
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
    if (++sl < ns) continue;

    // tile complete: fold its scores
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t gr = gt + 8 * i;
      if (gr < a.n) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            float cs = asp_shifted_score(acc[r], ql[2 * j + c], xl[i], a.c1);
            int ci = (int)gr;
#pragma unroll
            for (int d = 0; d < DEPTH; ++d) {
              const bool up = cs > s[d][r];
              const float ts = s[d][r];
              const int ti = id[d][r];
              s[d][r] = up ? cs : ts;
              id[d][r] = up ? ci : ti;
              cs = up ? ts : cs;
              ci = up ? ti : ci;
            }
            dt[r] = fmaxf(dt[r], cs);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
    ++t;
    sl = 0;
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gq = q0 + qc + 8 * j + c;
      if (gq >= a.B) continue;
      const int64_t row = (int64_t)gq * a.n_chunks + ch;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + r0 + 8 * i;
        const int r = 4 * j + 2 * i + c;
        a.det[row * bins + b] = dt[r];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          a.pool_s[(row * DEPTH + d) * bins + b] = s[d][r];
          a.pool_i[(row * DEPTH + d) * bins + b] = id[d][r];
        }
      }
    }
}

template <int DEPTH>
int launch(const void* xhat, Args a, cudaStream_t stream) {
  a.stages = stages(a.F);
  if (a.stages < kMinStages) return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes(a.F, a.stages);
  const cudaError_t err =
      asp_allow_smem(bintopk_tf32_kernel<DEPTH>, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap;
  const int rc = encode_f32_rows(&xmap, xhat, a.n, a.F, kBG);
  if (rc != 0) return rc;
  const dim3 grid((a.B + kQB - 1) / kQB, a.n_chunks, a.bins / kBG);
  bintopk_tf32_kernel<DEPTH>
      <<<grid, kThreads, (size_t)smem, stream>>>(xmap, a);
  return (int)cudaGetLastError();
}

template <int DEPTH>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, bintopk_tf32_kernel<DEPTH>);
}

}  // namespace

// float32 qhat (B, F) and xhat (at least ceil(n/bins)·bins rows of F), F
// a multiple of 4 and xhat 16-byte aligned (the tensor map's rule); qlam,
// xlam and the outputs float32; the arguments and outputs of
// asp_bintopk.  Returns 0, a cudaError_t (cudaErrorInvalidValue where
// the ring does not fit), or the CUresult of a failed tensor-map
// encoding.
extern "C" int asp_bintopk_tf32(const void* qhat, const void* qlam,
                                const void* xhat, const void* xlam, float c1,
                                int n, int B, int F, int bins, int depth,
                                int n_chunks, int tiles_per_chunk,
                                void* pool_s, void* pool_i, void* det,
                                void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (F <= 0 || F % 4 != 0 || reinterpret_cast<uintptr_t>(xhat) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (bins != 128 && bins != 256 && bins != 512)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(qhat),
               static_cast<const float*>(qlam),
               static_cast<const float*>(xlam),
               c1, n, B, F, bins, n_chunks, tiles_per_chunk,
               (n + bins - 1) / bins, 0,
               static_cast<float*>(pool_s), static_cast<int*>(pool_i),
               static_cast<float*>(det)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 2: return launch<2>(xhat, a, s);
    case 3: return launch<3>(xhat, a, s);
    case 4: return launch<4>(xhat, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// What a launch at (F, depth) runs: out[0..5] = query block, stages,
// dynamic shared bytes, registers a thread, local (spilled) bytes a
// thread, and the kernel's largest block.  Returns a cudaError_t.
extern "C" int asp_bintopk_tf32_config(int F, int depth, int* out) {
  const int S = stages(F);
  cudaFuncAttributes attr{};
  cudaError_t err;
  switch (depth) {
    case 2: err = attributes<2>(&attr); break;
    case 3: err = attributes<3>(&attr); break;
    case 4: err = attributes<4>(&attr); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = kQB;
  out[1] = S;
  out[2] = (int)smem_bytes(F, S);
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  out[5] = attr.maxThreadsPerBlock;
  return (int)err;
}
