// The synthetic-λ body of K2 (taulambda.cu, τ + λ) and K5 (lambda_batch.cu,
// λ given τ), on the tensor cores.
//
// Per item row x with graph coordinates xₙ = x[:n], against the graph L
// (n×n), W = max(-L, 0) off the diagonal and W2 = W∘W, it computes the
// five quadratic forms of the λ formula (asp_lambda_of, common.cuh)
//   num = xₙᵀLxₙ, xwx = xₙᵀWxₙ, tb = x²ᵀW2x², tc = xᵀW2x³, td = x³ᵀW2x.
// As products of the CTA's item tile X (rows × graph columns j) with the
// graph's rows i they are five GEMMs with shared operands,
//   P_L = X·Lᵀ, P_W = X·Wᵀ, P_A = X²·W2ᵀ, P_B = X³·W2ᵀ, P_C = X·W2ᵀ,
// folded per row with the coordinates of node i:
//   num = Σᵢ xᵢ·P_L, xwx = Σᵢ xᵢ·P_W, tb = Σᵢ xᵢ²·P_A, tc = Σᵢ xᵢ·P_B,
//   td = Σᵢ xᵢ³·P_C.
//
// What bounds it on an H100: the products, 5·n² multiply-adds a row
// (171 GFMA at 688128 rows and n = 185).  They run on the tensor cores
// as K1's 3×TF32 mma.sync m16n8k8 (binned_fold.cuh):
// every fp32 operand v split in registers into hi = rna(v) and lo =
// rna(v - hi), lo·hi, hi·lo, hi·hi accumulated in fp32 (3·10·n² TF32
// flops a row, 1.43 ms at 494.7 TFLOP/s for K5's window).  The design:
// - a CTA holds kRows = 64 item rows in shared memory (the caller stages
//   them: row stride S ≡ 4 (mod 8), graph columns at or past n stored as
//   0) and is 8 warps: 4 m-tiles of 16 rows × 2 groups that split the
//   graph rows i of a pass; a warp holds 16 rows × 8·kNT graph rows of
//   each of the five products (kNT = 2: 128 registers, two CTAs an SM
//   where shared memory allows; kNT = 4 needs 171 registers, one CTA an
//   SM, and ran 1.65-2.3 times slower, tools/kernel_ablation.py);
// - the graph streams from L2 (3·n² floats, the same for every CTA) by
//   cp.async in slices of kNI graph rows × 64 graph columns of L, W and
//   W2 (binned_fold.cuh stage_rows; rows and columns at or past n staged
//   as 0, so they add nothing), two buffers, one barrier a step.  The
//   graph operands are split in registers at each k-step: passing them
//   unsplit (the most that splitting them once per launch could save,
//   at twice the staged bytes and shared memory) saves 6-8 %;
// - at each k-step of 8 graph columns a warp loads its A fragment of X
//   once, forms x² = x·x and x³ = x²·x from it (rounded as the plain
//   version forms them) and splits the three, and splits the B fragments
//   of L, W and W2 of each n-tile: X meets L, W and W2, and the slice of
//   W2 meets X, X² and X³ (15 mma.sync an n-tile);
// - the tensor core's accumulate truncates, and here the forms cancel:
//   on rows whose values lie close together S and G's numerator are small
//   differences of large moments, so a one-sided error of the products
//   moves λ by far more than their size.  Each k-step's three products
//   (small terms first) therefore sum into a partial from a zero
//   accumulator, which one rounded fp32 add joins to the running product
//   P of its (row, node).  Partials of 32 graph columns put K5's λ 4.6
//   times the plain float32 version's distance from float64 on rows 0.5 ±
//   0.05 (measured on the card); a partial per k-step 1.4-1.6 times
//   (tests/test_torch_lambda_tc.py emulates it);
// - the fold is the epilogue of a pass: each P of (row, node i) times xᵢ,
//   xᵢ² or xᵢ³ of its row, read from the item tile, is added to the row's
//   five sums (one rounded multiply-add each); after the last pass the
//   four threads of a quad that share a row sum by shuffles, the two
//   groups through shared memory (red).
// Every item row runs the same instruction sequence whatever its place in
// the CTA, so identical rows get bitwise identical λ.
#pragma once

#include "binned_fold.cuh"

namespace asp_lambda {

constexpr int kThreads = asp_fold::kThreads;  // 8 warps (stage_rows')
constexpr int kRows = 64;                     // item rows a CTA
constexpr int kGroups = 2;   // warps that split the graph rows of a pass
constexpr int kNT = 2;       // n-tiles of 8 graph rows a warp
constexpr int kNI = kGroups * 8 * kNT;  // graph rows a pass
constexpr int kFK = asp_fold::kTileFK;  // graph columns a staged slice
constexpr int kXS = asp_fold::kTileXS;  // row stride of a staged slice
constexpr int kSums = 5;     // num, xwx, tb, tc, td
static_assert(kRows / 16 * kGroups == kThreads / 32, "8 warps tile the CTA");
// Two CTAs an SM where shared memory allows (K5's n, K2's F up to 224):
// one streams its rows (and τ) while the other multiplies.  The kernels'
// launch bounds hold a thread to 128 registers.
constexpr int kCtasPerSm = 2;

// Floats of shared memory the body uses beside the item tile: two buffers
// of the three graph slices, and the two groups' per-row sums.
constexpr int kGraphFloats = 2 * 3 * kNI * kXS;
constexpr int kRedFloats = kGroups * kSums * kRows;

// The item tile's row stride for rows of `cols` values: whole k-steps,
// plus 4 (≡ 4 mod 8: lane (g, t) of a fragment load reads a bank of its
// own).
__host__ __device__ constexpr int tile_stride(int cols) {
  return (cols + 7) / 8 * 8 + 4;
}

// Shared memory of a CTA: the item tile of rows of `cols` values, the
// graph slices, the per-group sums and the kernel's `row_scalars` sums a
// row (ops/lambda_batch.py lambda_tile_floats mirrors it).
__host__ __device__ constexpr size_t smem_bytes(int cols, int row_scalars) {
  return ((size_t)kRows * tile_stride(cols) + kGraphFloats + kRedFloats +
          (size_t)row_scalars * kRows) *
         sizeof(float);
}

// Whether the graph slices may be staged 16 bytes at a time: n is a
// multiple of 4 and L, W and W2 are 16-byte aligned.
inline bool graph_vec(int n, const void* L, const void* W, const void* W2) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(W2) % 16 == 0;
}

// d = a · b on one m16n8k8 tile, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

// P += lo·hi + hi·lo + hi·hi of one k-step on one m16n8k8 tile, in K1's
// order, summed from zero and joined to P with one rounded add.
__device__ __forceinline__ void join3(float (&P)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0,
                                      uint32_t bh1, uint32_t bl0,
                                      uint32_t bl1) {
  float d[4];
  mma_tf32_zero(d, al, bh0, bh1);
  asp_fold::mma_tf32(d, ah, bl0, bl1);
  asp_fold::mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int r = 0; r < 4; ++r) P[r] = __fadd_rn(P[r], d[r]);
}

// One k-step of 8 graph columns for a warp's 16 item rows × 8·kNT graph
// rows: xa points at the thread's A element (row g, column t) of the item
// tile (stride S), gb at its B element (graph row g of n-tile 0, column
// t) of the staged L slice, which W's and W2's follow; n-tiles at or past
// nt_live are skipped (warp-uniform).
__device__ __forceinline__ void kstep(float (&P)[kSums][kNT][4],
                                      const float* xa, int S,
                                      const float* gb, int nt_live) {
  uint32_t h1[4], l1[4], h2[4], l2[4], h3[4], l3[4];
  const int off[4] = {0, 8 * S, 4, 8 * S + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x1 = xa[off[e]];
    const float x2 = x1 * x1;
    const float x3 = x2 * x1;
    asp_fold::split_tf32(x1, h1[e], l1[e]);
    asp_fold::split_tf32(x2, h2[e], l2[e]);
    asp_fold::split_tf32(x3, h3[e], l3[e]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt_live) break;
    const float* b = gb + j * 8 * kXS;
    uint32_t lh0, ll0, lh1, ll1, wh0, wl0, wh1, wl1, vh0, vl0, vh1, vl1;
    asp_fold::split_tf32(b[0], lh0, ll0);
    asp_fold::split_tf32(b[4], lh1, ll1);
    asp_fold::split_tf32(b[kNI * kXS], wh0, wl0);
    asp_fold::split_tf32(b[kNI * kXS + 4], wh1, wl1);
    asp_fold::split_tf32(b[2 * kNI * kXS], vh0, vl0);
    asp_fold::split_tf32(b[2 * kNI * kXS + 4], vh1, vl1);
    join3(P[0][j], h1, l1, lh0, lh1, ll0, ll1);  // X·Lᵀ
    join3(P[1][j], h1, l1, wh0, wh1, wl0, wl1);  // X·Wᵀ
    join3(P[2][j], h2, l2, vh0, vh1, vl0, vl1);  // X²·W2ᵀ
    join3(P[3][j], h3, l3, vh0, vh1, vl0, vl1);  // X³·W2ᵀ
    join3(P[4][j], h1, l1, vh0, vh1, vl0, vl1);  // X·W2ᵀ
  }
}

// Adds a pass's products to the row sums s[k][h] (h = 0: row g, 1: row
// g+8): xr points at the thread's row g of the item tile, at its first
// node (graph row i of n-tile 0, column 2t).
__device__ __forceinline__ void fold(float (&s)[kSums][2],
                                     const float (&P)[kSums][kNT][4],
                                     const float* xr, int S, int nt_live) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt_live) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x1 = xr[h * 8 * S + j * 8 + c];
        const float x2 = x1 * x1;
        const float x3 = x2 * x1;
        const int r = 2 * h + c;
        s[0][h] = fmaf(x1, P[0][j][r], s[0][h]);
        s[1][h] = fmaf(x1, P[1][j][r], s[1][h]);
        s[2][h] = fmaf(x2, P[2][j][r], s[2][h]);
        s[3][h] = fmaf(x1, P[3][j][r], s[3][h]);
        s[4][h] = fmaf(x3, P[4][j][r], s[4][h]);
      }
  }
}

__device__ __forceinline__ void stage_graph(float* dst, const float* L,
                                            const float* W, const float* W2,
                                            int i0, int n, int j0, bool vec,
                                            int tid) {
  asp_fold::stage_rows<kNI>(dst, L, i0, n, n, j0, vec, tid);
  asp_fold::stage_rows<kNI>(dst + kNI * kXS, W, i0, n, n, j0, vec, tid);
  asp_fold::stage_rows<kNI>(dst + 2 * kNI * kXS, W2, i0, n, n, j0, vec, tid);
}

// The five forms of the CTA's kRows item rows: xs is the item tile
// (stride S, columns n .. round8(n) - 1 zero), gs kGraphFloats of shared
// memory for the graph slices; on return (after a barrier) red[(grp *
// kSums + k) * kRows + r] holds group grp's share of form k of row r.
// vec: n is a multiple of 4 and L, W, W2 are 16-byte aligned.
__device__ __forceinline__ void forms(const float* xs, int S,
                                      const float* __restrict__ L,
                                      const float* __restrict__ W,
                                      const float* __restrict__ W2, int n,
                                      bool vec, float* gs, float* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp % (kRows / 16)) * 16;  // the warp's item rows
  const int grp = warp / (kRows / 16);
  const int n8 = (n + 7) & ~7;
  const int slices = (n8 + kFK - 1) / kFK;
  const int passes = (n8 + kNI - 1) / kNI;
  const int steps = passes * slices;

  stage_graph(gs, L, W, W2, 0, n, 0, vec, tid);
  asp_fold::cp_async_commit();

  float s[kSums][2] = {};
  float P[kSums][kNT][4];
  for (int step = 0; step < steps; ++step) {
    const int pass = step / slices, sl = step % slices;
    // wait for this step's slices; the barrier also frees the other
    // buffer, which the last step read, for the next step's
    asp_fold::cp_async_wait_all();
    __syncthreads();
    if (step + 1 < steps) {
      const int p1 = (step + 1) / slices, s1 = (step + 1) % slices;
      stage_graph(gs + ((step + 1) & 1) * 3 * kNI * kXS, L, W, W2, p1 * kNI,
                  n, s1 * kFK, vec, tid);
    }
    asp_fold::cp_async_commit();

    const int i0 = pass * kNI + grp * 8 * kNT;  // the warp's first node
    const int nt_live = min(kNT, (n8 - i0) / 8);
    if (nt_live <= 0) continue;
    if (sl == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) P[k][j][r] = 0.0f;
    }
    const int j0 = sl * kFK;
    const int fk = min(kFK, n8 - j0);
    const float* gb = gs + (step & 1) * 3 * kNI * kXS +
                      (grp * 8 * kNT + g) * kXS + t4;
    const float* xa = xs + (m0 + g) * S + j0 + t4;
    if (fk == kFK) {
#pragma unroll
      for (int kk = 0; kk < kFK; kk += 8)
        kstep(P, xa + kk, S, gb + kk, nt_live);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < fk; kk += 8)
        kstep(P, xa + kk, S, gb + kk, nt_live);
    }
    if (sl == slices - 1)
      fold(s, P, xs + (m0 + g) * S + i0 + 2 * t4, S, nt_live);
  }

  // the quad's four threads share rows g and g+8
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[k][h] += __shfl_xor_sync(ASP_FULL_MASK, s[k][h], 1);
      s[k][h] += __shfl_xor_sync(ASP_FULL_MASK, s[k][h], 2);
    }
  if (t4 == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(grp * kSums + k) * kRows + m0 + g + 8 * h] = s[k][h];
  }
  __syncthreads();
}

// λ of item row r of the tile from its row sums and the forms in red.
__device__ __forceinline__ float lambda_of_row(const float* red, int r,
                                               float tau, float den,
                                               float s_part, float ta) {
  float f[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
    f[k] = red[k * kRows + r] + red[(kSums + k) * kRows + r];
  return asp_lambda_of(tau, den, s_part, ta, f[0], f[1], f[2], f[3], f[4]);
}

}  // namespace asp_lambda
