// Hopper's asynchronous pieces, as the bf16 modes of K1 (bintopk_bf16.cu)
// and K3 (merge_topk_bf16.cu), K1's float32 wgmma route (bintopk_tf32.cu)
// and float32 K3 (merge_topk_tf32.cu) use them: TMA tensor
// copies of 2-D bf16 or float32 tiles into shared memory in the 128-byte
// swizzle, mbarriers that count their bytes and the warps that release a
// buffer, named barriers over some of a CTA's warps, wgmma m64n32k16 and
// m64n64k16 bf16 products whose operands both lie in shared memory, named
// by matrix descriptors, and wgmma m64n32k8 and m64n64k8 tf32 products
// with A in registers.
//
// A tile here is rows of 128 bytes, 64 bf16 or 32 tf32 features each:
// exactly the span of the 128-byte swizzle, so a row is never padded.  TMA
// writes row r's 16-byte chunk c at chunk c ^ (r mod 8) of the row; a
// group of 8 rows (1024 bytes) is one swizzle atom, and every tile starts
// on a 1024-byte boundary, which the descriptors' zero base offset
// assumes.  A K-major descriptor of such a tile: start address >> 4,
// leading byte offset 1 (unused by swizzled K-major layouts), stride byte
// offset 1024 >> 4 (the next 8 rows), layout 1 (128-byte swizzle) in bits
// 62-63.  A k16 step
// of bf16 or a k8 step of tf32 (32 bytes of a row) advances the start
// address by 32 bytes; the swizzle is a function of the address bits, so
// the hardware finds the chunks.
//
// The tensor maps are encoded on the host at each launch (the pointers
// change) through cuTensorMapEncodeTiled, looked up by the CUDA
// runtime's entry-point query, so that the library needs no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace asp_hopper {

constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16
constexpr int kAtomBytes = 1024; // 8 rows, the swizzle atom and alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared-memory addresses) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also expects `bytes` more from TMA copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed.  A wait
// still open after 2^35 clocks (about 20 s; a slice takes microseconds)
// means a copy or an arrival was lost: the kernel traps, and the launch
// fails, rather than holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// Waits at named barrier id (1-15; 0 is __syncthreads) until `threads`
// threads, whole warps, have arrived.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The same barrier, returning on every thread whether any thread's v
// was true.
__device__ __forceinline__ bool bar_sync_or(int id, int threads, bool v) {
  uint32_t any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.u32 q, %1, 0;\n"
      " bar.red.or.pred p, %2, %3, q;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"((uint32_t)v), "r"(id), "r"(threads)
      : "memory");
  return any != 0;
}

// ---- TMA ----

// Copies the box at (c0 = feature, c1 = row) of the map's tensor into
// shared memory at dst; its bytes complete on bar.  Elements out of the
// tensor's bounds arrive as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---- wgmma ----

// K-major descriptor of a 128-byte-swizzled tile at shared address addr
// (1024-byte aligned, or advanced from such a tile by whole k16 steps).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | ((uint64_t)1 << 62);
}

// A descriptor advanced by k16 steps of a K-major bf16 tile (32 bytes).
__device__ __forceinline__ uint64_t desc_k16(uint64_t desc, int k16) {
  return desc + (uint64_t)(2 * k16);
}

// Row r's byte offset of 32-bit element c (0-31) in a 128-byte-swizzled
// tile: chunk c / 4 of the row lands at chunk (c / 4) ^ (r mod 8).
__host__ __device__ constexpr uint32_t sw128_offset(int r, int c) {
  return (uint32_t)(r * kRowBytes + ((((c >> 2) ^ r) & 7) << 4) +
                    (c & 3) * 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous window (fence ... wait).
__device__ __forceinline__ void fence_operands(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d = a · bᵀ (+ d when accumulate): A 64 rows × 16 features, B 32 rows ×
// 16 features, both K-major bf16 in shared memory, fp32 accumulators.
// Thread (warp w of the warpgroup, lane 4g + t) holds d[4j + 2i + c] =
// row 16w + g + 8i, column 8j + 2t + c: mma.sync's m16n8 C fragment,
// repeated over the four n8 blocks.
__device__ __forceinline__ void wgmma_m64n32k16_bf16(float (&d)[16],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with B 64 rows × 16 features: d[4j + 2i + c] = row 16w + g +
// 8i, column 8j + 2t + c over eight n8 blocks.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = a · bᵀ (+ d when accumulate): A 64 rows × 8 tf32 features in
// registers, B 32 rows × 8 tf32 features K-major in shared memory, fp32
// accumulators as wgmma_m64n32k16_bf16's.  Thread (warp w of the
// warpgroup, lane 4g + t) holds a = rows 16w + g, 16w + g + 8 at column
// t, then the same rows at column t + 4: mma.sync m16n8k8's A fragment.
// The tensor core reads the top 19 bits of each operand (a truncation),
// so a value that should round is rounded before it arrives.
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The same with B 64 rows × 8 tf32 features: d[4j + 2i + c] = row 16w +
// g + 8i, column 8j + 2t + c over eight n8 blocks (float32 K3,
// merge_topk_tf32.cu).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime finds it; null where it is
// missing.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major rows × F matrix of `bytes`-byte elements (a row
// a multiple of 16 bytes, base 16-byte aligned) read in boxes of box_rows
// rows × 128 bytes, 128-byte swizzle, zeros out of bounds.  Returns 0, or
// the CUresult of a failed encoding (CUDA_ERROR_NOT_FOUND where the
// encoder is missing).
inline int encode_rows(CUtensorMap* map, CUtensorMapDataType type,
                       int bytes, const void* base, int rows, int F,
                       int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)F, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)F * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / bytes),
                             (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return (int)fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                 steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A bf16 matrix (F a multiple of 8) in boxes of box_rows rows × 64
// features.
inline int encode_bf16_rows(CUtensorMap* map, const void* base, int rows,
                            int F, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, F,
                     box_rows);
}

// A float32 matrix (F a multiple of 4) in boxes of box_rows rows × 32
// features.
inline int encode_f32_rows(CUtensorMap* map, const void* base, int rows,
                           int F, int box_rows) {
  return encode_rows(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, F,
                     box_rows);
}

}  // namespace asp_hopper
