// Shared definitions of the arrowspace_torch CUDA kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes), launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// float32 lowest finite value: the empty-slot score of every pool.
#define ASP_NEG_INF (-3.4028234663852886e38f)
#define ASP_INT_MAX 2147483647
#define ASP_FULL_MASK 0xffffffffu

// Score of one (query, item) pair on the SHIFTED scale: dot is α·cos
// (queries arrive α-prescaled), and c1 = 1 - α.  The explicit roundings
// keep the compiler from fusing the product into the subtraction, so the
// λ term rounds exactly as the PyTorch expression acos - c1·min(|Δλ|, 1).
__device__ __forceinline__ float asp_shifted_score(float dot, float ql,
                                                   float xl, float c1) {
  const float dl = fminf(fabsf(__fsub_rn(ql, xl)), 1.0f);
  return __fsub_rn(dot, __fmul_rn(c1, dl));
}

// Sets the dynamic shared-memory ceiling of a kernel when it needs more
// than the default 48 KB.
template <typename Kernel>
__host__ inline cudaError_t asp_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
