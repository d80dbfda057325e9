// Shared helpers for the lfsr_tpu_torch Hopper kernels.
//
// Every kernel keeps its arithmetic in float32 and converts at the load and
// store, so one template covers float32 and bfloat16 I/O. The C entry points
// (LFSR_EXPORT) take raw device pointers, sizes, a dtype code (0 = float32,
// 1 = bfloat16) and a cudaStream_t, launch, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define LFSR_EXPORT extern "C" __attribute__((visibility("default")))

namespace lfsr {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// round to nearest even, the same rounding as torch's .to(torch.bfloat16)
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// allow a kernel more than the default 48 KB of dynamic shared memory
inline cudaError_t set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace lfsr
