// Small pieces shared by the float kernels on the CUDA cores
// (entropy_head.cu, mlp_softmax_attn.cu): loads of float32, bfloat16 or
// float16 into float32 through the intrinsics, the empty running max of
// an online softmax, and the opt-in to more than 48 KB of dynamic shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ftile {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// Opt in to more than 48 KB of dynamic shared memory for `kernel` (a
// no-op below that); returns the CUDA error, 0 on success.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace ftile
