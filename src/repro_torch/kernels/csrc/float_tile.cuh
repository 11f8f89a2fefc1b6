// Tile core shared by the float kernels (flash_attn.cu,
// mlp_softmax_attn.cu, entropy_head.cu).
//
// Inputs are float32, bfloat16 or float16; everything is computed in
// float32 (loads convert through the intrinsics, stores round back to
// the input type). The attention kernels own a BQ-row query tile per
// block and stream BK-row key tiles through shared memory. The score
// tile S = Q K^T * scale is computed by 256 threads as a 16 x 16 grid,
// each thread owning a 4 x 4 register micro-tile at rows ty + 16 i and
// columns tx + 16 j: a warp then broadcasts Q's rows and reads K's rows
// at an odd stride (DH + 1), which puts the 16 rows on 16 banks. Tiles
// are loaded with bounds checks and zero fill, so a ragged sequence
// needs no host padding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ftile {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per streamed tile
constexpr int THREADS = 256;    // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

// rows [r0, r0 + R) of a contiguous (n, DH) matrix into smem (row stride
// ld, as float32); rows at or past n are zero
template <typename T, int R, int DH>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < R * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    dst[r * ld + d] =
        r0 + r < n ? to_f(src[(long long)(r0 + r) * DH + d]) : 0.f;
  }
}

// s[i][j] = Qs[ty + 16 i] . Ks[tx + 16 j] over DH (both tiles at row
// stride DH + 1, in smem)
template <int DH>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

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
