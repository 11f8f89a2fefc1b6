// Hopper building blocks for the tensor-core kernels (flash_attn.cu):
// swizzled shared-memory tiles in the canonical layouts that `wgmma`'s
// matrix descriptors describe, the descriptors themselves, `cp.async`
// copies that complete on an `mbarrier`, the fences between the generic
// and the async proxy, and the register fences that keep the compiler
// from touching a `wgmma` operand while the instruction is in flight.
// The `wgmma` instructions are in wgmma_ops.cuh (generated).
//
// A tile is R rows of ROW_BYTES contiguous bytes. It is stored as panels
// of W = min(128, ROW_BYTES) bytes a row (W = 32, 64 or 128; a row wider
// than 128 bytes is cut into 128-byte panels, panel p holding bytes
// [128 p, 128 p + 128) of every row), each panel R x W bytes, rows W
// bytes apart, with the W-byte swizzle (CU_TENSOR_MAP_SWIZZLE_{32,64,
// 128}B): the 16-byte chunk bits [4, 4 + log2(W / 16)) of a byte offset
// are XORed with the bits [7, ...) above them. Every tile starts on a
// 1024-byte boundary, so the hardware, which swizzles absolute shared
// addresses, sees the same pattern (descriptor base offset 0).
//
// The same tile serves both operand majors:
// - K-major (the reduction runs along the row): rows are M or N, 8-row
//   groups SBO = 8 W bytes apart; a k-step of 32 bytes (16 bf16 or 8
//   tf32) advances the start address by 32 bytes inside the panel.
// - MN-major (bf16 only; the row runs along N): rows are k, 8-row groups
//   SBO = 8 W bytes apart, and the next W bytes of N are LBO = one panel
//   further; a k-step of 16 rows advances the start by 16 W bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__host__ __device__ constexpr int align1024(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

template <int ROWS, int ROW_BYTES>
struct Tile {
  static constexpr int W = ROW_BYTES < 128 ? ROW_BYTES : 128;
  static constexpr int PANEL = ROWS * W;
  static constexpr int BYTES = ROW_BYTES / W * PANEL;
  static_assert(W == 32 || W == 64 || W == 128,
                "rows of 32, 64 or n x 128 bytes");
  static_assert(ROW_BYTES % W == 0 && ROWS % 8 == 0, "bad tile shape");

  // swizzled byte offset of byte `cb` of row `r`
  __device__ static __forceinline__ uint32_t offset(int r, int cb) {
    const uint32_t off = (cb / W) * PANEL + r * W + cb % W;
    return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
  }
  // unswizzled start of byte `cb` of row `r` (where a descriptor points)
  __device__ static __forceinline__ uint32_t start(int r, int cb) {
    return (cb / W) * PANEL + r * W + cb % W;
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int w) {
  const uint64_t mode = w == 128 ? 1 : w == 64 ? 2 : 3;
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies; `ok` false zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread arrives on `bar` once all its earlier cp.async have landed
// (the barrier's count includes the arrival: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy shared writes (cp.async, st.shared) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin a register: no read or write of it moves across this point
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename R, int N>
__device__ __forceinline__ void fence_regs(R (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// round to tf32 (10 mantissa bits, to nearest, ties away): the bits a
// tf32 wgmma reads, with the low 13 cleared
__device__ __forceinline__ float tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// two floats as a bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace hopper
