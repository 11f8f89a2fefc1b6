// Hopper building blocks for the tensor-core kernels (flash_attn.cu):
// swizzled shared-memory tiles in the canonical layouts that `wgmma`'s
// matrix descriptors describe, the descriptors themselves, `cp.async`
// copies that complete on an `mbarrier`, the fences between the generic
// and the async proxy, and the register fences that keep the compiler
// from touching a `wgmma` operand while the instruction is in flight;
// and for 3xTF32, the hi + lo splits, in registers and in place, and the
// walk of products whose A fragments are loaded and split in registers.
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

// the bits of hi = tf32(x) and lo = tf32(x - hi), 3xTF32's two halves,
// for the splits in registers: the rounding of tf32() as two integer
// operations (tf32() compiles to four, guarding NaN payloads), the same
// bits for every finite x and for infinities
__device__ __forceinline__ uint32_t tf32_bits(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(x));
  lo = tf32_bits(__float_as_uint(x - __uint_as_float(hi)));
}

// This thread's tf32 A fragment, k-step s (8 columns), of a float32 tile
// TL: registers a0..a3 hold (m, k), (m + 8, k), (m, k + 4), (m + 8, k +
// 4), m = row (a multiple of 16 plus lane / 4), k = lane % 4.
// frag_kmajor: K along the tile's rows (element (m, k) at row m, column
// 8 s + k). Its rows m and m + 8 share their swizzle (m & 7), which XORs
// the 16-byte chunk, so a warp's eight rows find eight distinct chunks (32
// banks) and a k-step's address is a row base, one of eight in-panel
// offsets and a constant.
template <typename TL>
__device__ __forceinline__ void frag_kmajor(const char* tile, int row, int s,
                                            float (&v)[4]) {
  static_assert(TL::W == 128, "a tile of 128-byte panels");
  const int xr = (row & 7) << 4;
  const char* r = tile + s / 4 * TL::PANEL + row * 128 + 4 * (threadIdx.x % 4);
  const int c0 = (32 * (s % 4)) ^ xr, c1 = (32 * (s % 4) + 16) ^ xr;
  v[0] = *reinterpret_cast<const float*>(r + c0);
  v[1] = *reinterpret_cast<const float*>(r + 1024 + c0);
  v[2] = *reinterpret_cast<const float*>(r + c1);
  v[3] = *reinterpret_cast<const float*>(r + 1024 + c1);
}
// frag_mn: M along the tile's rows, transposed (element (m, k) at row 8 s
// + k, column m; m and m + 8 in one 32-column panel). Row 8 s + k's
// swizzle is k's, so a k-step's address is one of four bases plus 1024 s.
template <typename TL>
__device__ __forceinline__ void frag_mn(const char* tile, int m, int s,
                                        float (&v)[4]) {
  static_assert(TL::W == 128, "a tile of 128-byte panels");
  const int k = threadIdx.x % 4;
  const char* r = tile + m / 32 * TL::PANEL + k * 128 + 1024 * s;
  const int c0 = 4 * m % 128, c1 = c0 + 32;
  v[0] = *reinterpret_cast<const float*>(r + (c0 ^ (k << 4)));
  v[1] = *reinterpret_cast<const float*>(r + (c1 ^ (k << 4)));
  v[2] = *reinterpret_cast<const float*>(r + 512 + (c0 ^ ((k + 4) << 4)));
  v[3] = *reinterpret_cast<const float*>(r + 512 + (c1 ^ ((k + 4) << 4)));
}

// KS k-steps of tf32 products whose A operands are fragments loaded from
// shared memory and split in registers (3xTF32 with A from registers):
// load(s, i, hi, lo) fills operand i's (of NA) fragment for k-step s,
// issue(s, hi, lo) issues that step's products, one commit group a step.
// Two register sets take turns: step s's loads overlap step s - 1's
// products, and a set is refilled only once the group that read it has
// completed (wait_group 1). Ends with every product completed.
template <int KS, int NA, typename Load, typename Issue>
__device__ __forceinline__ void split_walk(Load load, Issue issue) {
  uint32_t hi[2][NA][4], lo[2][NA][4];
  auto fence_set = [&](int u) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      fence_regs(hi[u][i]);
      fence_regs(lo[u][i]);
    }
  };
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int u = s & 1;
    if (s >= 2) {
      wgmma_wait<1>();
      fence_set(u);
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) load(s, i, hi[u][i], lo[u][i]);
    wgmma_fence();
    issue(s, hi[u], lo[u]);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < (KS < 2 ? KS : 2); ++u) fence_set(u);
}

// float32: x -> hi = tf32(x) in place, lo = tf32(x - hi) `lo` bytes
// further, over `bytes` bytes (a tile's layout is kept)
template <int THREADS>
__device__ __forceinline__ void split_flat(char* buf, int lo, int bytes) {
  float4* h = reinterpret_cast<float4*>(buf);
  float4* l = reinterpret_cast<float4*>(buf + lo);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) {
    const float4 x = h[i];
    const float4 y = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    h[i] = y;
    l[i] = make_float4(tf32(x.x - y.x), tf32(x.y - y.y), tf32(x.z - y.z),
                       tf32(x.w - y.w));
  }
}

// two floats as a bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace hopper
