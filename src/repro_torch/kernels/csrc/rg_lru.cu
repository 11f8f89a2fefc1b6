// rg_lru: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t over a, b
// (B, T, D) float32, from h_0 = 0, writing the whole trace h (B, T, D)
// float32. An initial state is folded into b_0 by the caller, as the
// model's rglru_scan does.
//
// Replaces the Pallas kernel repro/kernels/rg_lru.py:rg_lru_scan
// (pallas_call at :42). On the TPU the grid (B, T / bt) walks the time
// tiles in order, the (1, D) state stays in VMEM across them, and
// a fori_loop steps through each tile D-wide on the vector unit. CUDA
// blocks share no state, so here one thread owns one (b, d) channel and
// walks all of T with h in a register; a warp's 32 lanes take 32
// consecutive channels, so every load and store of a step is one
// coalesced 128-byte line. The loop is unrolled so that the loads of
// later steps, which do not depend on h, are in flight while h is
// updated. Each step rounds the product and the sum separately (no
// fused multiply-add), as the plain version does.
//
// Bound on H100: bytes. 3 B T D float32 moved (a, b read, h written) for
// B T D multiply-adds. Under-filled at the serving path's shape: B D =
// 4 x 2560 = 10,240 threads, 160 blocks of 64 on 132 SMs, about 2.4 warps
// an SM of the 64 it can hold, so the time is the latency of T dependent
// steps rather than the bandwidth. A chunked two-pass scan (per-chunk
// products and sums, a short scan across chunks, then a fix-up pass) that
// fills the card is the later redesign.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ h, int bsz, int t_len, int d) {
  const long long ch = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (ch >= (long long)bsz * d) return;
  const long long bi = ch / d, di = ch % d;
  const long long base = bi * t_len * d + di;
  float hv = 0.f;
#pragma unroll 8
  for (int t = 0; t < t_len; ++t) {
    const long long off = base + (long long)t * d;
    hv = __fadd_rn(__fmul_rn(a[off], hv), b[off]);
    h[off] = hv;
  }
}

}  // namespace

extern "C" int rg_lru_f32(const void* a, const void* b, void* h, int bsz,
                          int t_len, int d, void* stream) {
  const long long n = (long long)bsz * d;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  rg_lru_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), bsz, t_len, d);
  return static_cast<int>(cudaGetLastError());
}
