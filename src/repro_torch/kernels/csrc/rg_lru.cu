// rg_lru: the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t over a, b
// (B, T, D) float32, from h_0 = 0, writing the whole trace h (B, T, D)
// float32. An initial state is folded into b_0 by the caller, as the
// model's rglru_scan does.
//
// Replaces the Pallas kernel repro/kernels/rg_lru.py:rg_lru_scan
// (pallas_call at :42). On the TPU the grid (B, T / bt) walks the time
// tiles in order, the (1, D) state stays in VMEM across them, and a
// fori_loop steps through each tile D-wide on the vector unit.
//
// Bound on the H100: bytes (`work` in kernels/rg_lru.py). A call reads a
// and b and writes h once, 12 B T D bytes, for B T D multiply-adds: at
// RecurrentGemma's prefill batch (4, 512, 2560) 62.9 MB, 18.8 us at
// 3.35 TB/s. There is no product to put on the tensor cores: each step
// is one multiply and one add on the previous h. What a kernel has to do
// is keep enough loads in flight to run at the memory's rate while every
// channel's steps stay in order.
//
// Design: a one-pass chunked scan. A block of WARPS warps owns 32
// consecutive channels of one batch row (lane = channel, so every load
// and store of a step is one 128-byte line a warp) and walks T in tiles
// of WARPS x STEPS steps, warp w taking steps [w STEPS, (w + 1) STEPS)
// of each tile; the loop over tiles takes the place of the TPU's
// sequential grid dimension, and h crosses from tile to tile in shared
// memory. In a tile:
// 1. each warp holds its STEPS steps of a and b in registers (loaded
//    while the previous tile was computed);
// 2. it issues the loads of its steps of the next tile;
// 3. it reduces its chunk, in step order, to (P, S): the chunk maps a
//    carry-in h to P h + S, P the product of its a, S its scan from 0;
// 4. it writes (P, S) to shared memory; one barrier;
// 5. it folds the earlier warps' (P, S) into the tile's carry-in, in
//    warp order (at most WARPS - 1 steps, the same in every warp, so no
//    further barrier and no lookback across blocks), which gives its own
//    carry-in;
// 6. it recomputes h_t = a_t h + b_t from that carry-in over its steps
//    in registers and stores each h_t; the last warp's final h is the
//    next tile's carry-in.
// So a and b are read once and h written once, the bytes of the bound,
// and nothing else touches device memory: no second pass, no scratch.
// Each byte is touched once, so every load and store is marked
// evict-first (`__ldcs`, `__stcs`): the stream then does not crowd the
// L2 cache it passes through. Every step rounds the product and the sum
// separately (no fused multiply-add), as the plain version does; each
// step inside a chunk is a_t h + b_t in step order from the chunk's
// carry-in, and only that carry-in is rounded otherwise than in the
// serial loop. Every sum has a fixed order and there are no atomics, so
// two launches on the same inputs agree bitwise. Steps past T and lanes
// past D act as a = 1, b = 0 (P 1, S 0) and store nothing. The shared
// (P, S) and the carry are double-buffered by tile parity: a warp that
// runs ahead into the next tile writes the other buffer, and the barrier
// of that tile keeps it from the one after. At the path's shape: 4 x 80
// = 320 blocks of 128 threads, all resident (96 registers: five a SM),
// the 512 steps in eight tiles, 16 KB of loads in flight a block. WARPS
// and STEPS were chosen on the card (tools/rg_lru_ab.py, PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;    // warps a block: the time split of a tile
constexpr int STEPS = 16;   // steps a warp a tile, held in registers

// steps [t0, t0 + L) of one channel into registers; a step past T (or a
// lane past D) is a = 1, b = 0
template <int L>
__device__ __forceinline__ void load_chunk(float (&ra)[L], float (&rb)[L],
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           long long off, int t0, int t_len,
                                           int d, bool live) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const bool in = live && t0 + j < t_len;
    const long long o = off + (long long)(t0 + j) * d;
    ra[j] = in ? __ldcs(a + o) : 1.f;
    rb[j] = in ? __ldcs(b + o) : 0.f;
  }
}

template <int W, int L>
__global__ void __launch_bounds__(W * 32)
rg_lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ h, int t_len, int d, int groups) {
  constexpr int TILE = W * L;
  __shared__ float sp[2][W][32], ss[2][W][32], sh[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / groups;
  const int c = (blockIdx.x - bi * groups) * 32 + lane;
  const bool live = c < d;
  const long long off = (long long)bi * t_len * d + c;
  const int tiles = (t_len + TILE - 1) / TILE;

  float ca[L], cb[L], na[L], nb[L];
  load_chunk<L>(ca, cb, a, b, off, warp * L, t_len, d, live);
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * TILE + warp * L, buf = k & 1;
    if (k + 1 < tiles)
      load_chunk<L>(na, nb, a, b, off, t0 + TILE, t_len, d, live);
    float p = 1.f, s = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      p = __fmul_rn(p, ca[j]);
      s = __fadd_rn(__fmul_rn(ca[j], s), cb[j]);
    }
    sp[buf][warp][lane] = p;
    ss[buf][warp][lane] = s;
    __syncthreads();
    float hv = k == 0 ? 0.f : sh[buf][lane];
    for (int w = 0; w < warp; ++w)
      hv = __fadd_rn(__fmul_rn(sp[buf][w][lane], hv), ss[buf][w][lane]);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      hv = __fadd_rn(__fmul_rn(ca[j], hv), cb[j]);
      if (live && t0 + j < t_len)
        __stcs(h + off + (long long)(t0 + j) * d, hv);
    }
    if (warp == W - 1) sh[buf ^ 1][lane] = hv;
    if (k + 1 < tiles) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        ca[j] = na[j];
        cb[j] = nb[j];
      }
    }
  }
}

}  // namespace

// groups = ceil(d / 32) channel groups a batch row (`plan` in the
// wrapper): one block each, bsz x groups blocks in all
extern "C" int rg_lru_f32(const void* a, const void* b, void* h, int bsz,
                          int t_len, int d, int groups, void* stream) {
  const long long blocks = (long long)bsz * groups;
  if (groups != (d + 31) / 32 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  rg_lru_kernel<WARPS, STEPS>
      <<<static_cast<int>(blocks), WARPS * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(h), t_len, d, groups);
  return static_cast<int>(cudaGetLastError());
}
