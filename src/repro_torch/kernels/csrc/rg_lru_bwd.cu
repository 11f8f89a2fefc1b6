// rg_lru backward: the gradients of the RG-LRU recurrence h_t = a_t h_{t-1}
// + b_t (from h_0 = 0) with respect to a and b, given the forward's trace h
// and its gradient dh, all (B, T, D) float32. From g_{T+1} = 0 it runs
// the reverse recurrence
//   g_t = dh_t + a_{t+1} g_{t+1},   db_t = g_t,   da_t = g_t h_{t-1}
// (h_0 = 0, so da_1 = 0).
//
// Replaces no Pallas kernel: the JAX package has no backward of its
// rg_lru kernel, and its training differentiates the model's associative
// scan (repro/models/rglru.py) by autodiff. The port's recurrent layers
// run the forward on the rg_lru kernel (csrc/rg_lru.cu), whose output has
// no autograd graph, so their gradient needs a kernel of its own (the
// wrapper, kernels/rg_lru.py, binds both in a torch.autograd.Function).
//
// Bound on the H100: bytes (`bwd_work` in kernels/rg_lru.py). A call reads
// a, h and dh and writes da and db once, 20 B T D bytes, for two
// multiplies and an add a step: at RecurrentGemma's training batch (2,
// 512, 2560) 52.4 MB, 15.6 us at 3.35 TB/s.
//
// Design: one thread a channel of a batch row (lane = channel, so every
// load and store of a step is one 128-byte line a warp), walking T
// backwards in tiles of STEPS steps: the tile's a_{t+1}, h_{t-1} and dh_t
// are loaded into registers first (3 STEPS independent loads in flight a
// thread), then the tile's steps run in order and store da and db. Each
// step rounds the product and the sum separately (no fused multiply-add),
// as the plain version `ref.rg_lru_bwd` does, so the two agree to the
// last bit where their inputs do; the sums have one order and there are
// no atomics, so two launches agree bitwise. Loads and stores are
// evict-first (`__ldcs`, `__stcs`): each byte is touched once. A simple
// kernel first: with B D threads in all (5,120 at the path's shape) the
// card is far from full, and the chunked one-pass scan of the forward,
// run in reverse, is the way to more threads.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // channels a block
constexpr int STEPS = 16;      // steps a tile, held in registers

__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                  const float* __restrict__ dh, float* __restrict__ da,
                  float* __restrict__ db, int t_len, int d) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= d) return;
  const long long off = (long long)blockIdx.y * t_len * d + c;
  float g = 0.f;
  // tiles [t0, t0 + STEPS) from the last one down
  for (int t0 = (t_len - 1) / STEPS * STEPS; t0 >= 0; t0 -= STEPS) {
    float an[STEPS], hp[STEPS], dv[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = t0 + j;
      const long long o = off + (long long)t * d;
      // a_{t+1} (0 past the end: g_{T+1} = 0 carries nothing), h_{t-1}
      // (0 before the start), dh_t (0 past the end)
      an[j] = t + 1 < t_len ? __ldcs(a + o + d) : 0.f;
      hp[j] = t >= 1 && t < t_len ? __ldcs(h + o - d) : 0.f;
      dv[j] = t < t_len ? __ldcs(dh + o) : 0.f;
    }
#pragma unroll
    for (int j = STEPS - 1; j >= 0; --j) {
      const int t = t0 + j;
      if (t >= t_len) continue;
      g = __fadd_rn(dv[j], __fmul_rn(an[j], g));
      const long long o = off + (long long)t * d;
      __stcs(db + o, g);
      __stcs(da + o, __fmul_rn(g, hp[j]));
    }
  }
}

}  // namespace

// a, h, dh in; da, db out; all (bsz, t_len, d) float32, row-major
extern "C" int rg_lru_bwd_f32(const void* a, const void* h, const void* dh,
                              void* da, void* db, int bsz, int t_len, int d,
                              void* stream) {
  if (bsz < 1 || t_len < 1 || d < 1 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + THREADS - 1) / THREADS, bsz);
  rg_lru_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(dh), static_cast<float*>(da),
      static_cast<float*>(db), t_len, d);
  return static_cast<int>(cudaGetLastError());
}
