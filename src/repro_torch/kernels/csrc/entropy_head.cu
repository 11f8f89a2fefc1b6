// entropy_head: the softmax entropy of each row of logits (R, V), in one
// pass that never forms the probabilities,
//   H = m + log z - s / z,  m = max x,  z = sum e^(x - m),  s = sum x e^(x - m).
//
// Replaces the Pallas kernel repro/kernels/entropy_head.py:entropy_head
// (pallas_call at :53). There a sequential grid walks vocab tiles and
// carries (m, z, s) per row in VMEM scratch. Here one warp owns a row:
// each lane keeps its own online (m, z, s) over the columns lane,
// lane + 32, ..., rescaling only when its max moves (one exp a column),
// and the 32 triples are merged with shuffles. No block-level reduction
// and no second pass: the row count is the parallelism (four rows a
// block). V = 2 (a classifier's classes) leaves 30 lanes idle with the
// empty triple (m = -1e30, z = s = 0), which merges as an identity.
//
// Bound on H100: bytes. R * V input elements read once, R float32 written;
// a handful of flops per element (one exp). Lanes read consecutive
// columns, so each warp load is one coalesced 128-byte line (float32).
#include "float_tile.cuh"

namespace {

using ftile::NEG_INF;
using ftile::to_f;

constexpr int WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
entropy_head_kernel(const T* __restrict__ x, float* __restrict__ out,
                    int rows, int v) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;               // the whole warp leaves together
  const T* xr = x + (long long)row * v;
  float m = NEG_INF, z = 0.f, s = 0.f;
#pragma unroll 4
  for (int i = lane; i < v; i += 32) {
    const float xi = to_f(xr[i]);
    if (xi > m) {
      const float a = expf(m - xi);
      z = fmaf(z, a, 1.f);
      s = fmaf(s, a, xi);
      m = xi;
    } else {
      const float e = expf(xi - m);
      z += e;
      s = fmaf(xi, e, s);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float z2 = __shfl_xor_sync(0xffffffffu, z, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    const float a1 = expf(m - mn), a2 = expf(m2 - mn);
    z = z * a1 + z2 * a2;
    s = s * a1 + s2 * a2;
    m = mn;
  }
  if (lane == 0) {
    const float zz = fmaxf(z, 1e-30f);
    out[row] = m + logf(zz) - s / zz;
  }
}

template <typename T>
int launch(const void* x, void* out, int rows, int v, void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  entropy_head_kernel<T><<<blocks, WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float*>(out), rows, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int entropy_head_f32(const void* x, void* out, int rows, int v,
                                void* stream) {
  return launch<float>(x, out, rows, v, stream);
}

extern "C" int entropy_head_bf16(const void* x, void* out, int rows, int v,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, out, rows, v, stream);
}

extern "C" int entropy_head_f16(const void* x, void* out, int rows, int v,
                                void* stream) {
  return launch<__half>(x, out, rows, v, stream);
}
