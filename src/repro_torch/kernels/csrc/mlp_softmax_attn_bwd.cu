// mlp_softmax_attn backward: the per-query-tile pass of the gradient of
//   out = relu(q A + b1) U + u0,  A = scale K^T W1,  U = W2 V,  u0 = b2 V,
// for q (BH, Sq, DH), do (BH, Sq, DH), A (BH / group, DH, hid),
// U (BH / group, hid, DH) and b1 (hid); hid <= 64, DH in {16, 32, 64, 128}.
// With Z = q A + b1 and H = relu(Z):
//   dH = do U^T,  dZ = dH * [Z > 0],  dq = dZ A^T,
// and the sums over a tile's rows, written per tile:
//   dU = H^T do,  du0 = sum_rows do,  dA = q^T dZ,  db1 = sum_rows dZ.
// The wrapper (kernels/mlp_softmax_attn.py) makes A and U with two plain
// products, sums the tiles' partials over each kv head's group and over
// the heads in a fixed order, and forms dK, dV, dW1, dW2 and db2 from
// dA, dU and du0 with plain products.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel (no
// custom_vjp under src/repro/kernels/), and its in-vivo training
// differentiates the materialized MLP_sm attention by autodiff. The
// port's in-vivo training on the card runs the forward through the
// mlp_softmax_attn kernel, so its gradient needs a kernel of its own.
// Like the forward, it never forms an S x S tile: the reassociation
// through A carries over to the gradient.
//
// Design: one block of 256 threads a 64-row query tile of a q head. q,
// do, the head's A and U, and b1 in float32 shared memory (rows past Sq
// zero, which zeroes their share of every sum). Each thread computes
// whole elements: Z and dH for (row, h) pairs, then dq for (row, d), then
// dU, dA, du0 and db1 summed over the tile's rows in row order. No
// atomics: a second launch is bitwise equal.
//
// Bound on the H100: bytes. q, do and dq at the element size plus the
// partials; about 2 DH hid multiply-adds a row for each of Z, dH, dq, dU
// and dA, far below the ridge.
#include <stdint.h>

#include "float_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows a tile
constexpr int HID_MAX = 64;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
__host__ __device__ constexpr size_t smem_floats(int hid) {
  return (size_t)2 * BQ * (DH + 1) + (size_t)DH * (hid + 1) +
         (size_t)hid * (DH + 1) + hid + (size_t)2 * BQ * (hid + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
msa_bwd_kernel(const T* __restrict__ q, const T* __restrict__ dout,
               const float* __restrict__ A, const float* __restrict__ b1,
               const float* __restrict__ U, T* __restrict__ dq,
               float* __restrict__ dA_part, float* __restrict__ dU_part,
               float* __restrict__ du0_part, float* __restrict__ db1_part,
               int group, int sq, int hid) {
  extern __shared__ float smem[];
  const int H1 = hid + 1;
  float* Qs = smem;                          // BQ x (DH + 1)
  float* dOs = Qs + BQ * (DH + 1);           // BQ x (DH + 1)
  float* As = dOs + BQ * (DH + 1);           // DH x (hid + 1)
  float* Us = As + DH * H1;                  // hid x (DH + 1)
  float* b1s = Us + hid * (DH + 1);          // hid
  float* Hs = b1s + hid;                     // BQ x (hid + 1)
  float* dZs = Hs + BQ * H1;                 // BQ x (hid + 1)
  const int bh = blockIdx.y, kvh = bh / group, tile = blockIdx.x;
  const int q0 = tile * BQ, tid = threadIdx.x;
  const size_t qbase = (size_t)bh * sq * DH;
  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    const bool in = q0 + r < sq;
    const size_t g = qbase + (size_t)(q0 + r) * DH + d;
    Qs[r * (DH + 1) + d] = in ? ftile::to_f(q[g]) : 0.f;
    dOs[r * (DH + 1) + d] = in ? ftile::to_f(dout[g]) : 0.f;
  }
  const float* Ah = A + (size_t)kvh * DH * hid;
  const float* Uh = U + (size_t)kvh * hid * DH;
  for (int e = tid; e < DH * hid; e += THREADS) {
    As[(e / hid) * H1 + e % hid] = Ah[e];
    Us[(e / DH) * (DH + 1) + e % DH] = Uh[e];
  }
  for (int h = tid; h < hid; h += THREADS) b1s[h] = b1[h];
  __syncthreads();

  // H = relu(q A + b1) and dZ = (do U^T) * [Z > 0], one (row, h) a step
  for (int e = tid; e < BQ * hid; e += THREADS) {
    const int r = e / hid, h = e % hid;
    float z = 0.f, dh = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      z = fmaf(Qs[r * (DH + 1) + d], As[d * H1 + h], z);
      dh = fmaf(dOs[r * (DH + 1) + d], Us[h * (DH + 1) + d], dh);
    }
    z += b1s[h];
    Hs[r * H1 + h] = fmaxf(z, 0.f);
    dZs[r * H1 + h] = z > 0.f ? dh : 0.f;
  }
  __syncthreads();

  // dq = dZ A^T
  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    if (q0 + r >= sq) continue;
    float acc = 0.f;
    for (int h = 0; h < hid; ++h)
      acc = fmaf(dZs[r * H1 + h], As[d * H1 + h], acc);
    dq[qbase + (size_t)(q0 + r) * DH + d] = from_f<T>(acc);
  }

  // the tile's partial sums over its rows, in row order
  const size_t part = (size_t)bh * gridDim.x + tile;
  for (int e = tid; e < hid * DH; e += THREADS) {
    const int h = e / DH, d = e % DH;
    float acc = 0.f;
    for (int r = 0; r < BQ; ++r)
      acc = fmaf(Hs[r * H1 + h], dOs[r * (DH + 1) + d], acc);
    dU_part[part * hid * DH + e] = acc;
  }
  for (int e = tid; e < DH * hid; e += THREADS) {
    const int d = e / hid, h = e % hid;
    float acc = 0.f;
    for (int r = 0; r < BQ; ++r)
      acc = fmaf(Qs[r * (DH + 1) + d], dZs[r * H1 + h], acc);
    dA_part[part * DH * hid + e] = acc;
  }
  for (int d = tid; d < DH; d += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BQ; ++r) acc += dOs[r * (DH + 1) + d];
    du0_part[part * DH + d] = acc;
  }
  for (int h = tid; h < hid; h += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BQ; ++r) acc += dZs[r * H1 + h];
    db1_part[part * hid + h] = acc;
  }
}

template <typename T, int DH>
int run(const T* q, const T* dout, const float* A, const float* b1,
        const float* U, T* dq, float* dA, float* dU, float* du0, float* db1,
        int bh, int group, int sq, int hid, cudaStream_t stream) {
  auto kernel = msa_bwd_kernel<T, DH>;
  static const int smem_err = ftile::allow_smem(
      kernel, smem_floats<DH>(HID_MAX) * sizeof(float));
  if (smem_err) return smem_err;
  kernel<<<dim3((sq + BQ - 1) / BQ, bh), THREADS,
           smem_floats<DH>(hid) * sizeof(float), stream>>>(
      q, dout, A, b1, U, dq, dA, dU, du0, db1, group, sq, hid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* dout, const void* A, const void* b1,
           const void* U, void* dq, void* dA, void* dU, void* du0, void* db1,
           int bh, int group, int sq, int dh, int hid, void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || hid < 1 ||
      hid > HID_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tq = static_cast<const T*>(q);
  const auto* td = static_cast<const T*>(dout);
  const auto* fa = static_cast<const float*>(A);
  const auto* fb = static_cast<const float*>(b1);
  const auto* fu = static_cast<const float*>(U);
  auto* gq = static_cast<T*>(dq);
  auto* pa = static_cast<float*>(dA);
  auto* pu = static_cast<float*>(dU);
  auto* p0 = static_cast<float*>(du0);
  auto* pb = static_cast<float*>(db1);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return run<T, 16>(tq, td, fa, fb, fu, gq, pa, pu, p0, pb, bh, group, sq, hid, st);
    case 32: return run<T, 32>(tq, td, fa, fb, fu, gq, pa, pu, p0, pb, bh, group, sq, hid, st);
    case 64: return run<T, 64>(tq, td, fa, fb, fu, gq, pa, pu, p0, pb, bh, group, sq, hid, st);
    case 128: return run<T, 128>(tq, td, fa, fb, fu, gq, pa, pu, p0, pb, bh, group, sq, hid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mlp_softmax_attn_bwd_f32(const void* q, const void* dout,
                                        const void* A, const void* b1,
                                        const void* U, void* dq, void* dA,
                                        void* dU, void* du0, void* db1,
                                        int bh, int group, int sq, int dh,
                                        int hid, void* stream) {
  return launch<float>(q, dout, A, b1, U, dq, dA, dU, du0, db1, bh, group, sq,
                       dh, hid, stream);
}

extern "C" int mlp_softmax_attn_bwd_bf16(const void* q, const void* dout,
                                         const void* A, const void* b1,
                                         const void* U, void* dq, void* dA,
                                         void* dU, void* du0, void* db1,
                                         int bh, int group, int sq, int dh,
                                         int hid, void* stream) {
  return launch<__nv_bfloat16>(q, dout, A, b1, U, dq, dA, dU, du0, db1, bh,
                               group, sq, dh, hid, stream);
}
