// flash_attn backward: the gradients of o = softmax(q k^T * scale) v with
// respect to q, k and v, given do, for q (BH, Sq, DH), k / v
// (BH / group, Skv, DH) and the forward's o; DH in {16, 32, 64, 128},
// bidirectional or causal (Sq == Skv), a causal window w > 0 also masking
// keys j <= i - w. float32 or bfloat16 in and out, float32 sums.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel (no
// custom_vjp under src/repro/kernels/), and its training differentiates
// plain jnp attention by autodiff. The port's training path on the card
// runs the forward through the flash_attn kernel, whose output has no
// autograd graph, so its gradient needs a kernel of its own (the wrapper
// wraps both in a torch.autograd.Function).
//
// Design: FlashAttention-2's backward on the CUDA cores, no S x S tensor
// in memory, in two passes, neither with atomics:
// - fa_bwd_dq_kernel, one block a 64-row query tile of a q head: D_i =
//   rowsum(do * o); the row log-sum-exp lse_i of the scores, in a first
//   walk over the key tiles (the forward does not write it); then a
//   second walk recomputing P = exp(S - lse), dP = do V^T,
//   dS = P * (dP - D) and dq += dS K * scale. It writes dq, lse and D.
// - fa_bwd_dkdv_kernel, one block a 64-row key tile of a kv head: for
//   each q head of the group in order, each query tile: P^T, dP^T and
//   dS^T recomputed from the saved lse and D, dv += P^T do and
//   dk += dS^T q * scale. So dk and dv sum over a kv head's group in a
//   fixed order and a second launch is bitwise equal.
// Both recompute S with the same fused multiply-add chain over DH and one
// unfused product by scale, so P agrees bitwise between the passes.
// Tiles: 256 threads; a thread owns four rows and every sixteenth column
// of a 64-wide product (4 x 4 of a score tile, 4 x DH/16 of a gradient
// tile); operands in float32 shared memory, rows padded by one float so
// the sixteen column owners of a warp hit sixteen banks.
//
// Bound on the H100: operations. Five products of Sq x Skv x DH
// multiply-adds (S, dP, dq, dk, dv) over the kept pairs, two operations
// each, on the CUDA cores' 67 TFLOP/s; this kernel does seven (S three
// times, dP twice), and shared-memory reads (half an operand a
// multiply-add) hold it below that rate. Making it fast (wgmma, the
// tensor cores) is later work.
#include <stdint.h>

#include "float_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BT = 64;                 // rows a tile (queries and keys)

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Mask {
  int sq, skv, causal, window;
  __device__ __forceinline__ bool keep(int i, int j) const {
    if (i >= sq || j >= skv) return false;
    if (!causal) return true;
    return j <= i && (window == 0 || j > i - window);
  }
  // key tiles [first, last] that hold a kept key of query rows [q0, q1)
  __device__ __forceinline__ void key_tiles(int q0, int q1, int& first,
                                            int& last) const {
    first = 0;
    last = (skv - 1) / BT;
    if (causal) {
      last = min(last, (min(q1, sq) - 1) / BT);
      if (window > 0) first = max(0, q0 - window + 1) / BT;
    }
  }
  // query tiles [first, last] that hold a query keeping a key of rows
  // [k0, k1)
  __device__ __forceinline__ void query_tiles(int k0, int k1, int& first,
                                              int& last) const {
    first = 0;
    last = (sq - 1) / BT;
    if (causal) {
      first = k0 / BT;
      if (window > 0) last = min(last, (min(k1, skv) - 1 + window - 1) / BT);
    }
  }
};

// rows [row0, row0 + BT) of a (rows, DH) array into shared memory as
// float32, row stride DH + 1; rows past `rows` are zero
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int e = threadIdx.x; e < BT * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    dst[r * (DH + 1) + d] =
        row0 + r < rows ? ftile::to_f(src[(size_t)(row0 + r) * DH + d]) : 0.f;
  }
}

// out[a][b] = sum_d A[r_a][d] * B[c_b][d] over d in order, for the
// thread's rows r_a = ty * 4 + a and columns c_b = tx + 16 b, both
// operands row-major with stride DH + 1
template <int DH>
__device__ __forceinline__ void dot_tile(float (&out)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) out[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty * 4 + a) * (DH + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * (DH + 1) + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) out[a][b] = fmaf(x[a], y[b], out[a][b]);
  }
}

// acc[a][c] += sum_j P[r_a][j] * B[j][tx + 16 c], P (BT x BT) with stride
// BT + 1, B (BT x DH) with stride DH + 1
template <int DH>
__device__ __forceinline__ void acc_tile(float (&acc)[4][DH / 16],
                                         const float* P, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    float x[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = P[(ty * 4 + a) * (BT + 1) + j];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const float y = B[j * (DH + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(x[a], y, acc[a][c]);
    }
  }
}

// the sum over the 16 lanes that share a row (xor within a half-warp)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr size_t dq_smem() {
  return (size_t)(4 * BT * (DH + 1) + BT * (BT + 1)) * sizeof(float);
}

template <int DH>
constexpr size_t dkdv_smem() {
  return (size_t)(4 * BT * (DH + 1) + 2 * BT * (BT + 1) + 2 * BT) *
         sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ dsum_out,
                 int group, Mask mask, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * (DH + 1);
  float* Ks = dOs + BT * (DH + 1);
  float* Vs = Ks + BT * (DH + 1);
  float* dSs = Vs + BT * (DH + 1);
  const int bh = blockIdx.y, kvh = bh / group;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t qbase = (size_t)bh * mask.sq * DH;
  const size_t kbase = (size_t)kvh * mask.skv * DH;
  load_tile<T, DH>(Qs, q + qbase, q0, mask.sq);
  load_tile<T, DH>(dOs, dout + qbase, q0, mask.sq);
  __syncthreads();

  // D_i = rowsum(do * o)
  float dsum[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    float s = 0.f;
    if (i < mask.sq)
#pragma unroll
      for (int c = 0; c < DH / 16; ++c)
        s = fmaf(dOs[(ty * 4 + a) * (DH + 1) + tx + 16 * c],
                 ftile::to_f(o[qbase + (size_t)i * DH + tx + 16 * c]), s);
    dsum[a] = row_sum(s);
  }

  int kt0, kt1;
  mask.key_tiles(q0, q0 + BT, kt0, kt1);
  // first walk: each row's log-sum-exp, a running (max, sum) a thread
  // over its columns, merged over the row's 16 lanes
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = ftile::NEG_INF, l[a] = 0.f;
  float s[4][4];
  for (int kt = kt0; kt <= kt1; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, k + kbase, kt * BT, mask.skv);
    __syncthreads();
    dot_tile<DH>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!mask.keep(q0 + ty * 4 + a, kt * BT + tx + 16 * b)) continue;
        const float x = __fmul_rn(s[a][b], scale);
        const float mn = fmaxf(m[a], x);
        l[a] = l[a] * expf(m[a] - mn) + expf(x - mn);
        m[a] = mn;
      }
  }
  float lse[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[a], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[a], off);
      const float mn = fmaxf(m[a], mo);
      l[a] = l[a] * expf(m[a] - mn) + lo * expf(mo - mn);
      m[a] = mn;
    }
    lse[a] = m[a] + logf(l[a]);
    const int i = q0 + ty * 4 + a;
    if (tx == 0 && i < mask.sq) {
      lse_out[(size_t)bh * mask.sq + i] = lse[a];
      dsum_out[(size_t)bh * mask.sq + i] = dsum[a];
    }
  }

  // second walk: dq += dS K
  float acc[4][DH / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[a][c] = 0.f;
  float dp[4][4];
  for (int kt = kt0; kt <= kt1; ++kt) {
    __syncthreads();
    load_tile<T, DH>(Ks, k + kbase, kt * BT, mask.skv);
    load_tile<T, DH>(Vs, v + kbase, kt * BT, mask.skv);
    __syncthreads();
    dot_tile<DH>(s, Qs, Ks, ty, tx);
    dot_tile<DH>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool kept = mask.keep(q0 + ty * 4 + a, kt * BT + tx + 16 * b);
        const float p = kept ? expf(__fmul_rn(s[a][b], scale) - lse[a]) : 0.f;
        dSs[(ty * 4 + a) * (BT + 1) + tx + 16 * b] = p * (dp[a][b] - dsum[a]);
      }
    __syncthreads();
    acc_tile<DH>(acc, dSs, Ks, ty, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i < mask.sq)
#pragma unroll
      for (int c = 0; c < DH / 16; ++c)
        dq[qbase + (size_t)i * DH + tx + 16 * c] =
            from_f<T>(__fmul_rn(acc[a][c], scale));
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ dsum_in, T* __restrict__ dk,
                   T* __restrict__ dv, int group, Mask mask, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * (DH + 1);
  float* Qs = Vs + BT * (DH + 1);
  float* dOs = Qs + BT * (DH + 1);
  float* Ps = dOs + BT * (DH + 1);
  float* dSs = Ps + BT * (BT + 1);
  float* Ls = dSs + BT * (BT + 1);
  float* Ds = Ls + BT;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t kbase = (size_t)kvh * mask.skv * DH;
  load_tile<T, DH>(Ks, k + kbase, k0, mask.skv);
  load_tile<T, DH>(Vs, v + kbase, k0, mask.skv);

  float dka[4][DH / 16], dva[4][DH / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) dka[a][c] = dva[a][c] = 0.f;
  int qt0, qt1;
  mask.query_tiles(k0, k0 + BT, qt0, qt1);
  float st[4][4], dpt[4][4];
  for (int g = 0; g < group; ++g) {
    const int bh = kvh * group + g;
    const size_t qbase = (size_t)bh * mask.sq * DH;
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();
      load_tile<T, DH>(Qs, q + qbase, q0, mask.sq);
      load_tile<T, DH>(dOs, dout + qbase, q0, mask.sq);
      for (int r = tid; r < BT; r += THREADS) {
        const bool in = q0 + r < mask.sq;
        Ls[r] = in ? lse_in[(size_t)bh * mask.sq + q0 + r] : 0.f;
        Ds[r] = in ? dsum_in[(size_t)bh * mask.sq + q0 + r] : 0.f;
      }
      __syncthreads();
      dot_tile<DH>(st, Ks, Qs, ty, tx);
      dot_tile<DH>(dpt, Vs, dOs, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = ty * 4 + a, il = tx + 16 * b;
          const bool kept = mask.keep(q0 + il, k0 + jl);
          const float p =
              kept ? expf(__fmul_rn(st[a][b], scale) - Ls[il]) : 0.f;
          Ps[jl * (BT + 1) + il] = p;
          dSs[jl * (BT + 1) + il] = p * (dpt[a][b] - Ds[il]);
        }
      __syncthreads();
      acc_tile<DH>(dva, Ps, dOs, ty, tx);
      acc_tile<DH>(dka, dSs, Qs, ty, tx);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty * 4 + a;
    if (j < mask.skv)
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        dk[kbase + (size_t)j * DH + tx + 16 * c] =
            from_f<T>(__fmul_rn(dka[a][c], scale));
        dv[kbase + (size_t)j * DH + tx + 16 * c] = from_f<T>(dva[a][c]);
      }
  }
}

template <typename T, int DH>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
        T* dk, T* dv, float* lse, float* dsum, int bh, int group, Mask mask,
        float scale, cudaStream_t stream) {
  auto dq_kernel = fa_bwd_dq_kernel<T, DH>;
  auto dkdv_kernel = fa_bwd_dkdv_kernel<T, DH>;
  static const int err0 = ftile::allow_smem(dq_kernel, dq_smem<DH>()) |
                          ftile::allow_smem(dkdv_kernel, dkdv_smem<DH>());
  if (err0) return err0;
  dq_kernel<<<dim3((mask.sq + BT - 1) / BT, bh), THREADS, dq_smem<DH>(),
              stream>>>(q, k, v, o, dout, dq, lse, dsum, group, mask, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<dim3((mask.skv + BT - 1) / BT, bh / group), THREADS,
                dkdv_smem<DH>(), stream>>>(q, k, v, dout, lse, dsum, dk, dv,
                                           group, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int bh, int group, int sq, int skv, int dh,
           int causal, int window, float scale, void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || skv < 1 ||
      (causal && sq != skv) || window < 0 || (window && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{sq, skv, causal, window};
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* to = static_cast<const T*>(o);
  const auto* td = static_cast<const T*>(dout);
  auto* gq = static_cast<T*>(dq);
  auto* gk = static_cast<T*>(dk);
  auto* gv = static_cast<T*>(dv);
  auto* fl = static_cast<float*>(lse);
  auto* fd = static_cast<float*>(dsum);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return run<T, 16>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, mask, scale, st);
    case 32: return run<T, 32>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, mask, scale, st);
    case 64: return run<T, 64>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, mask, scale, st);
    case 128: return run<T, 128>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, mask, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, void* dq,
                                  void* dk, void* dv, void* lse, void* dsum,
                                  int bh, int group, int sq, int skv, int dh,
                                  int causal, int window, float scale,
                                  void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, dsum, bh, group, sq,
                       skv, dh, causal, window, scale, stream);
}

extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dsum, int bh,
                                   int group, int sq, int skv, int dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, bh,
                               group, sq, skv, dh, causal, window, scale,
                               stream);
}
