// secure_matmul: both parties' Beaver post-open combine in one launch,
//   z_0 = c_0 + eps @ b_0 + a_0 @ dlt + eps @ dlt
//   z_1 = c_1 + eps @ b_1 + a_1 @ dlt
// over Z_{2**32} (int32) or Z_{2**64} (int64), batched.
//
// Replaces the Pallas kernel repro/kernels/secure_matmul.py:secure_matmul
// (pallas_call at :60), which computed the same combine on int32 with a
// K-innermost sequential grid and a VMEM accumulator. Here one block owns
// an output tile of BOTH parties and loops over K itself: the opened eps
// and dlt tiles are loaded into shared memory once and serve both
// parties, and party 0's two eps products fold into one, exactly, in the
// ring: eps@b_0 + eps@dlt = eps@(b_0 + dlt). So each (m, n, k) costs 4
// multiply-adds for the two parties instead of 5, and the inputs are read
// once each.
//
// Bound on H100: operations, on the CUDA cores (no tensor-core path for
// int32/int64; int64 multiplies are emulated). Same tile core and micro-
// tile as ring_matmul (ring_tile.cuh). Batch on gridDim.z, with a batch
// stride per operand (0 broadcasts).
#include "ring_tile.cuh"

namespace {

// six operand tiles live in shared memory at once: keep them at 24 KB
template <typename T> struct Depth { static constexpr int BK = 16; };
template <> struct Depth<int64_t> { static constexpr int BK = 8; };

struct Ptrs {
  const void *eps, *dlt, *a0, *a1, *b0, *b1, *c0, *c1;
  void *z0, *z1;
  long long s_eps, s_dlt, s_a0, s_a1, s_b0, s_b1, s_c0, s_c1;
};

template <typename T>
__global__ void __launch_bounds__(ring::THREADS)
secure_matmul_kernel(Ptrs p, int M, int N, int K) {
  using U = typename ring::Unsigned<T>::type;
  using namespace ring;
  constexpr int BK = Depth<T>::BK;
  __shared__ U se[BK][BM + 1], sa0[BK][BM + 1], sa1[BK][BM + 1];
  __shared__ U sd[BK][BN], sb0[BK][BN], sb1[BK][BN];
  const long long b = blockIdx.z;
  const U* eps = static_cast<const U*>(p.eps) + b * p.s_eps;
  const U* dlt = static_cast<const U*>(p.dlt) + b * p.s_dlt;
  const U* a0 = static_cast<const U*>(p.a0) + b * p.s_a0;
  const U* a1 = static_cast<const U*>(p.a1) + b * p.s_a1;
  const U* b0 = static_cast<const U*>(p.b0) + b * p.s_b0;
  const U* b1 = static_cast<const U*>(p.b1) + b * p.s_b1;
  const U* c0 = static_cast<const U*>(p.c0) + b * p.s_c0;
  const U* c1 = static_cast<const U*>(p.c1) + b * p.s_c1;
  const long long so = b * (long long)M * N;
  U* z0 = static_cast<U*>(p.z0) + so;
  U* z1 = static_cast<U*>(p.z1) + so;
  const int r0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  U acc0[TM][TN], acc1[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc0[i][j] = acc1[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<U, BK>(se, eps, M, K, r0, k0);
    load_a<U, BK>(sa0, a0, M, K, r0, k0);
    load_a<U, BK>(sa1, a1, M, K, r0, k0);
    load_b<U, BK>(sd, dlt, K, N, k0, col0);
    load_b<U, BK>(sb0, b0, K, N, k0, col0);
    load_b<U, BK>(sb1, b1, K, N, k0, col0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      U ev[TM], a0v[TM], a1v[TM], dv[TN], bdv[TN], b1v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ev[i] = se[k][ty + 16 * i];
        a0v[i] = sa0[k][ty + 16 * i];
        a1v[i] = sa1[k][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        dv[j] = sd[k][tx + 16 * j];
        bdv[j] = sb0[k][tx + 16 * j] + dv[j];
        b1v[j] = sb1[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc0[i][j] += ev[i] * bdv[j] + a0v[i] * dv[j];
          acc1[i][j] += ev[i] * b1v[j] + a1v[i] * dv[j];
        }
    }
    __syncthreads();
  }
  store<U>(z0, c0, acc0, M, N, r0, col0);
  store<U>(z1, c1, acc1, M, N, r0, col0);
}

template <typename T>
int launch(const Ptrs& p, int batch, int M, int N, int K, void* stream) {
  dim3 grid((N + ring::BN - 1) / ring::BN, (M + ring::BM - 1) / ring::BM,
            batch);
  secure_matmul_kernel<T><<<grid, ring::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(p, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

Ptrs pack(const void* eps, const void* dlt, const void* a0, const void* a1,
          const void* b0, const void* b1, const void* c0, const void* c1,
          void* z0, void* z1, const long long* strides) {
  return Ptrs{eps, dlt, a0, a1, b0, b1, c0, c1, z0, z1,
              strides[0], strides[1], strides[2], strides[3],
              strides[4], strides[5], strides[6], strides[7]};
}

}  // namespace

// strides: batch strides in elements of eps, dlt, a0, a1, b0, b1, c0, c1
extern "C" int secure_matmul_i32(const void* eps, const void* dlt,
                                 const void* a0, const void* a1,
                                 const void* b0, const void* b1,
                                 const void* c0, const void* c1, void* z0,
                                 void* z1, const long long* strides,
                                 int batch, int M, int N, int K,
                                 void* stream) {
  return launch<int32_t>(pack(eps, dlt, a0, a1, b0, b1, c0, c1, z0, z1,
                              strides), batch, M, N, K, stream);
}

extern "C" int secure_matmul_i64(const void* eps, const void* dlt,
                                 const void* a0, const void* a1,
                                 const void* b0, const void* b1,
                                 const void* c0, const void* c1, void* z0,
                                 void* z1, const long long* strides,
                                 int batch, int M, int N, int K,
                                 void* stream) {
  return launch<int64_t>(pack(eps, dlt, a0, a1, b0, b1, c0, c1, z0, z1,
                              strides), batch, M, N, K, stream);
}
