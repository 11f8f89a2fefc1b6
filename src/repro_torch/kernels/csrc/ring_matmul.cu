// ring_matmul: batched wrapping integer GEMM C[b] = A[b] @ B[b] over
// Z_{2**32} (int32) or Z_{2**64} (int64).
//
// Replaces the integer products the TPU build left to XLA
// (jnp.matmul(..., preferred_element_type=int32/int64)): the dealer's
// triple product (repro/mpc/protocols/additive2pc.py:71), the batched
// attention products and every RING64 combine (additive2pc.py:243-249).
// PyTorch has no CUDA matmul for int32/int64, so without this kernel the
// MPC path cannot run on the card at all.
//
// Bound on H100: operations. There is no tensor-core path for int32 or
// int64, so every multiply-add runs on the CUDA cores, and a 64-bit
// multiply is emulated from 32-bit IMADs. The design keeps the CUDA cores
// fed from registers: shared-memory tiles of A and B, a 4 x 4 register
// micro-tile per thread (16 multiply-adds per 8 shared loads). The int8
// limb decomposition onto tensor cores (wgmma) is the later redesign.
//
// Batch: gridDim.z walks the flattened batch; each operand has its own
// batch stride in elements, and stride 0 broadcasts one matrix (a weight)
// over the batch. Inner matrices are row-major and contiguous; C is
// contiguous.
#include "ring_tile.cuh"

namespace {

constexpr int BK = 16;

template <typename T>
__global__ void __launch_bounds__(ring::THREADS)
ring_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, int M, int N, int K, long long sA,
                   long long sB) {
  using U = typename ring::Unsigned<T>::type;
  using namespace ring;
  __shared__ U sa[BK][BM + 1];
  __shared__ U sb[BK][BN];
  const long long b = blockIdx.z;
  const U* a = reinterpret_cast<const U*>(A) + b * sA;
  const U* bb = reinterpret_cast<const U*>(B) + b * sB;
  U* c = reinterpret_cast<U*>(C) + b * (long long)M * N;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  U acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_a<U, BK>(sa, a, M, K, r0, k0);
    load_b<U, BK>(sb, bb, K, N, k0, c0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      U av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = sa[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = sb[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  store<U>(c, nullptr, acc, M, N, r0, c0);
}

template <typename T>
int launch(const void* A, const void* B, void* C, int batch, int M, int N,
           int K, long long sA, long long sB, void* stream) {
  dim3 grid((N + ring::BN - 1) / ring::BN, (M + ring::BM - 1) / ring::BM,
            batch);
  ring_matmul_kernel<T><<<grid, ring::THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      M, N, K, sA, sB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ring_matmul_i32(const void* A, const void* B, void* C,
                               int batch, int M, int N, int K, long long sA,
                               long long sB, void* stream) {
  return launch<int32_t>(A, B, C, batch, M, N, K, sA, sB, stream);
}

extern "C" int ring_matmul_i64(const void* A, const void* B, void* C,
                               int batch, int M, int N, int K, long long sA,
                               long long sB, void* stream) {
  return launch<int64_t>(A, B, C, batch, M, N, K, sA, sB, stream);
}
