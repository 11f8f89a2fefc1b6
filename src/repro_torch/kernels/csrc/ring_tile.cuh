// Tile core shared by the ring kernels (ring_matmul.cu, secure_matmul.cu).
//
// Ring arithmetic mod 2**32 / 2**64: every product and sum is taken in
// the UNSIGNED type of the same width. Signed overflow is undefined in
// C++, unsigned overflow wraps by definition, and the two's-complement
// bit pattern of the wrapped unsigned result is exactly the ring element
// the signed share holds.
//
// Layout: a block computes a BM x BN output tile with 256 threads as a
// 16 x 16 grid, each thread owning a TM x TN register micro-tile at rows
// ty + 16 i and columns tx + 16 j (strided, so a warp reads a row of the
// B tile conflict-free and broadcasts the A tile). K advances in steps of
// BK through shared memory. Tiles are loaded with bounds checks and zero
// fill, so ragged M, N and K need no host padding: a zero row or column
// contributes zero to every ring product.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring {

template <typename T> struct Unsigned;
template <> struct Unsigned<int32_t> { using type = uint32_t; };
template <> struct Unsigned<int64_t> { using type = uint64_t; };

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;
constexpr int THREADS = 256;

// Rows [r0, r0 + BM) x cols [k0, k0 + BK) of a row-major rows x cols
// matrix into sA[k][r] (transposed, one padding column against bank
// conflicts on the store).
template <typename U, int BK>
__device__ __forceinline__ void load_a(U (*sA)[BM + 1], const U* A, int rows,
                                       int cols, int r0, int k0) {
  for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
    const int r = i / BK, k = i % BK;
    const int gr = r0 + r, gk = k0 + k;
    sA[k][r] = (gr < rows && gk < cols) ? A[(long long)gr * cols + gk] : U(0);
  }
}

// Rows [k0, k0 + BK) x cols [c0, c0 + BN) of a row-major rows x cols
// matrix into sB[k][c].
template <typename U, int BK>
__device__ __forceinline__ void load_b(U (*sB)[BN], const U* B, int rows,
                                       int cols, int k0, int c0) {
  for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
    const int k = i / BN, c = i % BN;
    const int gk = k0 + k, gc = c0 + c;
    sB[k][c] = (gk < rows && gc < cols) ? B[(long long)gk * cols + gc] : U(0);
  }
}

// C[r][c] = acc (+ add[r][c] when add is given), masked to the matrix.
template <typename U>
__device__ __forceinline__ void store(U* C, const U* add, const U (&acc)[TM][TN],
                                      int rows, int cols, int r0, int c0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= cols) continue;
      const long long o = (long long)r * cols + c;
      C[o] = add ? acc[i][j] + add[o] : acc[i][j];
    }
  }
}

}  // namespace ring
