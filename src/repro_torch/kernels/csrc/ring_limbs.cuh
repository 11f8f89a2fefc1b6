// Building blocks of the limb-split ring GEMMs (ring_matmul.cu,
// secure_matmul.cu): an element of Z_{2**32} or Z_{2**64} is read as its
// two's-complement bits, unsigned, in little-endian bytes (limbs), so
// splitting a tile into limb tiles is a byte permutation and no
// arithmetic. `transpose4` is that permutation for four 32-bit words: it
// gathers byte l of each word into word l, which is how four consecutive
// elements of K become one 32-bit register (or shared-memory word) of each
// limb, the lowest element in the lowest byte, as the u8 `wgmma` operands
// read K. Around it: the raw A tile's layout and the split of a
// warpgroup's A fragments from it, the store of B's K-major limb tiles,
// the issue of a k-step's limb products into the diagonal tiles, and a
// persistent block's walk over its tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"
#include "wgmma_ops.cuh"

namespace limbs {

// out[l] = byte l of w0 | byte l of w1 << 8 | byte l of w2 << 16 | byte l
// of w3 << 24: two rounds of __byte_perm (prmt), eight in all
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.0 w1.0 w0.1 w1.1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);  // w0.2 w1.2 w0.3 w1.3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);             // w0.0 w1.0 w2.0 w3.0
  out[1] = __byte_perm(t0, t2, 0x7632);             // w0.1 w1.1 w2.1 w3.1
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// 8-byte asynchronous copy (the 4- and 16-byte ones are in
// hopper_tile.cuh); `ok` false zero-fills the destination and reads
// nothing
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// `cp_async8` for int64 elements, `hopper::cp_async4` for int32
template <int E>
__device__ __forceinline__ void cp_async_elem(uint32_t dst, const void* src,
                                              bool ok) {
  if constexpr (E == 4)
    hopper::cp_async4(dst, src, ok);
  else
    cp_async8(dst, src, ok);
}

// A raw A tile in shared memory: 64 rows of ROW_A bytes (64 int32 or 32
// int64 elements of K). Byte offset of 16-byte chunk `c` of row `r`: odd
// rows XOR the chunk with 5, so that a quarter-warp's fragment loads (rows
// r, r + 1, 4 chunks each) and its copies (8 chunks of a row) meet 8
// distinct banks
constexpr int ROW_A = 256;
__device__ __forceinline__ int a_off(int r, int c) {
  return r * ROW_A + ((c ^ ((r & 1) * 5)) << 4);
}

// the wgmma A fragments of k-step `ks` for every limb, from raw A: thread
// t of a warpgroup holds in register h row r0 = 16 (t / 32) + t % 32 / 4
// (+ 8 if h is odd), elements 32 ks + 16 (h / 2) + 4 (t % 4) + [0, 4), the
// lowest in the lowest byte
template <typename T>
__device__ __forceinline__ void split_a(const char* raw, int ks,
                                        uint32_t (&f)[sizeof(T)][4]) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = r0 + 8 * (h & 1), e = 32 * ks + 16 * (h >> 1) + 4 * q;
    uint32_t w[4];
    if constexpr (sizeof(T) == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(raw + a_off(r, e / 4));
      transpose4(x.x, x.y, x.z, x.w, w);
#pragma unroll
      for (int l = 0; l < 4; ++l) f[l][h] = w[l];
    } else {
      const uint4 x = *reinterpret_cast<const uint4*>(raw + a_off(r, e / 2));
      const uint4 y =
          *reinterpret_cast<const uint4*>(raw + a_off(r, e / 2 + 1));
      transpose4(x.x, x.z, y.x, y.z, w);                // low words
#pragma unroll
      for (int l = 0; l < 4; ++l) f[l][h] = w[l];
      transpose4(x.y, x.w, y.y, y.w, w);                // high words
#pragma unroll
      for (int l = 0; l < 4; ++l) f[4 + l][h] = w[l];
    }
  }
}

// 16 elements of K of one column n of B -> bytes [k, k + 16) of row n of
// each of the L K-major limb tiles (hopper::Tile<BN, BK>, LB bytes apart)
// at `lt`; x[h][j] is 32-bit word h of element k + j, and word h holds
// limbs 4 h .. 4 h + 3
template <int L, int BN, int BK, int LB>
__device__ __forceinline__ void store_limbs(const uint32_t (&x)[L / 4][16],
                                            char* lt, int n, int k) {
  using LT = hopper::Tile<BN, BK>;
#pragma unroll
  for (int h = 0; h < L / 4; ++h) {
    uint32_t w[4][4];              // [limb][4 elements of K]
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t t[4];
      transpose4(x[h][4 * m], x[h][4 * m + 1], x[h][4 * m + 2],
                 x[h][4 * m + 3], t);
#pragma unroll
      for (int l = 0; l < 4; ++l) w[l][m] = t[l];
    }
#pragma unroll
    for (int l = 0; l < 4; ++l)
      *reinterpret_cast<uint4*>(lt + (4 * h + l) * LB + LT::offset(n, k)) =
          make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
  }
}

// D_s += A_i B_{s - i} for every limb pair of k-step `ks`: A's fragments
// `f`, B's L K-major limb tiles (hopper::Tile<BN, BK>, LB bytes apart) at
// shared address `lt`; one `wgmma` m64nBNk32 .s32.u8.u8 each
template <int L, int BN, int BK, int LB>
__device__ __forceinline__ void issue(uint32_t (&acc)[L][BN / 2],
                                      const uint32_t (&f)[L][4], uint32_t lt,
                                      int ks) {
  using LT = hopper::Tile<BN, BK>;
  constexpr int W = LT::W;
#pragma unroll
  for (int s = 0; s < L; ++s)
#pragma unroll
    for (int i = 0; i <= s; ++i)
      hopper::Wgmma<BN>::rs_u8(
          acc[s], f[i],
          hopper::desc(lt + (s - i) * LB + LT::start(0, 32 * ks), 16, 8 * W,
                       W),
          1);
}

// A persistent block's walk: it takes the output tiles blockIdx.x, +
// gridDim.x, ... (numbered over (batch, row tile, column tile), column
// tiles fastest, so that the blocks in flight share A's rows) as one
// stream of (tile, k-tile) items, so that the copies of the next item
// run under the work of this one, across tiles too. A Walk is a place in
// that stream: output tile (z, row tile my, column tile nx), k-tile kt
struct Walk {
  int kt, nx, my, z;
};

struct Walker {
  int tm, tn, nt;               // row tiles, column tiles, k-tiles
  int gn, gm, gz;               // the stride gridDim.x in (z, my, nx) digits
  __device__ __forceinline__ Walker(int tm_, int tn_, int nt_)
      : tm(tm_), tn(tn_), nt(nt_), gn(gridDim.x % tn_),
        gm(gridDim.x / tn_ % tm_), gz(gridDim.x / tn_ / tm_) {}
  __device__ __forceinline__ Walk first() const {
    const int b = blockIdx.x;
    return Walk{0, b % tn, b / tn % tm, b / tn / tm};
  }
  __device__ __forceinline__ void advance(Walk& w) const {
    if (++w.kt < nt) return;
    w.kt = 0;
    w.nx += gn;
    const int cn = w.nx >= tn;
    w.nx -= cn * tn;
    w.my += gm + cn;
    const int cm = w.my >= tm;
    w.my -= cm * tm;
    w.z += gz + cm;
  }
};

}  // namespace limbs
