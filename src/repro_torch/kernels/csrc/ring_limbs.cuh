// Building blocks of the limb-split ring GEMM (ring_matmul.cu): an
// element of Z_{2**32} or Z_{2**64} is read as its two's-complement bits,
// unsigned, in little-endian bytes (limbs), so splitting a tile into limb
// tiles is a byte permutation and no arithmetic. `transpose4` is that
// permutation for four 32-bit words: it gathers byte l of each word into
// word l, which is how four consecutive elements of K become one 32-bit
// register (or shared-memory word) of each limb, the lowest element in the
// lowest byte, as the u8 `wgmma` operands read K.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace limbs
