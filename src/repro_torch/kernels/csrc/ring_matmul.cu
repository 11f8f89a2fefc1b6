// ring_matmul: batched wrapping integer GEMM C[b] = A[b] @ B[b] over
// Z_{2**32} (int32) or Z_{2**64} (int64), on Hopper's int8 tensor cores.
//
// Replaces the integer products the TPU build left to XLA
// (jnp.matmul(..., preferred_element_type=int32/int64)): the dealer's
// triple product (repro/mpc/protocols/additive2pc.py:71), the batched
// attention products and every RING64 combine (additive2pc.py:243-249).
// PyTorch has no CUDA matmul for int32/int64, so without this kernel the
// MPC path cannot run on the card at all.
//
// The arithmetic, exact. An element is its two's-complement bits read
// unsigned, in L little-endian bytes (limbs): a = sum_i a_i 2^(8 i), L = 4
// for int32 and 8 for int64. With A_i the u8 matrix of A's limb i,
//   C mod 2^(8 L) = sum_{s < L} 2^(8 s) D_s,   D_s = sum_{i + j = s} A_i B_j,
// so only the limb pairs with i + j < L count: 10 u8 products for int32,
// 36 for int64 (the reference names the same split: "an MXU path would
// decompose into 4x int8 partial products", repro/kernels/
// secure_matmul.py:10-12). Each diagonal D_s is one s32 accumulator tile
// into which its pairs are issued. D_s <= (s + 1) 255^2 K stays below
// 2^31, with no wrap or saturation, while K <= K_CHUNK: 8,192 elements
// for int32 (the limit is 8,256) and 4,096 for int64 (4,128). Every
// K_CHUNK the diagonals are folded into C, sum_s D_s << 8 s in wrapping
// u32 / u64 (straight into the output tile, which the block alone owns),
// and start again; the path's largest K is 768, one chunk.
//
// Bound on the H100: the u8 products at the int8 tensor cores' 1,979
// TOP/s (10 or 36 x 2 M N K) against A, B and C at the element size at
// 3.35 TB/s. At the path's shapes (phase 3's wave of 4, BERT width):
// scores (384, 512, 64, 512) and probs @ v (192, 512, 512, 64) are
// bytes-bound (int32 0.150 and 0.075 ms, int64 0.300 and 0.150), the
// projection (4, 2048, 768, 768) operations-bound (0.049 / 0.176 ms), the
// MLP's (4, 24576, 512, 16) bytes-bound (0.062 / 0.124 ms). The CUDA
// cores' 67 T/s, where the parent kernel ran, take 0.192, 0.096, 0.144 and
// 0.024 ms for the same products' multiply-adds alone.
// What the design does about it:
// - Operands reach shared memory by `cp.async` into two stages, each
//   completing on one mbarrier (cp.async.mbarrier.arrive.noinc). Chosen
//   over TMA because a K or N whose rows are not 16-byte aligned (the
//   path's K = 1 and N = 1 products, any odd K) needs 4- or 8-byte element
//   copies, which a tensor map cannot describe (its global strides are
//   multiples of 16 bytes), and one zero-filling source size covers every
//   edge with no tensor map built on the host. Rows are copied in 16-byte
//   chunks where K (for A) or N (for B) allows, each thread always the
//   same chunk column, so a stage costs it a few adds. Zero-filled limbs
//   add 0 to every D_s, so the edges need no mask before the store.
// - A's limbs never reach shared memory: each thread loads the raw
//   elements of its own wgmma A fragment (rows r and r + 8, 4 + 4
//   elements a k-step of 32) with 16-byte loads and splits them with
//   `transpose4` (ring_limbs.cuh, prmt) into the fragments of all L limbs,
//   which `wgmma` reads from registers. The raw A rows are 256 bytes, their
//   16-byte chunks XORed with 5 on odd rows, so those loads and the
//   copies are free of bank conflicts.
// - 8-bit `wgmma` takes K-major B only, and B is N-major in memory: its
//   raw tile (BK rows of BN elements) is split by the same transpose into
//   L K-major limb tiles (BN rows of BK bytes, the swizzled layout of
//   hopper_tile.cuh's Tile), double-buffered, so the split of one item
//   never writes under the products of the one before.
// - Per k-step, L (L + 1) / 2 `wgmma` m64nBNk32 .s32.u8.u8 (IGMMA) into
//   the L diagonal tiles. BN = 64 for int32 and 32 for int64 (16 where N
//   <= 16), so that the L accumulator tiles are 128 registers a thread
//   either way and nothing spills.
// - The epilogue folds the diagonals and stores each thread's pairs of
//   adjacent columns (8 or 16 bytes) with the ragged edge masked.
// - Persistent blocks, as many as the card holds at once: a block walks
//   its output tiles as one stream of (tile, k-tile) items and copies item
//   g + 1 while item g splits, multiplies and stores, across tiles too.
//   The scores' (384, 512, 64, 512) has one k-tile a tile, so without the
//   walk every block would wait for its copies with nothing to overlap.
// Tiles: one warpgroup of 64 rows a block; BK = 256 bytes of A's row (64
// int32 or 32 int64 elements); two blocks an SM (registers and shared
// memory). What holds it back is that a block's own steps run in turn:
// copies wait, the split runs on the CUDA cores with the tensor cores
// idle, and the products wait (wgmma.wait_group 0) before the next split;
// only the SM's other block fills the gaps.
// Later work: a warp-specialised producer (TMA for aligned shapes) with
// the splits in their own warps, so that two consumer warpgroups sharing
// B's limb tiles only issue products; C staged through shared memory for
// 16-byte stores.
//
// Batch: tiles are numbered over (batch, row tile, column tile); each
// operand has its own batch stride in elements, and stride 0 broadcasts
// one matrix (a weight) over the batch. Inner matrices are row-major and
// contiguous; C is contiguous.
#include <climits>
#include <type_traits>

#include "hopper_tile.cuh"
#include "ring_limbs.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;
using limbs::a_off;
using limbs::cp_async_elem;
using limbs::ROW_A;             // bytes of a raw A row in shared memory
using limbs::Walk;

constexpr int BM = 64;          // rows of a block: one wgmma M
constexpr int THREADS = 128;    // one warpgroup

// K_CHUNK: elements of K summed in a diagonal before it is folded
constexpr int K_CHUNK_I32 = 8192;
constexpr int K_CHUNK_I64 = 4096;

template <typename T, int BN>
struct Cfg {
  using U = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      unsigned long long>::type;
  static constexpr int L = sizeof(T);          // limbs an element
  static constexpr int E = sizeof(T);          // bytes an element
  static constexpr int BK = ROW_A / E;         // elements of K a tile
  static constexpr int KSTEPS = BK / 32;       // u8 k-steps a tile
  static constexpr int KCH = L == 4 ? K_CHUNK_I32 : K_CHUNK_I64;
  static_assert((long long)L * 255 * 255 * KCH < (1LL << 31),
                "the top diagonal would leave s32 within K_CHUNK");
  static_assert(KCH % BK == 0, "a chunk ends on a tile");
  using LT = Tile<BN, BK>;                     // a K-major limb tile of B
  static constexpr int A_B = BM * ROW_A;       // a raw A stage
  static constexpr int B_B = align1024(BK * BN * E);
  static constexpr int L_B = align1024(LT::BYTES);
  // layout: raw A x 2 | raw B x 2 | L limb tiles of B x 2 | mbarriers
  static constexpr int B0 = 2 * A_B;
  static constexpr int LIMB0 = B0 + 2 * B_B;
  static constexpr int BARS = LIMB0 + 2 * L * L_B;
  static constexpr int BYTES = BARS + 16 + 1024;      // + alignment
  static_assert(BYTES <= 232448, "tile does not fit in shared memory");
};

// The copies of a stage: A rows [m0, m0 + 64) x K [k0, k0 + BK) and B rows
// [k0, k0 + BK) x N [n0, n0 + BN), whatever lies past an edge zero-filled.
// In the 16-byte path a thread copies the same chunk column of A (rows r,
// r + 8, ...) and of B (rows r', r' + RB, ...) in every stage, so its
// addresses are fixed at the block's start and a stage adds k0.
template <typename T, int BN>
struct Copies {
  using C = Cfg<T, BN>;
  static constexpr int E = C::E, V = 16 / E;     // elements a chunk
  static constexpr int CB = BN * E / 16;         // chunks a raw B row
  static constexpr int RB = THREADS / CB;        // raw B rows a pass
  static_assert(THREADS % CB == 0 && C::BK % RB == 0, "B's passes");
  const T *a, *b, *pa, *pb;    // operands; this thread's first chunks
  int M, N, K, m0, n0;
  int rows_a, ka, kb;          // A passes in range; K of its chunks
  bool col_b, vec_a, vec_b;
  uint32_t da, db;             // its first chunks' offsets in a stage

  __device__ __forceinline__ Copies(const T* a_, const T* b_, int M_, int N_,
                                    int K_, int m0_, int n0_, bool vec_a_,
                                    bool vec_b_)
      : a(a_), b(b_), M(M_), N(N_), K(K_), m0(m0_), n0(n0_), vec_a(vec_a_),
        vec_b(vec_b_) {
    const int t = threadIdx.x, ra = t / 16, rb = t / CB;
    pa = a + (long long)(m0 + ra) * K + t % 16 * V;
    pb = b + (long long)rb * N + n0 + t % CB * V;
    rows_a = (M - m0 - ra + 7) / 8;
    ka = t % 16 * V;
    kb = rb;
    col_b = n0 + t % CB * V < N;
    da = a_off(ra, t % 16);
    db = rb * BN * E + t % CB * 16;
  }

  __device__ __forceinline__ void operator()(uint32_t sm, int st,
                                             int k0) const {
    const uint32_t sa = sm + st * C::A_B, sb = sm + C::B0 + st * C::B_B;
    if (vec_a) {
      const bool okk = k0 + ka < K;
      const T* p = pa + k0;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const bool ok = okk && j < rows_a;
        cp_async16(sa + da + j * 8 * ROW_A, ok ? p + (long long)j * 8 * K : a,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < BM * C::BK; i += THREADS) {
        const int r = i / C::BK, e = i % C::BK, k = k0 + e;
        const bool ok = m0 + r < M && k < K;
        cp_async_elem<E>(sa + a_off(r, e / V) + e % V * E,
                         ok ? a + (long long)(m0 + r) * K + k : a, ok);
      }
    }
    if (vec_b) {
      const T* p = pb + (long long)k0 * N;
#pragma unroll
      for (int j = 0; j < C::BK / RB; ++j) {
        const bool ok = col_b && k0 + kb + j * RB < K;
        cp_async16(sb + db + j * RB * BN * E,
                   ok ? p + (long long)j * RB * N : b, ok);
      }
    } else {
      for (int i = threadIdx.x; i < C::BK * BN; i += THREADS) {
        const int r = i / BN, e = i % BN, n = n0 + e;
        const bool ok = k0 + r < K && n < N;
        cp_async_elem<E>(sb + (r * BN + e) * E,
                         ok ? b + (long long)(k0 + r) * N + n : b, ok);
      }
    }
    cp_async_arrive(sm + C::BARS + 8 * st);
  }
};

// raw B of stage `st` (BK rows of BN elements) -> its L K-major limb tiles
// (BN rows of BK bytes): a thread takes 16 elements of K in one column n
// (conflict-free loads along the row), transposes their bytes four
// elements at a time, and stores 16 bytes of each limb's row n
template <typename T, int BN>
__device__ __forceinline__ void split_b(char* gsm, int st) {
  using C = Cfg<T, BN>;
  const char* raw = gsm + C::B0 + st * C::B_B;
  char* lt = gsm + C::LIMB0 + st * C::L * C::L_B;
  for (int i = threadIdx.x; i < BN * (C::BK / 16); i += THREADS) {
    const int n = i % BN, k = i / BN * 16;
    uint32_t x[C::E / 4][16];        // [32-bit word of an element][element]
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const char* p = raw + ((k + j) * BN + n) * C::E;
      if constexpr (C::E == 4) {
        x[0][j] = *reinterpret_cast<const uint32_t*>(p);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        x[0][j] = v.x;
        x[1][j] = v.y;
      }
    }
    limbs::store_limbs<C::L, BN, C::BK, C::L_B>(x, lt, n, k);
  }
}

// C (+)= sum_s D_s << 8 s for this thread's fragment: rows r0, r0 + 8 of
// the tile, columns 8 j + c2 + [0, 2); `first` stores, else adds to C
template <typename T, int BN>
__device__ __forceinline__ void fold(const uint32_t (&acc)[sizeof(T)][BN / 2],
                                     typename Cfg<T, BN>::U* c, int M, int N,
                                     int m0, int n0, bool first) {
  using C = Cfg<T, BN>;
  using U = typename C::U;
  using U2 = typename std::conditional<C::E == 4, uint2, ulonglong2>::type;
  const int lane = threadIdx.x % 32;
  const int r0 = m0 + 16 * (threadIdx.x / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    U* row = c + (long long)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c2;
      U v0 = 0, v1 = 0;
#pragma unroll
      for (int s = 0; s < C::L; ++s) {
        v0 += (U)acc[s][4 * j + 2 * h] << (8 * s);
        v1 += (U)acc[s][4 * j + 2 * h + 1] << (8 * s);
      }
      if (pairs && col + 1 < N) {
        U2* p = reinterpret_cast<U2*>(row + col);
        if (!first) {
          const U2 o = *p;
          v0 += o.x;
          v1 += o.y;
        }
        U2 out;
        out.x = v0;
        out.y = v1;
        *p = out;
      } else {
        if (col < N) row[col] = first ? v0 : row[col] + v0;
        if (col + 1 < N) row[col + 1] = first ? v1 : row[col + 1] + v1;
      }
    }
  }
}

// A persistent block walks its (tile, k-tile) items (limbs::Walker): the
// copies of item g + 1 run under the products and the stores of item g,
// across tiles too
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS)
ring_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ Cm, int batch, int M, int N, int K,
                   long long sA, long long sB, int vec_a, int vec_b) {
  using C = Cfg<T, BN>;
  constexpr int L = C::L, BK = C::BK;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`

  // K = 0 is one zero-filled k-tile, so that C is written as zeros
  const limbs::Walker walk((M + BM - 1) / BM, (N + BN - 1) / BN,
                           K > 0 ? (K + BK - 1) / BK : 1);
  auto copies = [&](const Walk& w) {
    return Copies<T, BN>(A + w.z * sA, B + w.z * sB, M, N, K, w.my * BM,
                         w.nx * BN, vec_a, vec_b);
  };
  Walk ld = walk.first();                      // next item to copy
  Walk cu = ld;                                // item computed

  if (threadIdx.x == 0) {
    mbar_init(sm + C::BARS, THREADS);
    mbar_init(sm + C::BARS + 8, THREADS);
    fence_mbar_init();
  }
  __syncthreads();

  uint32_t acc[L][BN / 2];
#pragma unroll
  for (int s = 0; s < L; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0;
  uint32_t f[L][4];

  Copies<T, BN> copy = copies(ld);
  if (ld.z < batch) {
    copy(sm, 0, 0);
    walk.advance(ld);
    if (ld.kt == 0) copy = copies(ld);
  }
  for (int g = 0; cu.z < batch; ++g) {
    const int st = g & 1;
    mbar_wait(sm + C::BARS + 8 * st, (g >> 1) & 1);
    split_b<T, BN>(gsm, st);
    fence_proxy_async();
    // past here every thread is done with item g - 1: its raw stage takes
    // item g + 1 while this one's products run
    __syncthreads();
    if (ld.z < batch) {
      copy(sm, st ^ 1, ld.kt * BK);
      walk.advance(ld);
      if (ld.kt == 0) copy = copies(ld);
    }
    const char* ra = gsm + st * C::A_B;
    const uint32_t lt = sm + C::LIMB0 + st * L * C::L_B;
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      limbs::split_a<T>(ra, ks, f);
      wgmma_fence();
      limbs::issue<L, BN, BK, C::L_B>(acc, f, lt, ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < L; ++s) fence_regs(acc[s]);
#pragma unroll
      for (int i = 0; i < L; ++i) fence_regs(f[i]);
    }
    // the tile's last k-tile, or a chunk of K ends: fold the diagonals
    // into C (stored by the tile's first fold, added to by the others)
    // and start again
    if (cu.kt == walk.nt - 1 || (cu.kt + 1) * BK % C::KCH == 0) {
      fold<T, BN>(acc, reinterpret_cast<typename C::U*>(Cm) +
                           (long long)cu.z * M * N,
                  M, N, cu.my * BM, cu.nx * BN, (cu.kt + 1) * BK <= C::KCH);
#pragma unroll
      for (int s = 0; s < L; ++s)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0;
    }
    walk.advance(cu);
  }
}

template <typename T, int BN>
int run(const void* A, const void* B, void* C, int batch, int M, int N, int K,
        long long sA, long long sB, void* stream) {
  constexpr int bytes = Cfg<T, BN>::BYTES, V = 16 / sizeof(T);
  auto kernel = ring_matmul_kernel<T, BN>;
  static const int smem_err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (smem_err) return smem_err;
  // as many blocks as the card holds at once (the first device's count)
  static const int slots = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                  bytes);
    return sms * per_sm;
  }();
  const long long tiles = (long long)batch * ((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN);
  if (slots <= 0 || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies where every row starts on a 16-byte boundary
  const int vec_a = K % V == 0 && sA % V == 0 &&
                    reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int vec_b = N % V == 0 && sB % V == 0 &&
                    reinterpret_cast<uintptr_t>(B) % 16 == 0;
  kernel<<<(int)(tiles < slots ? tiles : slots), THREADS, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<T*>(C),
      batch, M, N, K, sA, sB, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, const void* B, void* C, int batch, int M, int N,
           int K, long long sA, long long sB, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 16)
    return run<T, 16>(A, B, C, batch, M, N, K, sA, sB, stream);
  return run<T, sizeof(T) == 4 ? 64 : 32>(A, B, C, batch, M, N, K, sA, sB,
                                           stream);
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
