// secure_matmul: both parties' Beaver post-open combine in one launch,
//   z_0 = c_0 + eps @ b_0 + a_0 @ dlt + eps @ dlt
//   z_1 = c_1 + eps @ b_1 + a_1 @ dlt
// over Z_{2**32} (int32) or Z_{2**64} (int64), batched, on Hopper's int8
// tensor cores.
//
// Replaces the Pallas kernel repro/kernels/secure_matmul.py:secure_matmul
// (pallas_call at :60), which computed the same combine on int32 with a
// K-innermost sequential grid and a VMEM accumulator. Here a block owns an
// output tile of BOTH parties, one warpgroup a party, and walks K itself:
// the opened eps and dlt tiles reach shared memory once and serve both.
//
// The arithmetic, exact. Each party's combine is ONE ring product over a
// K twice as long:
//   z_p = c_p + [eps | a_p] @ [b'_p ; dlt],   b'_0 = b_0 + dlt, b'_1 = b_1
// (party 0's eps @ b_0 + eps @ dlt = eps @ (b_0 + dlt) in the ring). The
// add b_0 + dlt wraps in the unsigned type and comes BEFORE the byte
// split: a limb-wise add would carry between limbs. Then the limb split
// of ring_matmul.cu: an element is its two's-complement bits read
// unsigned, in L little-endian bytes (L = 4 for int32, 8 for int64), and
//   z_p mod 2^(8 L) = c_p + sum_{s < L} 2^(8 s) D_s,
//   D_s = sum_{i + j = s} (eps_i b'_{p,j} + a_{p,i} dlt_j)
// with u8 limb matrices; only the pairs i + j < L count: 10 products for
// int32, 36 for int64, for each half. Both halves issue into the same L
// diagonal tiles D_s, one s32 accumulator tile each, so a diagonal sums
// 2 (s + 1) 255^2 per element of K; it stays below 2^31, with no wrap or
// saturation, while K <= K_CHUNK: 4,096 elements for int32 (the limit is
// 4,128) and 2,048 for int64 (2,064), half of ring_matmul's. Every K_CHUNK
// the diagonals are folded, sum_s D_s << 8 s in wrapping u32 / u64 onto
// c_p (the first fold) or z_p (the others: the block alone owns its
// tile), and start again; the path's K is 768, one chunk. Zero-filled
// limbs add 0 to every D_s, so the ragged edge needs no mask before the
// fold, only at the store.
//
// Bound on the H100: the u8 products, 4 ring products of 2 M N K each
// (two a party) times the limb pairs, at the int8 tensor cores' 1,979
// TOP/s, against eps, a_0, a_1, dlt, b_0, b_1, c_0, c_1 read and z_0, z_1
// written once at 3.35 TB/s (kernels/secure_matmul.py:work). At the
// path's projection combine, 4 x 2048x768 @ 768x768: operations, 0.195 ms
// (int32) and 0.703 ms (int64), against 0.061 / 0.122 ms of bytes; the
// CUDA cores' 67 T/s, where the parent kernel ran, take 0.577 ms (int32).
// What the design does about it:
// - Two consumer warpgroups a block, warpgroup p computing party p, each
//   with its own L diagonal tiles: at BN 64 (int32) or 32 (int64) they
//   are 128 accumulator registers a thread; both parties in one
//   warpgroup would need 256 and spill.
// - Both split their A fragments from the same raw eps tile, each its own
//   a_p's, by `transpose4` (ring_limbs.cuh: limbs::split_a), in
//   registers; the eps half's products are in flight while the a_p half
//   splits. Both read dlt's K-major limb tiles; b'_p's are party p's.
// - Shared memory, per block: the raw A tiles eps, a_0, a_1 (64 rows of
//   256 bytes each, 48 KB) in two stages, because the products of item g
//   read them while item g + 1's copies land; the raw B tiles dlt, b_0,
//   b_1 (48 KB at int32 BN 64) and their limb tiles dlt, b_0 + dlt, b_1
//   (3 x L x 4 KB) in ONE buffer each: B is split before the copies of
//   the next item are issued, so its raw tile is free again, and the
//   limb tiles are rewritten only after a barrier that both warpgroups
//   reach when their products are done. 192 KB at int32, 144 KB at
//   int64 (two stages of everything would take 288 KB at int32, over
//   the 227 KB a block may have). One block of 256 threads an SM.
// - Operands reach shared memory by `cp.async`, completing on one
//   mbarrier a stage, as in ring_matmul.cu: 16-byte copies where every
//   row of the three operands allows, else 4- or 8-byte element copies
//   (the path's K = 1 and N = 1 combines, odd K or N, unaligned rows),
//   with zero-fill past every edge.
// - Per k-step of 32 bytes, a warpgroup issues 2 L (L + 1) / 2 `wgmma`
//   m64nBNk32 .s32.u8.u8 (IGMMA): 20 for int32, 72 for int64.
// - Persistent blocks, one an SM: a block walks its output tiles as one
//   stream of (tile, k-tile) items, and the copies of item g + 1 run
//   under the splits and products of item g, across tiles too.
// What holds it back: a block's steps run in turn (wait, split B, two
// barriers, products), with the tensor cores idle while B splits, and
// the two warpgroups' products share one SM's tensor cores and shared-
// memory bandwidth. In development runs on the H100, leaving B's split
// out saved an eighth to a fifth; staging c_p or z_p through shared
// memory moved the time by under 3 %; and 32-element k-tiles with two
// sets of limb tiles, splitting item g + 1's B under item g's products,
// were slower: twice the items' fixed steps for half the products each.
// Later work: the splits in producer warps, so that the consumer
// warpgroups only issue products.
//
// Batch: tiles are numbered over (batch, row tile, column tile); each
// operand has its own batch stride in elements, and stride 0 broadcasts
// one matrix (a weight) over the batch. Inner matrices are row-major and
// contiguous; z_0 and z_1 are contiguous.
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

constexpr int BM = 64;          // rows of a block's tile: one wgmma M
constexpr int WG = 128;         // threads of a warpgroup
constexpr int THREADS = 2 * WG; // warpgroup p computes party p

// K_CHUNK: elements of K summed in a diagonal before it is folded
constexpr int K_CHUNK_I32 = 4096;
constexpr int K_CHUNK_I64 = 2048;

template <typename T, int BN>
struct Cfg {
  using U = typename std::conditional<sizeof(T) == 4, uint32_t,
                                      unsigned long long>::type;
  static constexpr int L = sizeof(T);          // limbs an element
  static constexpr int E = sizeof(T);          // bytes an element
  static constexpr int BK = ROW_A / E;         // elements of K a tile
  static constexpr int KSTEPS = BK / 32;       // u8 k-steps a tile
  static constexpr int KCH = L == 4 ? K_CHUNK_I32 : K_CHUNK_I64;
  static_assert(2LL * L * 255 * 255 * KCH < (1LL << 31),
                "the top diagonal's two halves would leave s32 within "
                "K_CHUNK");
  static_assert(KCH % BK == 0, "a chunk ends on a tile");
  using LT = Tile<BN, BK>;                     // a K-major limb tile
  static constexpr int A_B = BM * ROW_A;       // one raw A tile
  static constexpr int B_B = align1024(BK * BN * E);
  static constexpr int L_B = align1024(LT::BYTES);
  // layout: raw A (eps, a_0, a_1) x 2 stages | raw B (dlt, b_0, b_1) |
  // limb tiles (dlt, b_0 + dlt, b_1; L each) | 2 mbarriers
  static constexpr int B0 = 2 * 3 * A_B;
  static constexpr int LIMB0 = B0 + 3 * B_B;
  static constexpr int BARS = LIMB0 + 3 * L * L_B;
  static constexpr int BYTES = BARS + 16 + 1024;      // + alignment
  static_assert(BYTES <= 232448, "tile does not fit in shared memory");
};

struct Ptrs {
  const void *eps, *dlt, *a0, *a1, *b0, *b1, *c0, *c1;
  void *z0, *z1;
  long long s_eps, s_dlt, s_a0, s_a1, s_b0, s_b1, s_c0, s_c1;
};

// The copies of item `w` into stage `st`: rows [m0, m0 + 64) x K [k0, k0
// + BK) of eps, a_0, a_1 and rows [k0, k0 + BK) x N [n0, n0 + BN) of dlt,
// b_0, b_1, whatever lies past an edge zero-filled; then this thread
// arrives on the stage's mbarrier. In the 16-byte path thread t copies
// chunk t % 16 of A's rows t / 16 + 16 j, and chunk t % CB of B's rows
// t / CB + RB j.
template <typename T, int BN>
__device__ __forceinline__ void copy_item(const Ptrs& p, uint32_t sm, int st,
                                          const Walk& w, int M, int N, int K,
                                          bool vec_a, bool vec_b) {
  using C = Cfg<T, BN>;
  constexpr int E = C::E, V = 16 / E, BK = C::BK;
  const int t = threadIdx.x, k0 = w.kt * BK, m0 = w.my * BM, n0 = w.nx * BN;
  const T* as[3] = {static_cast<const T*>(p.eps) + w.z * p.s_eps,
                    static_cast<const T*>(p.a0) + w.z * p.s_a0,
                    static_cast<const T*>(p.a1) + w.z * p.s_a1};
  const T* bs[3] = {static_cast<const T*>(p.dlt) + w.z * p.s_dlt,
                    static_cast<const T*>(p.b0) + w.z * p.s_b0,
                    static_cast<const T*>(p.b1) + w.z * p.s_b1};
  const uint32_t sa = sm + st * 3 * C::A_B, sb = sm + C::B0;
  if (vec_a) {
    const int ra = t / 16, c = t % 16, k = k0 + c * V;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        const int r = ra + 16 * j;
        const bool ok = k < K && m0 + r < M;
        cp_async16(sa + x * C::A_B + a_off(r, c),
                   ok ? as[x] + (long long)(m0 + r) * K + k : as[x], ok);
      }
  } else {
#pragma unroll
    for (int x = 0; x < 3; ++x)
      for (int i = t; i < BM * BK; i += THREADS) {
        const int r = i / BK, e = i % BK, k = k0 + e;
        const bool ok = m0 + r < M && k < K;
        cp_async_elem<E>(sa + x * C::A_B + a_off(r, e / V) + e % V * E,
                         ok ? as[x] + (long long)(m0 + r) * K + k : as[x],
                         ok);
      }
  }
  if (vec_b) {
    constexpr int CB = BN * E / 16;              // chunks a raw B row
    constexpr int RB = THREADS / CB;             // raw B rows a pass
    static_assert(THREADS % CB == 0 && BK % RB == 0, "B's passes");
    const int rb = t / CB, n = n0 + t % CB * V;
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int j = 0; j < BK / RB; ++j) {
        const int r = rb + j * RB;
        const bool ok = n < N && k0 + r < K;
        cp_async16(sb + x * C::B_B + r * BN * E + t % CB * 16,
                   ok ? bs[x] + (long long)(k0 + r) * N + n : bs[x], ok);
      }
  } else {
#pragma unroll
    for (int x = 0; x < 3; ++x)
      for (int i = t; i < BK * BN; i += THREADS) {
        const int r = i / BN, e = i % BN, n = n0 + e;
        const bool ok = k0 + r < K && n < N;
        cp_async_elem<E>(sb + x * C::B_B + (r * BN + e) * E,
                         ok ? bs[x] + (long long)(k0 + r) * N + n : bs[x],
                         ok);
      }
  }
  cp_async_arrive(sm + C::BARS + 8 * st);
}

// raw dlt, b_0, b_1 (BK rows of BN elements each) -> the limb tiles of
// dlt, b_0 + dlt (added in the ring before the split) and b_1: a thread
// takes 16 elements of K in one column n of one matrix (conflict-free
// loads along the row) and stores 16 bytes of each limb's row n
template <typename T, int BN>
__device__ __forceinline__ void split_b(char* gsm) {
  using C = Cfg<T, BN>;
  using U = typename C::U;
  constexpr int PER = BN * (C::BK / 16);         // items of one matrix
  static_assert(PER % 32 == 0, "a warp splits one matrix");
  const char* dlt = gsm + C::B0;
  for (int i = threadIdx.x; i < 3 * PER; i += THREADS) {
    const int mat = i / PER, n = i % BN, k = i % PER / BN * 16;
    const char* raw = gsm + C::B0 + mat * C::B_B;
    uint32_t x[C::E / 4][16];        // [32-bit word of an element][element]
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int off = ((k + j) * BN + n) * C::E;
      U v = *reinterpret_cast<const U*>(raw + off);
      if (mat == 1) v += *reinterpret_cast<const U*>(dlt + off);
      x[0][j] = static_cast<uint32_t>(v);
      if constexpr (C::E == 8) x[1][j] = static_cast<uint32_t>(v >> 32);
    }
    limbs::store_limbs<C::L, BN, C::BK, C::L_B>(
        x, gsm + C::LIMB0 + mat * C::L * C::L_B, n, k);
  }
}

// z_p = (first ? c_p : z_p) + sum_s D_s << 8 s for this thread's
// fragment: rows r0, r0 + 8 of the tile, columns 8 j + c2 + [0, 2). A
// row's loads all come before its stores, so that their latencies overlap
// (the compiler may not move a load of c_p past a store to z_p: they may
// alias). `pairs`: rows of c_p and z_p take 2-element loads and stores
template <typename T, int BN>
__device__ __forceinline__ void fold(
    const uint32_t (&acc)[sizeof(T)][BN / 2],
    const typename Cfg<T, BN>::U* c, typename Cfg<T, BN>::U* z, int M,
    int N, int m0, int n0, bool first, bool pairs) {
  using C = Cfg<T, BN>;
  using U = typename C::U;
  using U2 = typename std::conditional<C::E == 4, uint2, ulonglong2>::type;
  const int t = threadIdx.x % WG, lane = t % 32;
  const int r0 = m0 + 16 * (t / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const U* src = (first ? c : z) + (long long)r * N;
    U* row = z + (long long)r * N;
    U o[BN / 8][2];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c2;
      if (pairs && col + 1 < N) {
        const U2 v = *reinterpret_cast<const U2*>(src + col);
        o[j][0] = v.x;
        o[j][1] = v.y;
      } else {
        o[j][0] = col < N ? src[col] : 0;
        o[j][1] = col + 1 < N ? src[col + 1] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c2;
      U v0 = o[j][0], v1 = o[j][1];
#pragma unroll
      for (int s = 0; s < C::L; ++s) {
        v0 += (U)acc[s][4 * j + 2 * h] << (8 * s);
        v1 += (U)acc[s][4 * j + 2 * h + 1] << (8 * s);
      }
      if (pairs && col + 1 < N) {
        U2 out;
        out.x = v0;
        out.y = v1;
        *reinterpret_cast<U2*>(row + col) = out;
      } else {
        if (col < N) row[col] = v0;
        if (col + 1 < N) row[col + 1] = v1;
      }
    }
  }
}

// A persistent block walks its (tile, k-tile) items (limbs::Walker): the
// copies of item g + 1 run under the split and the products of item g,
// across tiles too
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
secure_matmul_kernel(const __grid_constant__ Ptrs p, int batch, int M,
                     int N, int K, int vec_a, int vec_b, int pairs) {
  using C = Cfg<T, BN>;
  using U = typename C::U;
  constexpr int L = C::L, BK = C::BK;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`

  // K = 0 is one zero-filled k-tile, so that z = c is written
  const limbs::Walker walk((M + BM - 1) / BM, (N + BN - 1) / BN,
                           K > 0 ? (K + BK - 1) / BK : 1);
  Walk ld = walk.first();                      // next item to copy
  Walk cu = ld;                                // item computed

  if (threadIdx.x == 0) {
    mbar_init(sm + C::BARS, THREADS);
    mbar_init(sm + C::BARS + 8, THREADS);
    fence_mbar_init();
  }
  __syncthreads();

  const int party = threadIdx.x / WG;
  uint32_t acc[L][BN / 2];
#pragma unroll
  for (int s = 0; s < L; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0;
  uint32_t fe[L][4], fa[L][4];       // A fragments of eps and of a_p

  if (ld.z < batch) {
    copy_item<T, BN>(p, sm, 0, ld, M, N, K, vec_a, vec_b);
    walk.advance(ld);
  }
  for (int g = 0; cu.z < batch; ++g) {
    const int st = g & 1;
    mbar_wait(sm + C::BARS + 8 * st, (g >> 1) & 1);
    // both warpgroups are done with the limb tiles of item g - 1
    __syncthreads();
    split_b<T, BN>(gsm);
    fence_proxy_async();
    // the limb tiles of item g are written, and raw B and the raw A stage
    // of item g - 1 are free: they take item g + 1 while g multiplies
    __syncthreads();
    if (ld.z < batch) {
      copy_item<T, BN>(p, sm, st ^ 1, ld, M, N, K, vec_a, vec_b);
      walk.advance(ld);
    }
    const char* re = gsm + st * 3 * C::A_B;
    const char* rp = re + (1 + party) * C::A_B;
    const uint32_t lt_d = sm + C::LIMB0;                    // dlt's limbs
    const uint32_t lt_b = lt_d + (1 + party) * L * C::L_B;  // b'_p's
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      limbs::split_a<T>(re, ks, fe);
      wgmma_fence();
      limbs::issue<L, BN, BK, C::L_B>(acc, fe, lt_b, ks);
      limbs::split_a<T>(rp, ks, fa);
      wgmma_fence();
      limbs::issue<L, BN, BK, C::L_B>(acc, fa, lt_d, ks);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < L; ++s) fence_regs(acc[s]);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        fence_regs(fe[i]);
        fence_regs(fa[i]);
      }
    }
    // the tile's last k-tile, or a chunk of K ends: fold the diagonals
    // onto c_p (the tile's first fold) or z_p (the others) and start again
    if (cu.kt == walk.nt - 1 || (cu.kt + 1) * BK % C::KCH == 0) {
      const U* c = static_cast<const U*>(party ? p.c1 : p.c0) +
                   cu.z * (party ? p.s_c1 : p.s_c0);
      U* z = static_cast<U*>(party ? p.z1 : p.z0) + (long long)cu.z * M * N;
      fold<T, BN>(acc, c, z, M, N, cu.my * BM, cu.nx * BN,
                  (cu.kt + 1) * BK <= C::KCH, pairs);
#pragma unroll
      for (int s = 0; s < L; ++s)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0;
    }
    walk.advance(cu);
  }
}

// rows of a (batch stride, base) operand start on a 16-byte boundary
bool rows16(const void* q, long long stride, int row, int e) {
  return (long long)row * e % 16 == 0 && stride * e % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T, int BN>
int run(const Ptrs& p, int batch, int M, int N, int K, void* stream) {
  constexpr int bytes = Cfg<T, BN>::BYTES, E = sizeof(T);
  auto kernel = secure_matmul_kernel<T, BN>;
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
  // 16-byte copies where every row of the three operands starts on a
  // 16-byte boundary; 2-element loads of c_p where its rows are aligned
  // to them (z_p's are: N even)
  const int vec_a = rows16(p.eps, p.s_eps, K, E) &&
                    rows16(p.a0, p.s_a0, K, E) && rows16(p.a1, p.s_a1, K, E);
  const int vec_b = rows16(p.dlt, p.s_dlt, N, E) &&
                    rows16(p.b0, p.s_b0, N, E) && rows16(p.b1, p.s_b1, N, E);
  const int pairs = N % 2 == 0 && p.s_c0 % 2 == 0 && p.s_c1 % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(p.c0) % (2 * E) == 0 &&
                    reinterpret_cast<uintptr_t>(p.c1) % (2 * E) == 0;
  kernel<<<(int)(tiles < slots ? tiles : slots), THREADS, bytes,
           static_cast<cudaStream_t>(stream)>>>(p, batch, M, N, K, vec_a,
                                                vec_b, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Ptrs& p, int batch, int M, int N, int K, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 16) return run<T, 16>(p, batch, M, N, K, stream);
  return run<T, sizeof(T) == 4 ? 64 : 32>(p, batch, M, N, K, stream);
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
