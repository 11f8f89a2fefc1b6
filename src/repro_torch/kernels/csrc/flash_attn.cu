// flash_attn: exact online-softmax attention, out = softmax(Q K^T * scale)
// V, for q (BH, Sq, DH) and k, v (BH / group, Skv, DH) — grouped-query
// attention reads kv head bh / group, so K and V are never repeated — on
// Hopper's tensor cores, in bfloat16 and in float32.
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py:flash_attn
// (pallas_call at :69), which walks a sequential grid with the key axis
// innermost and keeps (m, l, acc) in VMEM scratch across grid steps.
// Here a block holds NWG consumer warpgroups (128 threads each; two, or
// one where float32 shared memory forbids: Dh >= 128), each owning 64
// query rows, and loops over the key tiles itself, which all of its
// warpgroups share: the running row max m and sum l and the output
// accumulator stay in registers, and the score matrix never leaves them.
//
// Bound on the H100 (the `work` count of kernels/flash_attn.py):
// - bfloat16: bytes. 4 BH Sq Dh + 4 (BH / group) Skv Dh bytes against
//   4 Dh multiply-add flops a kept (query, key) pair; RecurrentGemma's
//   prefill (40, 512, 256), group 10, causal, reads 23.1 MB (6.9 us at
//   3.35 TB/s) and does 5.4 GFLOP (5.4 us at 989 TFLOP/s).
// - float32: operations. 3xTF32 runs three tf32 products for each float32
//   one, so its peak is 495 / 3 = 165 TFLOP/s; the Oracle's (192, 512, 64)
//   does 12.9 GFLOP (78 us), reads 100.7 MB (30 us). The CUDA cores' 67
//   TFLOP/s, the parent kernel's bound, is 192 us.
// What the design does about it:
// - Both products run as `wgmma` (wgmma_ops.cuh). S = Q K^T reads Q and
//   K from shared memory, K-major, through descriptors (hopper_tile.cuh:
//   swizzled tiles, 128-byte panels). The online softmax works on S's
//   accumulator fragments: a thread holds two rows (r, r + 8) of its
//   warp's 16, and the row max and sum reduce across the 4 lanes that
//   share a row by shuffles. P stays in registers as the A operand of
//   O += P V, in bf16 packed straight from the accumulator layout (the
//   fragments coincide). V is the shared-memory B operand; in bf16 it
//   is MN-major (V's rows run along N = Dh: the transpose bit).
// - float32 (3xTF32): tf32 keeps 10 mantissa bits, about three decimal
//   digits — one pass would miss the 1e-4 float32 gate at scores of ~30.
//   Each operand x splits into hi = tf32(x) and lo = tf32(x - hi), and
//   each product is hi lo + lo hi + hi hi into the float32 accumulator
//   (lo lo, ~2^-22 relative, is dropped). Q, K and V^T are split in
//   shared memory once they land (hi in place, lo beside); P splits in
//   registers. tf32 `wgmma` takes K-major operands only, so V is stored
//   transposed (V^T, 4-byte copies). The tf32 A-register fragment holds
//   columns (c, c + 4) where the accumulator holds (2c, 2c + 1), so V^T's
//   keys are stored permuted within each group of 8 (key 2c at column
//   c, key 2c + 1 at c + 4): the product sums over the same pairs.
// - K and V stream through two buffers each, in a software pipeline of
//   two key tiles: while tile i's softmax runs on the CUDA cores, PV(i -
//   1) runs on the tensor cores; then S(i + 1) and PV(i) are issued
//   together and only S(i + 1) is awaited. K(i + 2) is loaded once S(i)
//   is done, V(i + 2) once PV(i) is done. The copies are `cp.async` (16
//   bytes; 4 bytes for the float32 V^T, which TMA cannot transpose) that
//   complete on one `mbarrier` a buffer (cp.async.mbarrier.arrive.noinc),
//   chosen over TMA because the float32 path transposes V as it loads
//   and a ragged edge is one zero-filling source size, with no tensor
//   map or driver entry point on the host.
// - Tiles wholly masked are skipped: the causal form ends at the tile's
//   diagonal, and a causal `window` w > 0 (the "local" mask of
//   repro/models/common.py: key k attends query q when q - w < k <= q;
//   the port's addition, the Pallas kernel has none) starts at the first
//   tile inside the first row's window. A causal `prefix` P > 0 (the
//   "prefix" mask of the same file, a VLM's image tokens: key k attends
//   query q when k <= q or k < P; not with a window) ends the block's
//   walk at max(its diagonal, P), and a key below P is never masked, so
//   the edge test and the per-key test each gain one comparison and a
//   tile wholly below P takes the unmasked path. A masked score is -inf;
//   a row whose every key so far is masked keeps m = -inf and uses 0 in
//   its place, so its terms are exp2(-inf) = 0, and the diagonal key
//   keeps every causal row non-empty.
// - Rows past the sequence are zero-filled by the copies and masked (keys)
//   or not stored (queries), so a ragged S needs no padding. Accumulation
//   is float32 whatever the input type; the output takes the input's type.
// Tiles: 64 queries a warpgroup x BK keys. bf16: BK = 64 (at Dh 256 O
// is 128 float registers a thread, S 32, P 16: no spill; 192 KB of
// shared memory). float32: BK = 64 at Dh <= 64, 32 at Dh 128, 8 at Dh
// 256, as Q, Q lo and two buffers each of K, V, K lo and V lo fit in 227
// KB (Cfg below); at Dh 64, BK 64 and two warpgroups (192 KB) read
// faster on the H100 than BK 32 or one warpgroup a block.
// Every thread loads, splits and computes, so two block-wide barriers a
// tile order the buffers' reuse (after every warpgroup's PV(i - 1)) and
// the split (before the products). That serial part, not the tensor
// cores, holds the kernel back: the float32 V^T copies, the splits and
// either product each take a share, and no one of them dominates.
// Later work: a warp-specialised TMA producer (the float32 split and
// transpose in its own warps) with ping-pong consumer warpgroups, so that
// one's softmax overlaps the other's products; persistent blocks;
// clusters that share K/V loads across the query tiles of one head.
#include <type_traits>

#include "hopper_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;          // query rows of a warpgroup: one wgmma M
constexpr int WG = 128;         // threads of a warpgroup

template <typename T, int DH>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  static constexpr int BK = !F32 ? 64 : DH <= 64 ? 64 : DH <= 128 ? 32 : 8;
  // consumer warpgroups a block, each with its own 64 query rows, all
  // sharing the K/V tiles (their loads and float32 splits)
  static constexpr int NWG = F32 && DH >= 128 ? 1 : 2;
  static constexpr int THREADS = WG * NWG;
  static constexpr int KS = 32 / E;          // elements a k-step: 32 B
  using QT = Tile<BQ, DH * E>;               // Q (and Q lo): rows queries
  using KT = Tile<BK, DH * E>;               // K: rows keys, K-major
  // V: bf16 rows keys (MN-major), float32 V^T rows Dh (K-major)
  using VT = typename std::conditional<F32, Tile<DH, BK * 4>,
                                       Tile<BK, DH * 2>>::type;
  static constexpr int Q_B = align1024(QT::BYTES);
  static constexpr int K_B = align1024(KT::BYTES);
  static constexpr int V_B = align1024(VT::BYTES);
  // layout: Q x NWG | [Q lo x NWG] | K x 2 | V x 2 | [K lo x 2 | V lo x 2]
  // | mbarriers
  static constexpr int Q_LO = NWG * Q_B;
  static constexpr int K0 = Q_LO * (F32 ? 2 : 1);
  static constexpr int V0 = K0 + 2 * K_B;
  static constexpr int K_LO = V0 + 2 * V_B;              // float32 only
  static constexpr int V_LO = K_LO + 2 * K_B;
  static constexpr int BARS = F32 ? V_LO + 2 * V_B : K_LO;
  static constexpr int BYTES = BARS + 32 + 1024;         // + alignment
  static_assert(BYTES <= 232448, "tile does not fit in shared memory");
};

// K and V stage s's full barriers
__device__ __forceinline__ uint32_t kbar(uint32_t bars, int s) {
  return bars + 8 * s;
}
__device__ __forceinline__ uint32_t vbar(uint32_t bars, int s) {
  return bars + 16 + 8 * s;
}

// the position of key `j` (0..BK) in the float32 V^T row: keys 2c and
// 2c + 1 of each group of 8 at columns c and c + 4 (the A fragment's)
__device__ __forceinline__ int vt_col(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// ROWS rows of DH elements from row r0 of x (nrows rows) into a tile;
// rows past the end are zero-filled
template <typename T, int DH, typename TL, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* x, int r0,
                                          int nrows) {
  constexpr int CH = DH * (int)sizeof(T) / 16;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, cb = (i % CH) * 16;
    const bool ok = r0 + r < nrows;
    const char* src = reinterpret_cast<const char*>(
                          x + (ok ? (long long)(r0 + r) * DH : 0)) + cb;
    cp_async16(dst + TL::offset(r, cb), src, ok);
  }
}

template <typename T, int DH>
__device__ __forceinline__ void load_k(uint32_t sm, const T* kb, int k0,
                                       int skv, int stage) {
  using C = Cfg<T, DH>;
  load_rows<T, DH, typename C::KT, C::BK, C::THREADS>(
      sm + C::K0 + stage * C::K_B, kb, k0, skv);
  cp_async_arrive(kbar(sm + C::BARS, stage));
}

template <typename T, int DH>
__device__ __forceinline__ void load_v(uint32_t sm, const T* vb, int k0,
                                       int skv, int stage) {
  using C = Cfg<T, DH>;
  const uint32_t dst = sm + C::V0 + stage * C::V_B;
  if constexpr (C::F32) {
    for (int i = threadIdx.x; i < C::BK * DH; i += C::THREADS) {
      const int j = i / DH, d = i % DH;
      const bool ok = k0 + j < skv;
      cp_async4(dst + C::VT::offset(d, vt_col(j) * 4),
                vb + (ok ? (long long)(k0 + j) * DH + d : 0), ok);
    }
  } else {
    load_rows<T, DH, typename C::VT, C::BK, C::THREADS>(dst, vb, k0, skv);
  }
  cp_async_arrive(vbar(sm + C::BARS, stage));
}

// float32: x -> hi = tf32(x) in place, lo = tf32(x - hi) at `lo`
template <int THREADS>
__device__ __forceinline__ void split_tf32(char* buf, char* lo, int bytes) {
  float4* h = reinterpret_cast<float4*>(buf);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) {
    const float4 x = h[i];
    const float4 y = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    h[i] = y;
    l[i] = make_float4(tf32(x.x - y.x), tf32(x.y - y.y), tf32(x.z - y.z),
                       tf32(x.w - y.w));
  }
}

// S = Q K^T for K stage `st` (K-major both; N = BK keys); float32 adds
// Q lo K hi and Q hi K lo before Q hi K hi
template <typename T, int DH>
__device__ __forceinline__ void issue_s(float (&s)[Cfg<T, DH>::BK / 2],
                                        uint32_t sm, int st, int wg) {
  using C = Cfg<T, DH>;
  constexpr int WQ = C::QT::W, WK = C::KT::W;
  const uint32_t ks = sm + C::K0 + st * C::K_B;
#pragma unroll
  for (int kk = 0; kk < DH / C::KS; ++kk) {
    const int cb = kk * 32;
    const uint64_t dq = desc(sm + wg * C::Q_B + C::QT::start(0, cb), 16,
                             8 * WQ, WQ);
    const uint64_t dk = desc(ks + C::KT::start(0, cb), 16, 8 * WK, WK);
    if constexpr (C::F32) {
      const uint64_t dql = desc(sm + C::Q_LO + wg * C::Q_B +
                                C::QT::start(0, cb), 16, 8 * WQ, WQ);
      const uint64_t dkl = desc(sm + C::K_LO + st * C::K_B +
                                C::KT::start(0, cb), 16, 8 * WK, WK);
      Wgmma<C::BK>::ss_tf32(s, dql, dk, kk > 0);
      Wgmma<C::BK>::ss_tf32(s, dq, dkl, 1);
      Wgmma<C::BK>::ss_tf32(s, dq, dk, 1);
    } else {
      Wgmma<C::BK>::ss_bf16(s, dq, dk, kk > 0);
    }
  }
}

// P as wgmma A fragments: bf16 hi only (a k-step of 16 keys is n-blocks
// 2t, 2t + 1, whose accumulator pairs are the fragment's); float32 hi
// and lo (a k-step of 8 keys is n-block t: columns 2c, 2c + 1 stand for
// the fragment's c, c + 4, as V^T is stored)
template <typename T, int DH>
struct PFrag {
  static constexpr int BK = Cfg<T, DH>::BK;
  static constexpr int NT = Cfg<T, DH>::F32 ? BK / 8 : BK / 16;
  uint32_t hi[NT][4];
  uint32_t lo[Cfg<T, DH>::F32 ? NT : 1][4];

  __device__ __forceinline__ void pack(const float (&p)[BK / 2]) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (Cfg<T, DH>::F32) {
          const float x = p[4 * t + (i >> 1) + 2 * (i & 1)], h = tf32(x);
          hi[t][i] = __float_as_uint(h);
          lo[t][i] = __float_as_uint(tf32(x - h));
        } else {
          hi[t][i] = pack_bf16(p[8 * t + 2 * i], p[8 * t + 2 * i + 1]);
        }
      }
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_regs(hi[t]);
    if constexpr (Cfg<T, DH>::F32) {
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_regs(lo[t]);
    }
  }
};

// O += P V for V stage `st`
template <typename T, int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[DH / 2],
                                         PFrag<T, DH>& pf, uint32_t sm,
                                         int st) {
  using C = Cfg<T, DH>;
  constexpr int WV = C::VT::W;
  const uint32_t vs = sm + C::V0 + st * C::V_B;
#pragma unroll
  for (int t = 0; t < PFrag<T, DH>::NT; ++t) {
    if constexpr (C::F32) {
      const int cb = t * 32;
      const uint64_t dv = desc(vs + C::VT::start(0, cb), 16, 8 * WV, WV);
      const uint64_t dvl = desc(sm + C::V_LO + st * C::V_B +
                                C::VT::start(0, cb), 16, 8 * WV, WV);
      Wgmma<DH>::rs_tf32(acc, pf.lo[t], dv, 1);
      Wgmma<DH>::rs_tf32(acc, pf.hi[t], dvl, 1);
      Wgmma<DH>::rs_tf32(acc, pf.hi[t], dv, 1);
    } else {
      Wgmma<DH>::rs_bf16_bmn(
          acc, pf.hi[t],
          desc(vs + C::VT::start(16 * t, 0), C::VT::PANEL, 8 * WV, WV), 1);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::THREADS, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int nbh,
                  int nq, int group, int sq, int skv, int causal,
                  int window, int prefix, float scale_log2) {
  using C = Cfg<T, DH>;
  constexpr int BK = C::BK;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  const uint32_t bars = sm + C::BARS;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`

  // heaviest (last) query tiles first, heads innermost; warpgroup `wg`
  // owns rows [qw, qw + 64) of the block's [q0, q0 + 64 NWG)
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - blockIdx.x / nbh) * BQ * C::NWG;
  const T* kb = k + (long long)(bh / group) * skv * DH;
  const T* vb = v + (long long)(bh / group) * skv * DH;
  const int wg = threadIdx.x / WG, qw = q0 + BQ * wg;
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4;     // and row0 + 8
  const int c2 = 2 * (lane % 4);             // and c2 + 1, in each 8

  // causal ends at the block's last row, or past it at the prefix
  const int kend = causal ? min(skv, max(q0 + BQ * C::NWG, prefix)) : skv;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(kbar(bars, s), C::THREADS);
      mbar_init(vbar(bars, s), C::THREADS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // no key, no tile: the output is 0
  if (nt > 0) {
    // Q joins K(0)'s barrier; K(j + 2) and V(j + 1) are loaded in tile
    // j's step, once every warpgroup is done with the buffer
    for (int w = 0; w < C::NWG; ++w)
      load_rows<T, DH, typename C::QT, BQ, C::THREADS>(
          sm + w * C::Q_B, q + (long long)bh * sq * DH, q0 + BQ * w, sq);
    load_k<T, DH>(sm, kb, kbeg, skv, 0);
    load_v<T, DH>(sm, vb, kbeg, skv, 0);
    if (nt > 1) {
      load_k<T, DH>(sm, kb, kbeg + BK, skv, 1);
      load_v<T, DH>(sm, vb, kbeg + BK, skv, 1);
    }
    mbar_wait(kbar(bars, 0), 0);
    if constexpr (C::F32) {
      split_tf32<C::THREADS>(gsm, gsm + C::Q_LO, C::NWG * C::Q_B);
      split_tf32<C::THREADS>(gsm + C::K0, gsm + C::K_LO, C::KT::BYTES);
    }
    fence_proxy_async();
    __syncthreads();
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    issue_s<T, DH>(s, sm, 0, wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    PFrag<T, DH> pf;
    pf.pack(s);                      // defined values for the first fence
    // Tile `it`: its softmax overlaps PV(it - 1) on the tensor cores;
    // then S(it + 1) and PV(it) are issued together and only S(it + 1)
    // is awaited. The last tile (MORE false) issues no S: it is a
    // separate instantiation, so that no wgmma or wait sits under a
    // branch (ptxas serializes every wgmma of a kernel whose pipeline
    // it cannot follow).
    auto step = [&](const int it, auto more) {
      constexpr bool MORE = decltype(more)::value;
      const int k0 = kbeg + it * BK, st = it & 1;

      // mask, then the online softmax on the fragments: s[4j + e] is row
      // row0 + 8 (e / 2), key k0 + 8 j + c2 + e % 2
      const bool edge = k0 + BK > skv ||
                        (causal && k0 + BK - 1 > qw && k0 + BK > prefix) ||
                        (window > 0 && k0 <= qw + BQ - 1 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + c2 + (e & 1);
            const int query = qw + row0 + 8 * (e >> 1);
            if (key >= skv || (causal && key > query && key >= prefix) ||
                (window > 0 && key <= query - window))
              s[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e] * scale_log2;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        mu[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - mu[h]);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - mu[e >> 1]);
          s[4 * j + e] = p;
          l[e >> 1] += p;
        }

      // PV(it - 1) is done: acc and P are free. K(it + 1) and V(it)
      // landed; float32 splits them (their lo buffers' last readers, S(it
      // - 1) and PV(it - 2), finished before the last step's barrier)
      wgmma_wait<0>();
      fence_regs(acc);
      pf.fence();
      if constexpr (MORE) {
        mbar_wait(kbar(bars, st ^ 1), ((it + 1) >> 1) & 1);
        if constexpr (C::F32)
          split_tf32<C::THREADS>(gsm + C::K0 + (st ^ 1) * C::K_B,
                                 gsm + C::K_LO + (st ^ 1) * C::K_B,
                                 C::KT::BYTES);
      }
      mbar_wait(vbar(bars, st), (it >> 1) & 1);
      if constexpr (C::F32)
        split_tf32<C::THREADS>(gsm + C::V0 + st * C::V_B,
                               gsm + C::V_LO + st * C::V_B, C::VT::BYTES);
      fence_proxy_async();
      __syncthreads();

      pf.pack(s);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

      wgmma_fence();
      if constexpr (MORE) {
        issue_s<T, DH>(s, sm, st ^ 1, wg);
        wgmma_commit();
      }
      issue_pv<T, DH>(acc, pf, sm, st);
      wgmma_commit();
      // past the barrier every warpgroup is done with S(it) and PV(it - 1):
      // K(it)'s buffer takes K(it + 2), V(it - 1)'s V(it + 1), while the
      // tensor cores run
      if (it + 2 < nt) load_k<T, DH>(sm, kb, k0 + 2 * BK, skv, st);
      if (MORE && it >= 1) load_v<T, DH>(sm, vb, k0 + BK, skv, st ^ 1);
      if constexpr (MORE) {
        wgmma_wait<1>();             // S(it + 1); PV(it) runs on
        fence_regs(s);
      }
    };
    for (int it = 0; it + 1 < nt; ++it) step(it, std::true_type{});
    step(nt - 1, std::false_type{});
    wgmma_wait<0>();
    fence_regs(acc);
    pf.fence();
  }

  // epilogue: the row sums across the 4 lanes of a row, then O / l,
  // staged through this warpgroup's Q tile (no product reads it now) so
  // that each thread stores whole 16-byte chunks of a row; the staging
  // swizzles chunks by row, which keeps both sides free of bank conflicts
  constexpr int RB = DH * C::E, CH = RB / 16, SW = (CH < 8 ? CH : 8) - 1;
  char* const ot = gsm + wg * C::Q_B;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    const int r = row0 + 8 * h;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int cb = (8 * j + c2) * C::E;
      store2(reinterpret_cast<T*>(ot + r * RB + (((cb >> 4) ^ (r & SW)) << 4)
                                  + (cb & 15)),
             acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
  named_barrier_sync(1 + wg, WG);
  char* const ob = reinterpret_cast<char*>(o + (long long)bh * sq * DH);
  for (int i = threadIdx.x % WG; i < BQ * CH; i += WG) {
    const int r = i / CH, c = i % CH;
    if (qw + r < sq)
      *reinterpret_cast<int4*>(ob + (long long)(qw + r) * RB + c * 16) =
          *reinterpret_cast<const int4*>(ot + r * RB + ((c ^ (r & SW)) << 4));
  }
}

template <typename T, int DH>
int run(const void* q, const void* k, const void* v, void* o, int bh,
        int group, int sq, int skv, int causal, int window, int prefix,
        float scale, void* stream) {
  constexpr int bytes = Cfg<T, DH>::BYTES;
  auto kernel = flash_attn_kernel<T, DH>;
  static const int smem_err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (smem_err) return smem_err;
  constexpr int rows = BQ * Cfg<T, DH>::NWG;
  const int nq = (sq + rows - 1) / rows;
  kernel<<<nq * bh, Cfg<T, DH>::THREADS, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, nq, group, sq, skv,
      causal, window, prefix, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int skv, int dh, int causal, int window,
           int prefix, float scale, void* stream) {
  if ((window > 0 && !causal) || prefix < 0 ||
      (prefix > 0 && (!causal || window > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16:
      return run<T, 16>(q, k, v, o, bh, group, sq, skv, causal, window,
                        prefix, scale, stream);
    case 32:
      return run<T, 32>(q, k, v, o, bh, group, sq, skv, causal, window,
                        prefix, scale, stream);
    case 64:
      return run<T, 64>(q, k, v, o, bh, group, sq, skv, causal, window,
                        prefix, scale, stream);
    case 128:
      return run<T, 128>(q, k, v, o, bh, group, sq, skv, causal, window,
                         prefix, scale, stream);
    case 256:
      return run<T, 256>(q, k, v, o, bh, group, sq, skv, causal, window,
                         prefix, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int bh, int group, int sq, int skv,
                              int dh, int causal, int window, int prefix,
                              float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, group, sq, skv, dh, causal, window,
                       prefix, scale, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int bh, int group, int sq, int skv,
                               int dh, int causal, int window, int prefix,
                               float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, group, sq, skv, dh, causal,
                               window, prefix, scale, stream);
}
