// ssd: the Mamba-2 chunked state-space scan (state-space duality) on
// Hopper's tensor cores, in bfloat16 and in float32. For one (batch,
// head), over chunks of q <= 128 steps, with cum the running sum of the
// log decays a inside the chunk:
//   intra-chunk   y_d[i] = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) x_j
//   state read    y_o[i] = exp(cum_i) (c_i S^T)
//   state update  S <- S exp(cum_last) + sum_j exp(cum_last - cum_j) x_j b_j^T
// and y = y_d + y_o. Inputs in the model's layout: x (B, T, H, P), a (B, T,
// H) float32, b and c (B, T, N) shared by the heads; S (P, N) float32.
// Outputs y (B, T, H, P) in x's type and the final state (B, H, P, N)
// float32; an optional initial state (B, H, P, N) seeds S.
//
// Replaces the Pallas kernel repro/kernels/ssd.py:ssd_chunked (pallas_call
// at :63). On the TPU the grid (B, H, nc) walks the chunks in order and
// the (P, N) state sits in VMEM across them. Here a block walks the
// sequence itself and keeps the state in its registers; the TPU kernel
// returns only y, this one also writes S at the end, which prefill keeps
// as the decode cache.
//
// Bound on the H100 (`work` in kernels/ssd.py): bytes. Mamba-2's prefill
// batch, x (4, 512, 80, 64) bf16 and b/c (4, 512, 128), moves 54.1 MB
// (16.2 us at 3.35 TB/s) for 4.7 G multiply-adds (9.5 us at 989 TFLOP/s);
// float32 (3xTF32, 495 / 3 TFLOP/s) is bound by its operations. What the
// design does about it:
// - All four products are `wgmma` (wgmma_ops.cuh) on swizzled shared
//   tiles (hopper_tile.cuh). A block is one warpgroup and a tile is 64
//   steps, one wgmma M: the scores G = C B^T (A = C, B = B, both K-major
//   over N as they arrive), the state read C S^T (B = S, K-major over N),
//   the intra-chunk y_d = P X (P, the decayed scores, from the score
//   accumulator's registers; X MN-major, its rows along P as V's in
//   flash_attn) and the state update S^T += B^T dX (A = B's tile read
//   MN-major, B = the decayed X MN-major: ss_bf16_tt).
// - The state stays in float32 accumulator registers across the tiles
//   (as S^T: rows N in two M tiles, columns this block's P slice), so
//   it is never rounded where it carries over. Rounding is spent only
//   where the result reaches y alone: the decayed scores and the copy of
//   S that the state read takes are bf16. The decayed X of the update,
//   which reaches the state, is split hi + lo in bf16 and both products
//   are taken (~16 bits a term; one bf16 product misses the state's 1e-5).
//   tests/test_torch_ssd_tiles.py holds this arithmetic against the plain
//   scan on the CPU.
// - float32: 3xTF32 as in flash_attn: each operand x is hi = tf32(x) and
//   lo = tf32(x - hi), a product is lo hi + hi lo + hi hi. tf32 takes
//   K-major operands only: X is loaded transposed (X^T, 4-byte copies,
//   keys permuted within each group of 8 to match the A fragment that
//   the score accumulator gives, as flash_attn's V^T), the decayed X as
//   dX^T, and the update's A = B^T comes from B's tiles into registers.
// - Filling the card: the block owns one (batch, head) and one slice of
//   PB = 32 head-dim columns; the scores are recomputed for each slice
//   (cheap on the tensor cores), and the slices need no sync. Mamba-2's
//   320 (batch, head) pairs become 640 blocks. A tile's steps run in
//   turn, so what hides their latency is other blocks: bf16 keeps three
//   a SM (58 KB of shared memory, at most 168 registers). For that the
//   state read is issued after the mask, never beside the scores'
//   accumulator, and a block keeps one stage of tiles: the next tile
//   loads while y leaves. Blocks run in (batch, head, slice) order, so a
//   batch's heads run together and L2 serves b and c, which they share.
// - Bytes the card's way: C, B and X rows arrive by 16-byte `cp.async`
//   into the swizzled tiles, completing on an `mbarrier`; y leaves
//   through a staging tile as 16-byte stores. Rows past the sequence,
//   columns past P and N, are zero-filled, so a ragged T, P < 32 or N <
//   128 runs the same products; widths whose rows are not whole 16-byte
//   chunks load and store element by element.
// - The chunk: the scan is the same function for every chunk length, so
//   the kernel walks it in steps of min(q, 64), the wgmma's M.
// What holds it back: a tile's steps (the load, the cum scan, the copy of
// S, the products, the mask, the epilogue) run in turn behind four
// barriers and three waits, and three blocks a SM hide only part of
// that; no one product dominates. Later work: a warp-specialised TMA
// producer and a second warpgroup that carries the state chain beside
// the scores, persistent blocks, and clusters multicasting b and c to
// the heads of one batch.
#include <type_traits>

#include "hopper_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;

constexpr int QT = 64;          // steps a tile: one wgmma M
constexpr int QMAX = 128;       // largest chunk
constexpr int NMAX = 128;       // largest state width: the K of C B^T
constexpr int PMAX = 64;        // largest head dim
constexpr int THREADS = 128;    // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  static constexpr int KS = 32 / E;             // elements a k-step: 32 B
  static constexpr int PB = 32;                 // head-dim columns a block
  using CT = Tile<QT, NMAX * E>;                // C and B: rows steps
  // bf16 X and dX: rows steps, P contiguous (MN-major); float32 X^T and
  // dX^T: rows P, steps contiguous (K-major)
  using XT = typename std::conditional<F32, Tile<PB, QT * 4>,
                                       Tile<QT, PB * 2>>::type;
  using ST = Tile<PB, NMAX * E>;                // S of the state read
  static constexpr int C_B = align1024(CT::BYTES);
  static constexpr int X_B = align1024(XT::BYTES);
  static constexpr int S_B = align1024(ST::BYTES);
  static constexpr int RB = PB * E;             // bytes of a y row
  // layout: C | B | X, [float32: their lo], dX hi | dX lo, S (hi) |
  // [S lo], y staging, a, cum, exp(cum), exp(last - cum), last, the
  // mbarrier
  static constexpr int X0 = 2 * C_B;
  static constexpr int LO = X0 + X_B;
  static constexpr int DXH = LO + (F32 ? LO : 0);
  static constexpr int DXL = DXH + X_B;
  static constexpr int SH = DXL + X_B;
  static constexpr int SL = SH + S_B;
  static constexpr int YS = SL + (F32 ? S_B : 0);
  static constexpr int AR = YS + align1024(QT * RB);
  static constexpr int CUM = AR + QT * 4;
  static constexpr int ECUM = CUM + QT * 4;
  static constexpr int DEC = ECUM + QT * 4;
  static constexpr int LAST = DEC + QT * 4;
  static constexpr int BARS = LAST + 16;
  static constexpr int BYTES = BARS + 8 + 1024;   // + alignment
  static_assert(BYTES <= 232448, "tiles do not fit in shared memory");
};

// the position of key `j` in a float32 X^T row: keys 2c and 2c + 1 of
// each group of 8 at columns c and c + 4 (the tf32 A fragment's)
__device__ __forceinline__ int xt_col(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// raw bits of an element: zero-filling needs no arithmetic on T
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                       unsigned int>::type;

// QT rows of ROW elements (row r at src + r * stride) into tile TL; rows
// >= `rows` and elements >= `width` are zero. 16-byte cp.async where the
// rows are whole 16-byte chunks (`vec`), else element by element
template <typename T, typename TL, int ROW>
__device__ __forceinline__ void load_rows(uint32_t dst, char* gdst,
                                          const T* src, long long stride,
                                          int rows, int width, bool vec) {
  if (vec) {
    constexpr int CH = ROW * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < QT * CH; i += THREADS) {
      const int r = i / CH, cb = (i % CH) * 16;
      const bool ok = r < rows && cb < width * (int)sizeof(T);
      const char* s = reinterpret_cast<const char*>(
                          ok ? src + r * stride : src) + (ok ? cb : 0);
      cp_async16(dst + TL::offset(r, cb), s, ok);
    }
  } else {
    const Bits<T>* s = reinterpret_cast<const Bits<T>*>(src);
    for (int i = threadIdx.x; i < QT * ROW; i += THREADS) {
      const int r = i / ROW, e = i % ROW;
      *reinterpret_cast<Bits<T>*>(gdst + TL::offset(r, e * sizeof(T))) =
          r < rows && e < width ? s[r * stride + e] : Bits<T>(0);
    }
  }
}

struct Geo {              // where a block reads and writes
  int nh, t_len, p_dim, n_dim, h, p0, pw;   // pw: valid columns of the slice
  long long bi;
  bool vec_x, vec_bc;
};

// the tile of `rows` steps from t0: C, B, X (float32: X^T) and a, all
// arriving on the mbarrier
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t sm, char* gsm,
                                          const T* x, const float* a,
                                          const T* b, const T* c,
                                          const Geo& g, int t0, int rows) {
  using C = Cfg<T>;
  constexpr int PB = C::PB;
  const long long row0 = g.bi * g.t_len + t0;          // (b, t0)
  load_rows<T, typename C::CT, NMAX>(sm, gsm, c + row0 * g.n_dim, g.n_dim,
                                     rows, g.n_dim, g.vec_bc);
  load_rows<T, typename C::CT, NMAX>(sm + C::C_B, gsm + C::C_B,
                                     b + row0 * g.n_dim, g.n_dim, rows,
                                     g.n_dim, g.vec_bc);
  const T* xs = x + (row0 * g.nh + g.h) * g.p_dim + g.p0;
  const long long xstride = (long long)g.nh * g.p_dim;
  if constexpr (C::F32) {
    for (int i = threadIdx.x; i < QT * PB; i += THREADS) {
      const int j = i / PB, p = i % PB;
      const bool ok = j < rows && p < g.pw;
      cp_async4(sm + C::X0 + C::XT::offset(p, xt_col(j) * 4),
                ok ? xs + j * xstride + p : x, ok);
    }
  } else {
    load_rows<T, typename C::XT, PB>(sm + C::X0, gsm + C::X0, xs, xstride,
                                     rows, g.pw, g.vec_x);
  }
  if (threadIdx.x < QT) {
    const bool ok = (int)threadIdx.x < rows;
    cp_async4(sm + C::AR + threadIdx.x * 4,
              ok ? a + (row0 + threadIdx.x) * g.nh + g.h : a, ok);
  }
  cp_async_arrive(sm + C::BARS);
}

// float32: x -> hi = tf32(x) in place, lo = tf32(x - hi) at `lo`
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

// the descriptor `d` moved `bytes` further on: its start address is the
// low 14 bits, in 16-byte units, and shared memory ends below 2^18 bytes
__device__ __forceinline__ uint64_t at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// P, the decayed scores, as wgmma A fragments: bf16 hi only (a k-step
// of 16 keys is n-blocks 2t, 2t + 1, whose accumulator pairs are the
// fragment's); float32 hi and lo (a k-step of 8 keys is n-block t:
// columns 2c, 2c + 1 stand for the fragment's c, c + 4, as X^T is stored)
template <bool F32>
struct PFrag {
  static constexpr int NT = F32 ? QT / 8 : QT / 16;
  uint32_t hi[NT][4];
  uint32_t lo[F32 ? NT : 1][4];

  __device__ __forceinline__ void pack(const float (&p)[QT / 2]) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (F32) {
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
    if constexpr (F32) {
#pragma unroll
      for (int t = 0; t < NT; ++t) fence_regs(lo[t]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, Cfg<T>::F32 ? 1 : 3)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ b, const T* __restrict__ c,
           const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ s_out, int nh, int t_len, int qe, int p_dim,
           int n_dim, int nps, int vec_x, int vec_bc) {
  using C = Cfg<T>;
  constexpr int PB = C::PB;
  using CT = typename C::CT;
  using XT = typename C::XT;
  using ST = typename C::ST;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`
  const float* cum = reinterpret_cast<const float*>(gsm + C::CUM);
  const float* ecum = reinterpret_cast<const float*>(gsm + C::ECUM);
  const float* dec = reinterpret_cast<const float*>(gsm + C::DEC);

  // blocks in (batch, head, slice) order
  const int ps = blockIdx.x % nps, bh = blockIdx.x / nps;
  Geo g;
  g.nh = nh;
  g.t_len = t_len;
  g.p_dim = p_dim;
  g.n_dim = n_dim;
  g.h = bh % nh;
  g.bi = bh / nh;
  g.p0 = ps * PB;
  g.pw = min(PB, p_dim - g.p0);
  g.vec_x = vec_x;
  g.vec_bc = vec_bc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;       // accumulator rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);             // and columns c2, c2 + 1 of 8
  const int nt = (t_len + qe - 1) / qe;

  if (threadIdx.x == 0) {
    mbar_init(sm + C::BARS, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  if (nt > 0) load_tile<T>(sm, gsm, x, a, b, c, g, 0, min(qe, t_len));

  // S^T: rows n = 64 w + r0 (+ 8), columns p (this slice's), float32
  float sacc[2][PB / 2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int j = 0; j < PB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
        sacc[w][4 * j + e] =
            s0 != nullptr && n < n_dim && p < g.pw
                ? s0[((long long)bh * p_dim + g.p0 + p) * n_dim + n]
                : 0.f;
      }

  const uint32_t cs = sm, bs = sm + C::C_B, xs = sm + C::X0;  // C, B, X
  for (int it = 0; it < nt; ++it) {
    const int t0 = it * qe, rows = min(qe, t_len - t0);
    mbar_wait(sm + C::BARS, it & 1);

    // cum over the tile (rows past its end add 0): warp 0, two a lane
    if (warp == 0) {
      const float* ar = reinterpret_cast<const float*>(gsm + C::AR);
      const float a0 = ar[2 * lane], a1 = ar[2 * lane + 1];
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      // in log2 units, so that every decay is one exp2f
      const float k0 = (excl + a0) * LOG2E, k1 = (excl + a0 + a1) * LOG2E;
      const float last = __shfl_sync(0xffffffffu, (rows - 1) & 1 ? k1 : k0,
                                     (rows - 1) >> 1);
      float* cw = reinterpret_cast<float*>(gsm + C::CUM);
      float* ew = reinterpret_cast<float*>(gsm + C::ECUM);
      float* dw = reinterpret_cast<float*>(gsm + C::DEC);
      cw[2 * lane] = k0;
      cw[2 * lane + 1] = k1;
      ew[2 * lane] = exp2f(k0);
      ew[2 * lane + 1] = exp2f(k1);
      dw[2 * lane] = exp2f(last - k0);
      dw[2 * lane + 1] = exp2f(last - k1);
      if (lane == 0) *reinterpret_cast<float*>(gsm + C::LAST) = exp2f(last);
    }
    // the state read's copy of S (rows p, K-major over n): bf16, or tf32
    // hi and lo
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int j = 0; j < PB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
          const float v = sacc[w][4 * j + e];
          if constexpr (C::F32) {
            const float hi = tf32(v);
            *reinterpret_cast<float*>(gsm + C::SH + ST::offset(p, n * 4)) =
                hi;
            *reinterpret_cast<float*>(gsm + C::SL + ST::offset(p, n * 4)) =
                tf32(v - hi);
          } else {
            *reinterpret_cast<unsigned short*>(
                gsm + C::SH + ST::offset(p, n * 2)) = bf16_bits(v);
          }
        }
    if constexpr (C::F32) {
      split_tf32(gsm, gsm + C::LO, 2 * C::C_B);
    }
    __syncthreads();                         // cum, exp(cum), decays

    // the decayed X of the update, split hi + lo: bf16 dX beside X;
    // float32 dX^T (keys in order) from the raw X^T, which is split too
    if constexpr (C::F32) {
      char* const xg = gsm + C::X0;
      for (int i = threadIdx.x; i < PB * QT; i += THREADS) {
        const int p = i / QT, j = i % QT;
        float* src = reinterpret_cast<float*>(xg + XT::offset(p,
                                                              xt_col(j) * 4));
        const float v = *src, dv = v * dec[j];
        const float vh = tf32(v), dh = tf32(dv);
        *src = vh;
        *reinterpret_cast<float*>(gsm + C::LO + C::X0 +
                                  XT::offset(p, xt_col(j) * 4)) = tf32(v - vh);
        *reinterpret_cast<float*>(gsm + C::DXH + XT::offset(p, j * 4)) = dh;
        *reinterpret_cast<float*>(gsm + C::DXL + XT::offset(p, j * 4)) =
            tf32(dv - dh);
      }
    } else {
      constexpr int CH = PB * 2 / 16;
      for (int i = threadIdx.x; i < QT * CH; i += THREADS) {
        const int r = i / CH, off = XT::offset(r, (i % CH) * 16);
        const uint4 v = *reinterpret_cast<const uint4*>(gsm + C::X0 + off);
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v);
        const float d = dec[r];
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&vw[k]));
          const float x0 = f.x * d, x1 = f.y * d;
          const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hb);
          hw[k] = *reinterpret_cast<const uint32_t*>(&hb);
          lw[k] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }
        *reinterpret_cast<uint4*>(gsm + C::DXH + off) =
            make_uint4(hw[0], hw[1], hw[2], hw[3]);
        *reinterpret_cast<uint4*>(gsm + C::DXL + off) =
            make_uint4(lw[0], lw[1], lw[2], lw[3]);
      }
    }
    const float decay = *reinterpret_cast<const float*>(gsm + C::LAST);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int i = 0; i < PB / 2; ++i) sacc[w][i] *= decay;
    fence_proxy_async();
    __syncthreads();                         // every operand is in place

    // G = C B^T (N = 64 keys, K = n); bf16 also issues the update S^T +=
    // B^T dX (hi, then lo) behind it
    float gacc[QT / 2];
    constexpr int WC = CT::W, WS = ST::W, WX = XT::W;
    // descriptors at the tiles' starts: K-major (C, B, S; float32 X^T
    // and dX^T) and MN-major (B read as B^T, bf16 X and dX)
    const uint64_t kc = desc(cs, 16, 8 * WC, WC);
    const uint64_t kb = desc(bs, 16, 8 * WC, WC);
    // float32's lo tiles lie LO further on
    constexpr uint32_t LO = C::F32 ? C::LO : 0, SLO = C::SL - C::SH;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NMAX / C::KS; ++kk) {
      const uint64_t dc = at(kc, CT::start(0, kk * 32));
      const uint64_t db = at(kb, CT::start(0, kk * 32));
      if constexpr (C::F32) {
        Wgmma<QT>::ss_tf32(gacc, at(dc, LO), db, kk > 0);
        Wgmma<QT>::ss_tf32(gacc, dc, at(db, LO), 1);
        Wgmma<QT>::ss_tf32(gacc, dc, db, 1);
      } else {
        Wgmma<QT>::ss_bf16(gacc, dc, db, kk > 0);
      }
    }
    wgmma_commit();
    if constexpr (!C::F32) {
      const uint64_t mb = desc(bs, CT::PANEL, 8 * WC, WC);
      const uint64_t mdh = desc(sm + C::DXH, XT::PANEL, 8 * WX, WX);
      const uint64_t mdl = desc(sm + C::DXL, XT::PANEL, 8 * WX, WX);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int t = 0; t < QT / 16; ++t) {
          // A = B^T: B's tile read MN-major (M = n: panel w; K = 16 steps)
          const uint64_t da = at(mb, CT::start(16 * t, 128 * w));
          Wgmma<PB>::ss_bf16_tt(sacc[w], da, at(mdh, XT::start(16 * t, 0)),
                                1);
          Wgmma<PB>::ss_bf16_tt(sacc[w], da, at(mdl, XT::start(16 * t, 0)),
                                1);
        }
      wgmma_commit();
      wgmma_wait<1>();                       // G; the update runs on
    } else {
      wgmma_wait<0>();
    }
    fence_regs(gacc);

    // causal mask and decay on the score fragments: gacc[4 j + e] is
    // query r0 + 8 (e / 2), key 8 j + c2 + e % 2
    {
      const float ci[2] = {cum[r0], cum[r0 + 8]};
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        const float2 ck = *reinterpret_cast<const float2*>(cum + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = r0 + 8 * (e >> 1), k = 8 * j + c2 + (e & 1);
          const float v = gacc[4 * j + e] *
                          exp2f(ci[e >> 1] - ((e & 1) ? ck.y : ck.x));
          gacc[4 * j + e] = k <= q ? v : 0.f;
        }
      }
    }
    PFrag<C::F32> pf;
    pf.pack(gacc);

    // y = exp(cum_i) (C S^T) + P X (N = PB). The state read is issued only
    // now, so that its accumulator is never live beside the scores': that
    // keeps bf16 within 168 registers, three blocks a SM
    float yacc[PB / 2];
    const uint64_t ks = desc(sm + C::SH, 16, 8 * WS, WS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NMAX / C::KS; ++kk) {
      const uint64_t dc = at(kc, CT::start(0, kk * 32));
      const uint64_t ds = at(ks, ST::start(0, kk * 32));
      if constexpr (C::F32) {
        Wgmma<PB>::ss_tf32(yacc, at(dc, LO), ds, kk > 0);
        Wgmma<PB>::ss_tf32(yacc, dc, at(ds, SLO), 1);
        Wgmma<PB>::ss_tf32(yacc, dc, ds, 1);
      } else {
        Wgmma<PB>::ss_bf16(yacc, dc, ds, kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();                         // y_o, and bf16's update
    fence_regs(yacc);
    fence_regs(sacc[0]);
    fence_regs(sacc[1]);
    {
      const float ei[2] = {ecum[r0], ecum[r0 + 8]};
#pragma unroll
      for (int j = 0; j < PB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[4 * j + e] *= ei[e >> 1];
    }
    wgmma_fence();
    if constexpr (C::F32) {
      const uint64_t kx = desc(xs, 16, 8 * WX, WX);
#pragma unroll
      for (int t = 0; t < QT / 8; ++t) {
        const uint64_t dx = at(kx, XT::start(0, 32 * t));
        Wgmma<PB>::rs_tf32(yacc, pf.lo[t], dx, 1);
        Wgmma<PB>::rs_tf32(yacc, pf.hi[t], at(dx, LO), 1);
        Wgmma<PB>::rs_tf32(yacc, pf.hi[t], dx, 1);
      }
    } else {
      const uint64_t mx = desc(xs, XT::PANEL, 8 * WX, WX);
#pragma unroll
      for (int t = 0; t < QT / 16; ++t)
        Wgmma<PB>::rs_bf16_bmn(yacc, pf.hi[t], at(mx, XT::start(16 * t, 0)),
                               1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
    pf.fence();

    if constexpr (C::F32) {
      const uint64_t kdh = desc(sm + C::DXH, 16, 8 * WX, WX);
      const uint64_t kdl = desc(sm + C::DXL, 16, 8 * WX, WX);
      // S^T += B^T dX^T: A = B^T from B's hi and lo tiles into tf32
      // fragments (row n, column key: (r0, c), (r0 + 8, c), (r0, c + 4),
      // (r0 + 8, c + 4)), one M tile of 64 n at a time
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        uint32_t ah[QT / 8][4], al[QT / 8][4];
#pragma unroll
        for (int t = 0; t < QT / 8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = 8 * t + c2 / 2 + 4 * (i >> 1);
            const int n = 64 * w + r0 + 8 * (i & 1);
            const int off = C::C_B + CT::offset(key, n * 4);
            ah[t][i] = *reinterpret_cast<const uint32_t*>(gsm + off);
            al[t][i] = *reinterpret_cast<const uint32_t*>(gsm + C::LO + off);
          }
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < QT / 8; ++t) {
          const uint64_t dh = at(kdh, XT::start(0, 32 * t));
          const uint64_t dl = at(kdl, XT::start(0, 32 * t));
          Wgmma<PB>::rs_tf32(sacc[w], al[t], dh, 1);
          Wgmma<PB>::rs_tf32(sacc[w], ah[t], dl, 1);
          Wgmma<PB>::rs_tf32(sacc[w], ah[t], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc[w]);
#pragma unroll
        for (int t = 0; t < QT / 8; ++t) {
          fence_regs(ah[t]);
          fence_regs(al[t]);
        }
      }
    }

    // every read of this tile is done: the next one loads while y leaves
    __syncthreads();
    if (it + 1 < nt) {
      const int tn = (it + 1) * qe;
      load_tile<T>(sm, gsm, x, a, b, c, g, tn, min(qe, t_len - tn));
    }

    // y through the staging tile (16-byte chunks swizzled by row), then
    // out as whole chunks of a row
    constexpr int RB = C::RB, CH = RB / 16, SW = (CH < 8 ? CH : 8) - 1;
    char* const ys = gsm + C::YS;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
#pragma unroll
      for (int j = 0; j < PB / 8; ++j) {
        const int cb = (8 * j + c2) * C::E;
        store2(reinterpret_cast<T*>(ys + r * RB +
                                    (((cb >> 4) ^ (r & SW)) << 4) +
                                    (cb & 15)),
               yacc[4 * j + 2 * hh], yacc[4 * j + 2 * hh + 1]);
      }
    }
    __syncthreads();
    const long long row0 = g.bi * t_len + t0;
    for (int i = threadIdx.x; i < QT * CH; i += THREADS) {
      const int r = i / CH, ch = i % CH;
      if (r >= rows) continue;
      const char* src = ys + r * RB + ((ch ^ (r & SW)) << 4);
      T* dst = y + ((row0 + r) * nh + g.h) * p_dim + g.p0;
      if (vec_x) {
        if (ch * 16 < g.pw * C::E)
          *reinterpret_cast<int4*>(reinterpret_cast<char*>(dst) + ch * 16) =
              *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < 16 / C::E; ++e) {
          const int p = ch * 16 / C::E + e;
          if (p < g.pw)
            *reinterpret_cast<Bits<T>*>(dst + p) =
                reinterpret_cast<const Bits<T>*>(src)[e];
        }
      }
    }
  }

#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int j = 0; j < PB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
        if (n < n_dim && p < g.pw)
          s_out[((long long)bh * p_dim + g.p0 + p) * n_dim + n] =
              sacc[w][4 * j + e];
      }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* s0, void* y, void* s_out, int bsz, int nh, int t_len,
           int q, int p_dim, int n_dim, void* stream) {
  if (q < 1 || q > QMAX || p_dim < 1 || p_dim > PMAX || n_dim < 1 ||
      n_dim > NMAX || bsz < 0 || nh < 0 || t_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Cfg<T>::BYTES;
  auto kernel = ssd_kernel<T>;
  static const int smem_err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (smem_err) return smem_err;
  constexpr int PB = Cfg<T>::PB;
  const int nps = (p_dim + PB - 1) / PB;
  const long long blocks = (long long)bsz * nh * nps;
  if (blocks == 0) return 0;
  const int e = sizeof(T);
  const int vec_x = (p_dim * e) % 16 == 0 && aligned16(x) && aligned16(y);
  const int vec_bc = (n_dim * e) % 16 == 0 && aligned16(b) && aligned16(c);
  kernel<<<(unsigned)blocks, THREADS, bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), nh, t_len, q < QT ? q : QT, p_dim, n_dim,
      nps, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_f32(const void* x, const void* a, const void* b,
                       const void* c, const void* s0, void* y, void* s_out,
                       int bsz, int nh, int t_len, int q, int p_dim,
                       int n_dim, void* stream) {
  return launch<float>(x, a, b, c, s0, y, s_out, bsz, nh, t_len, q, p_dim,
                       n_dim, stream);
}

extern "C" int ssd_bf16(const void* x, const void* a, const void* b,
                        const void* c, const void* s0, void* y, void* s_out,
                        int bsz, int nh, int t_len, int q, int p_dim,
                        int n_dim, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, c, s0, y, s_out, bsz, nh, t_len, q,
                               p_dim, n_dim, stream);
}
