// ssd backward: the gradients of the Mamba-2 state-space scan with
// respect to x, a, b, c and the initial state, given dy and the final
// state's gradient. Per (batch, head), with h_t = e^{a_t} h_{t-1} + x_t
// b_t^T (P x N) and y_t = h_t c_t, and dh_t = dy_t c_t^T + e^{a_{t+1}}
// dh_{t+1} from dh_{T+1} term = dstate:
//   dx_t = dh_t b_t,  db_t = sum_heads dh_t^T x_t,  dc_t = sum_heads
//   h_t^T dy_t,  da_t = <dh_t, e^{a_t} h_{t-1}>,  dstate0 = e^{a_1} dh_1.
// x (B, T, H, P), b / c (B, T, N) and dy (as x) are float32 or bfloat16,
// a (B, T, H) and the states (B, H, P, N) float32; P <= 64, N <= 128, as
// the forward (csrc/ssd.cu).
//
// Replaces no Pallas kernel: the JAX package has no backward of its ssd
// kernel, and its training differentiates the model's chunked scan
// (repro/models/ssd.py:ssd_scan) by autodiff. The port's SSD layers run
// the forward on the ssd kernel, whose output has no autograd graph, so
// their gradient needs a kernel of its own (the wrapper, kernels/ssd.py,
// binds both in a torch.autograd.Function).
//
// Bound on the H100 (`ssd.bwd_work`): at Mamba-2's training batch (2,
// 512, 80, 64), N 128, bf16, the products are 9.4 GFLOP (9.5 us at 989
// TFLOP/s) and the bytes 33 MB (9.9 us at 3.35 TB/s): bytes.
//
// The chunked form, in chunks of QT = 64 steps (one wgmma M). For a chunk
// of q steps with entry state S0 and dS the gradient of the state leaving
// it, cum the running sum of a inside it, L[t, s] = exp(cum_t - cum_s) (s
// <= t), ecum_t = exp(cum_t) and etail_s = exp(cum_{q-1} - cum_s):
//   W = L o (C B^T),  R2 = L o (dY X^T),  G2 = W o (dY X^T)
//   dX = W^T dY + etail o (B dS^T)
//   dB = R2^T C + etail o (X dS),  dC = R2 B + ecum o (dY S0)
//   dS before the chunk = ecum_{q-1} dS + (ecum o dY)^T C
// and the gradient of cum_t, g_t = rowsum_t G2 - colsum_t G2 + ecum_t
// c_t . (dY S0)_t - e_t, with e_s = etail_s b_s . (X dS)_s, and g_{q-1}
// also takes sum_s e_s + ecum_{q-1} <dS, S0>; da_s = sum_{t >= s} g_t
// inside the chunk.
//
// bf16 (the path's) runs chunk-parallel on the tensor cores, in three
// launches and no atomics (float32 after it):
// - ssd_bwd_state_kernel carries the two chains across the chunks, a
//   block of one warpgroup per (batch, head, 32 columns of P, direction):
//   forwards S^T += B^T (decayed X), backwards dS^T += C^T (ecum o dY),
//   each in float32 accumulator registers, the scaled operand split hi +
//   lo in bf16 and both products taken (the forward kernel's update, ~16
//   bits a term), the next chunk's tiles landing while one computes. At
//   each chunk's start it writes S0 (forwards) or dS (backwards), hi and
//   lo, as the image of the swizzled bf16 tile that the chunk pass reads
//   (rows P, N along the row): a scratch (B, H, chunks, 2, 2, 64 x 128)
//   bf16. The backward chain's last dS is dstate0.
// - ssd_bwd_chunk_kernel runs every chunk product on `wgmma`, a block per
//   (batch, chunk, HG heads) with two warpgroups. For each head in order,
//   warpgroup 0 forms B C^T and X dY^T and on them W^T, R2^T and G2's
//   column sums, then dX = W^T dY + etail o (B dS^T), X dS (dS hi + lo: it
//   reaches da through e) and dB += R2^T C + etail o (X dS); warpgroup 1
//   forms C B^T, dY X^T, W, R2 and G2's row sums, then dY S0 (S0 hi + lo: it
//   reaches da) and dC += R2 B + ecum o (dY S0). dB and dC so sum over
//   the block's heads in its accumulators, in head order, and leave once a
//   block to a scratch (B, H / HG, T, N) float32; dX and da leave per
//   head. C B^T and dY X^T, which reach da, are exact in float32 from
//   bf16 operands; the bf16-rounded W and R2 reach only dX, dB and dC.
//   Each head's tiles (X, dY, the four images: one linear copy) land by
//   cp.async on an mbarrier while the head before computes.
// - ssd_bwd_sum_kernel sums the dB and dC scratch over the head groups.
// Blocks and bytes at the training batch, (2, 512, 80, 64) with N 128:
// the state pass 2 x 80 x 2 x 2 = 640 blocks of 128 threads, 68 KB of
// shared memory (three a SM); the chunk pass 2 x 8 x 16 = 256 blocks of
// 256 threads, 197 KB (one a SM; HG = 5). Scratch: the images 2 x 42 MB,
// written and read once, and dB, dC 2 x 8.4 MB (per head they were 2 x
// 42 MB): about 200 MB moved beside the bound's 33 MB. Chunk-parallel
// (1,280 (batch, head, chunk) items) rather than a block per (batch,
// head, P slice) walking the chunks with every product: there, dB, dC
// and da are partial over the P slices and each block's dB and dC a
// (T, N) slab of its own, 4 x 42 MB of scratch.
//
// What holds it back (tools/ssd_ab.py, NVIDIA H100 80GB HBM3 at 700 W,
// the training batch: 0.169 ms, 6 % of the bound): latency, not the
// tensor cores or the bytes. The state pass (61 us) is 8 dependent steps
// a block (load, image, scan, scale, products), its 640 blocks in two
// waves of 396. The chunk pass (97 us) runs two waves of one block a SM,
// each block's first two heads (192 KB) requested together at a wave's
// start; without any product it still took 85 us, without most image
// loads 92. Tried and dropped (copies of this kernel, the same tool):
// state blocks of all 64 columns (107 us: one wave of longer steps), the
// images stored from the registers without staging (121 us), B dS^T on
// warpgroup 1 behind a named barrier (chunk pass 104 us, 16 bytes
// spilled), the second head's (or chunk's) loads issued only once the
// first's landed (0.171 ms against 0.168 in turns); 10 heads a chunk
// block (one wave of 128 blocks) took 85.5 us. Later work: a persistent
// chunk pass that prefetches across its items, and a deeper tile
// pipeline in the state pass.
//
// float32 runs the same three launches on the tensor cores, on 3xTF32
// (each operand x split hi = tf32(x), lo = tf32(x - hi), a product lo hi
// + hi lo + hi hi into float32 accumulators), with its own state and
// chunk passes (state_pass_f32, chunk_pass_f32), because bf16's tiles do
// not carry over. tf32 `wgmma` reads K-major operands only, and every
// product here contracts over steps or over P or N, so most operands are
// needed transposed somewhere; and a float32 tile with its lo half takes
// four times bf16's room: per head at QT 64, P 64, N 128, X and dY 16 KB
// each raw, the S0 and dS images 32 KB each; B and C 32 KB each; with hi
// and lo, and the transposed copies bf16 reads MN-major, over 320 KB
// against a block's 227 KB. So:
// - An operand on the A side is never stored split or transposed: each
//   k-step's fragment is loaded from the raw tile in whatever order the
//   product needs and split in registers (split_walk in hopper_tile.cuh,
//   two register sets taking turns). Only B operands are stored hi | lo.
// - Products are oriented so that the B operands are the tiles that
//   arrive K-major (X, dY: rows steps, P along) or small tiles written for
//   the purpose: the chunk pass forms dB^T and dC^T (rows N), not dB and
//   dC, and dX^T (rows P), and writes W^T, R2 and R2^T (64 x 64, hi | lo)
//   over the room of X and the images once those are read.
// - The scores C B^T do not depend on the head: a chunk block forms them
//   once, B split hi | lo into the room of the first head's tiles.
// - The dX term Z = etail o (B dS^T) contracts over N with both operands
//   large; the state pass forms it where dS is in registers (B's rows
//   split, dS written hi | lo, rows P, into shared memory), and writes it
//   to dx, which the chunk pass reads with the head's tiles, adds W^T dY
//   to, and also takes e from (e_s = sum_p X[s][p] Z[s][p]).
// - The images are float32 (rows N, P along), written from the chains'
//   registers and split on landing as A fragments; tf32 hi | lo images
//   would double those bytes.
// State pass (state_pass_f32): a block per (batch, head, direction), all
// of P, two warpgroups, each owning the chain's 64 rows n of one M tile
// (S^T += M^T (scaled tile), A = M^T split from M's tile) and, backwards,
// contracting its 64 n of the dX term (the halves summed through B's tile
// once both have read it, warpgroup 0's first): two stages of M (B or C)
// 32 KB, X or dY 16 KB and a, B 32 KB (backwards), dS hi | lo 64 KB, which
// the scaled X^T or dY^T hi | lo (32 KB) reuses: 196 KB, one block a SM,
// 320 blocks at the training batch. A P slice of 32 a block, as bf16's,
// took the same time at two blocks a SM: one warpgroup's walk was the
// bound, not the blocks.
// Chunk pass (chunk_pass_f32): a block per (batch, chunk, HG_F = 10
// heads), two warpgroups: C, B raw 64 KB; X, dY hi | lo 64 KB; the S0 and
// dS images raw 64 KB; the dX term Z 16 KB; a and the vectors: 214 KB,
// one block a SM; 128 blocks at the training batch, one wave. Per head,
// in turn: e from X and Z; warpgroup 0 forms dS^T X^T (dB^T += etail o
// it), warpgroup 1 S0^T dY^T (its S0 terms, dC^T += ecum o it), one M tile
// of 64 n at a time; each warpgroup half the columns of dY X^T (W, R2,
// G2's sums on the fragments with G's); W^T, R2 and R2^T out to shared
// memory; dB^T += C^T R2 and dC^T += B^T R2^T on the tensor cores;
// dX^T = dY^T W, added to Z into dx. A head's tiles land only once the
// head before has read them (no room for a second set).
// Scratch and bytes at the training batch, (2, 512, 80, 64) N 128: the
// images 2 x 42 MB written and read once (168 MB), the dX term written,
// read and written again (63 MB), dB and dC over 8 head groups 2 x 4.2 MB
// written and read (17 MB), beside x, dy, b, c, a and the outputs (about
// 60 MB): about 300 MB, 90 us at 3.35 TB/s, against the bound's 57 us
// (operations at 3xTF32's 165 TFLOP/s). No atomics and every sum in one
// order: two launches agree bitwise, in either type.
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_tile.cuh"
#include "hopper_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// db, dc (B, T, N) = the partial gradients (B, groups, T, N) summed over
// the head groups in order
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_sum_kernel(const float* __restrict__ dbh,
                   const float* __restrict__ dch, T* __restrict__ db,
                   T* __restrict__ dc, int h, int t_len, int n,
                   long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long tn = (long long)t_len * n;
  const long long bi = i / tn, r = i - bi * tn;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < h; ++k) {
    const long long o = (bi * h + k) * tn + r;
    sb += dbh[o];
    sc += dch[o];
  }
  db[i] = from_f<T>(sb);
  dc[i] = from_f<T>(sc);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int QT = 64;          // steps a chunk: one wgmma M
constexpr int PM = 64;          // largest head dim: a tile's P
constexpr int NM = 128;         // largest state width: a tile's N
constexpr int PB = 32;          // P columns a state-pass block
constexpr int HG = 5;            // heads a chunk-pass block
constexpr int WG = 128;         // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;

using RowT = Tile<QT, NM * 2>;       // C, B: rows steps, N along the row
using XT = Tile<QT, PM * 2>;         // X, dY: rows steps, P along the row
using XSl = Tile<QT, PB * 2>;        // a state-pass slice of X or dY
using ImgT = Tile<PM, NM * 2>;       // an S0 or dS image: rows P, N along
using ImgS = Tile<PB, NM * 2>;       // a state-pass slice of an image
constexpr int IMG = ImgT::BYTES;     // 16 KB: one bf16 image (hi or lo)

// raw bits of an element: zero-filling needs no arithmetic on T
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                       unsigned int>::type;

// QT rows of ROW elements (row r at src + r * stride) into tile TL; rows
// >= `rows` and elements >= `width` are zero. 16-byte cp.async where the
// rows are whole 16-byte chunks (`vec`), else element by element (plain
// stores, which the reader's proxy fence and barrier publish)
template <typename T, typename TL, int ROW, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, char* gdst,
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

// a's QT steps of head `h` from row `row0` (steps past `rows` are 0)
template <int THREADS>
__device__ __forceinline__ void load_a(uint32_t dst, const float* a,
                                       long long row0, int nh, int h,
                                       int rows) {
  for (int j = threadIdx.x; j < QT; j += THREADS) {
    const bool ok = j < rows;
    cp_async4(dst + 4 * j, ok ? a + (row0 + j) * nh + h : a, ok);
  }
}

// the descriptor `d` moved `bytes` further on: its start address is the
// low 14 bits, in 16-byte units, and shared memory ends below 2^18 bytes
__device__ __forceinline__ uint64_t at(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}
// K-major and MN-major descriptors of a tile TL at `base`
template <typename TL>
__device__ __forceinline__ uint64_t kmaj(uint32_t base) {
  return desc(base, 16, 8 * TL::W, TL::W);
}
template <typename TL>
__device__ __forceinline__ uint64_t mnmaj(uint32_t base) {
  return desc(base, TL::PANEL, 8 * TL::W, TL::W);
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float2 bf16x2_at(const char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the running sum of a over a chunk (steps past `rows` add 0), in log2
// units so that every decay is one exp2f, by one warp (two steps a lane):
// cum, exp2(cum) into `ecum` and exp2(last - cum) into `etail`, last =
// cum[rows - 1]; returns exp2(last)
__device__ __forceinline__ float chunk_cum(const float* ar, float* cum,
                                           float* ecum, float* etail,
                                           int rows) {
  const int lane = threadIdx.x % 32;
  const float a0 = ar[2 * lane], a1 = ar[2 * lane + 1];
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float k0 = (excl + a0) * LOG2E, k1 = (excl + a0 + a1) * LOG2E;
  const float last = __shfl_sync(0xffffffffu, (rows - 1) & 1 ? k1 : k0,
                                 (rows - 1) >> 1);
  cum[2 * lane] = k0;
  cum[2 * lane + 1] = k1;
  ecum[2 * lane] = exp2f(k0);
  ecum[2 * lane + 1] = exp2f(k1);
  etail[2 * lane] = exp2f(last - k0);
  etail[2 * lane + 1] = exp2f(last - k1);
  return exp2f(last);
}

// an accumulator tile of 64 columns as bf16 wgmma A fragments: a k-step
// of 16 columns is n-blocks 2t, 2t + 1, whose accumulator pairs are the
// fragment's
struct Frag {
  uint32_t r[QT / 16][4];
  __device__ __forceinline__ void pack(const float (&p)[QT / 2]) {
#pragma unroll
    for (int t = 0; t < QT / 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[t][i] = pack_bf16(p[8 * t + 2 * i], p[8 * t + 2 * i + 1]);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int t = 0; t < QT / 16; ++t) fence_regs(r[t]);
  }
};

// the sum of a row's values over the four lanes that hold it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the state pass -------------------------------------------------------
// shared memory: two stages of (M = B or C, the X or dY slice, a), the
// scaled slice hi | lo, the image slice hi | lo, cum | ecum | etail |
// decay, two mbarriers
struct StateCfg {
  static constexpr int M_B = RowT::BYTES;                    // 16 KB
  static constexpr int X_B = XSl::BYTES;                     // 4 KB
  static constexpr int A_OFF = M_B + X_B;
  static constexpr int STAGE = align1024(A_OFF + QT * 4);
  static constexpr int XH = 2 * STAGE, XL = XH + X_B;
  static constexpr int IM = XL + X_B;
  static constexpr int VEC = IM + 2 * ImgS::BYTES;
  static constexpr int BARS = VEC + (3 * QT + 4) * 4;
  static constexpr int BYTES = BARS + 16 + 1024;             // + alignment
  static_assert(BYTES <= 232448 / 3, "state pass: three blocks a SM");
};

// blocks: (batch, head, P slice, direction), direction innermost, one
// warpgroup each. The forward chain (direction 0) writes each chunk's
// entry state S0, the backward one each chunk's leaving gradient dS, hi
// and lo, to the image scratch at ((b, h, chunk, direction, hi | lo), 64
// x 128 bf16); the backward chain's last dS is dstate0
template <typename T>
__device__ __forceinline__ void state_pass(
    const T* __restrict__ x, const float* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ dy, const float* __restrict__ dstate,
    const float* __restrict__ state0, float* __restrict__ ds0,
    char* __restrict__ images, int nh, int t_len, int p_dim, int n_dim,
    int nps, int vec_x, int vec_bc) {
  using C = StateCfg;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`
  float* const vcum = reinterpret_cast<float*>(gsm + C::VEC);
  float* const vecum = vcum + QT;
  float* const vetail = vecum + QT;
  float* const vdecay = vetail + QT;

  const bool back = blockIdx.x & 1;
  const int ps = (blockIdx.x >> 1) % nps, bh = (blockIdx.x >> 1) / nps;
  const int hh = bh % nh;
  const long long bi = bh / nh;
  const int p0 = ps * PB, pw = min(PB, p_dim - p0);
  const int nc = (t_len + QT - 1) / QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;       // accumulator rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);             // and columns c2, c2 + 1 of 8
  // the chain's operands and scale: forwards B, X and X's decay to the
  // chunk's end; backwards C, dY and exp(cum)
  const T* msrc = back ? c : b;
  const T* xsrc = back ? dy : x;
  const float* vscale = back ? vecum : vetail;

  auto load = [&](int it) {
    const int k = back ? nc - 1 - it : it, t0 = k * QT;
    const int rows = min(QT, t_len - t0);
    const uint32_t sb = sm + (it & 1) * C::STAGE;
    char* const gsb = gsm + (it & 1) * C::STAGE;
    const long long row0 = bi * t_len + t0;
    load_tile<T, RowT, NM, WG>(sb, gsb, msrc + row0 * n_dim, n_dim, rows,
                               n_dim, vec_bc);
    load_tile<T, XSl, PB, WG>(sb + C::M_B, gsb + C::M_B,
                              xsrc + (row0 * nh + hh) * p_dim + p0,
                              (long long)nh * p_dim, rows, pw, vec_x);
    load_a<WG>(sb + C::A_OFF, a, row0, nh, hh, rows);
    cp_async_arrive(sm + C::BARS + 8 * (it & 1));
  };

  if (threadIdx.x == 0) {
    mbar_init(sm + C::BARS, WG);
    mbar_init(sm + C::BARS + 8, WG);
    fence_mbar_init();
  }
  __syncthreads();
  load(0);
  if (nc > 1) load(1);

  // S^T or dS^T: rows n = 64 w + r0 (+ 8), columns p of this slice
  const float* init = back ? dstate : state0;
  float sacc[2][PB / 2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int j = 0; j < PB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
        sacc[w][4 * j + e] =
            init != nullptr && n < n_dim && p < pw
                ? init[((long long)bh * p_dim + p0 + p) * n_dim + n]
                : 0.f;
      }

  for (int it = 0; it < nc; ++it) {
    const int k = back ? nc - 1 - it : it, t0 = k * QT;
    const int rows = min(QT, t_len - t0);
    const uint32_t sb = sm + (it & 1) * C::STAGE;
    char* const gsb = gsm + (it & 1) * C::STAGE;
    mbar_wait(sm + C::BARS + 8 * (it & 1), (it >> 1) & 1);

    // the chain's value at the chunk's start, hi + lo, into the image
    // slice (rows p, n along the row)
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int j = 0; j < PB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
          const float v = sacc[w][4 * j + e];
          const float hi = __bfloat162float(__float2bfloat16_rn(v));
          const uint32_t off = ImgS::offset(p, n * 2);
          *reinterpret_cast<unsigned short*>(gsm + C::IM + off) =
              bf16_bits(v);
          *reinterpret_cast<unsigned short*>(gsm + C::IM + ImgS::BYTES +
                                             off) = bf16_bits(v - hi);
        }
    if (warp == 0) {
      const float decay = chunk_cum(
          reinterpret_cast<const float*>(gsb + C::A_OFF), vcum, vecum,
          vetail, rows);
      if (lane == 0) *vdecay = decay;
    }
    __syncthreads();                         // the image slice, the scales

    // the image slice out, 16 bytes a copy: panel w of the slice is rows
    // [p0, p0 + 32) of the image's panel w, whose swizzle (row & 7) it
    // shares; the last slice of a head with P <= 32 zeroes rows 32..63
    {
      char* const img = images +
          (((long long)bh * nc + k) * 2 + back) * 2 * IMG;
      constexpr int CH = ImgS::PANEL / 16;    // 16-byte chunks a panel
      for (int i = threadIdx.x; i < 4 * CH; i += WG) {
        const int hl = i / (2 * CH), w = i / CH % 2, o = i % CH;
        *reinterpret_cast<uint4*>(img + hl * IMG + w * ImgT::PANEL +
                                  p0 * 128 + o * 16) =
            *reinterpret_cast<const uint4*>(gsm + C::IM + hl * ImgS::BYTES +
                                            w * ImgS::PANEL + o * 16);
        if (ps == nps - 1 && PB * nps < PM)
          *reinterpret_cast<uint4*>(img + hl * IMG + w * ImgT::PANEL +
                                    PB * nps * 128 + o * 16) =
              make_uint4(0, 0, 0, 0);
      }
    }

    // the scaled slice, split hi + lo
    {
      constexpr int CH = PB * 2 / 16;
      for (int i = threadIdx.x; i < QT * CH; i += WG) {
        const int r = i / CH, off = XSl::offset(r, (i % CH) * 16);
        const uint4 v = *reinterpret_cast<const uint4*>(gsb + C::M_B + off);
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&v);
        const float d = vscale[r];
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&vw[q]));
          const float x0 = f.x * d, x1 = f.y * d;
          const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hb);
          hw[q] = *reinterpret_cast<const uint32_t*>(&hb);
          lw[q] = pack_bf16(x0 - hf.x, x1 - hf.y);
        }
        *reinterpret_cast<uint4*>(gsm + C::XH + off) =
            make_uint4(hw[0], hw[1], hw[2], hw[3]);
        *reinterpret_cast<uint4*>(gsm + C::XL + off) =
            make_uint4(lw[0], lw[1], lw[2], lw[3]);
      }
    }
    const float decay = *vdecay;
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int i = 0; i < PB / 2; ++i) sacc[w][i] *= decay;
    fence_proxy_async();
    __syncthreads();                         // the scaled slice

    // S^T = decay S^T + M^T (scaled slice), hi then lo: A = M's tile read
    // MN-major (M = n: panel w; K = 16 steps), B the slice MN-major
    const uint64_t mb = mnmaj<RowT>(sb);
    const uint64_t mh = mnmaj<XSl>(sm + C::XH), ml = mnmaj<XSl>(sm + C::XL);
    wgmma_fence();
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int t = 0; t < QT / 16; ++t) {
        const uint64_t da = at(mb, RowT::start(16 * t, 128 * w));
        Wgmma<PB>::ss_bf16_tt(sacc[w], da, at(mh, XSl::start(16 * t, 0)), 1);
        Wgmma<PB>::ss_bf16_tt(sacc[w], da, at(ml, XSl::start(16 * t, 0)), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc[0]);
    fence_regs(sacc[1]);
    __syncthreads();               // the stage, the slices and the image
    if (it + 2 < nc) load(it + 2);
  }

  if (back && ds0 != nullptr) {
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int j = 0; j < PB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * w + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
          if (n < n_dim && p < pw)
            ds0[((long long)bh * p_dim + p0 + p) * n_dim + n] =
                sacc[w][4 * j + e];
        }
  }
}

// ---- the chunk pass -------------------------------------------------------
// shared memory: C | B, two stages of (X | dY | S0 hi | S0 lo | dS hi | dS
// lo | a), the vectors, two mbarriers
struct ChunkCfg {
  static constexpr int R_B = RowT::BYTES;                 // 16 KB
  static constexpr int X_B = XT::BYTES;                   // 8 KB
  static constexpr int SX = 0, SDY = X_B, SIM = 2 * X_B;
  static constexpr int SA = SIM + 4 * IMG;
  static constexpr int STAGE = align1024(SA + QT * 4);
  static constexpr int ST0 = 2 * R_B;
  // cum, ecum, etail, G2's column sums, e, G2's row sums, the S0 term,
  // and the warps' <dS, S0> partials
  static constexpr int VEC = ST0 + 2 * STAGE;
  static constexpr int BARS = VEC + (7 * QT + 8) * 4;
  static constexpr int BYTES = BARS + 16 + 1024;          // + alignment
  static_assert(BYTES <= 232448, "chunk pass: shared memory");
};

// blocks: (batch, chunk, group of HG heads), groups innermost; two
// warpgroups. Writes dx and da per head, and dB / dC of the group's heads
// to dbg / dcg (B, groups, T, N)
template <typename T>
__device__ __forceinline__ void chunk_pass(
    const T* __restrict__ x, const float* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ dy, const char* __restrict__ images,
    T* __restrict__ dx, float* __restrict__ da, float* __restrict__ dbg,
    float* __restrict__ dcg, int nh, int t_len, int p_dim, int n_dim, int ng,
    int vec_x, int vec_bc) {
  using C = ChunkCfg;
  constexpr int THREADS = 2 * WG;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);
  float* const vcum = reinterpret_cast<float*>(gsm + C::VEC);
  float* const vecum = vcum + QT;
  float* const vetail = vecum + QT;
  float* const vcol = vetail + QT;     // G2's column sums (by s)
  float* const vev = vcol + QT;        // e_s
  float* const vrow = vev + QT;        // G2's row sums (by t)
  float* const vs0 = vrow + QT;        // ecum_t c_t . (dY S0)_t
  float* const vdot = vs0 + QT;        // the warps' <dS, S0>

  const int nc = (t_len + QT - 1) / QT;
  const int g = blockIdx.x % ng, k = blockIdx.x / ng % nc;
  const long long bi = blockIdx.x / ng / nc;
  const int h0 = g * HG, hn = min(HG, nh - h0);
  const int t0 = k * QT, q = min(QT, t_len - t0);
  const long long row0 = bi * t_len + t0;
  const int wg = threadIdx.x / WG, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp % 4 * 16 + lane / 4;   // accumulator rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);             // and columns c2, c2 + 1 of 8
  const uint32_t cs = sm, bs = sm + C::R_B;  // C, B
  const uint32_t bars = sm + C::BARS;

  // head h0 + i's tiles into stage i & 1: X, dY, the four images (one
  // linear copy: they are stored as the swizzled tiles), a
  auto load_head = [&](int i) {
    const int hh = h0 + i;
    const uint32_t sb = sm + C::ST0 + (i & 1) * C::STAGE;
    char* const gsb = gsm + C::ST0 + (i & 1) * C::STAGE;
    const long long xo = (row0 * nh + hh) * p_dim;
    load_tile<T, XT, PM, THREADS>(sb + C::SX, gsb + C::SX, x + xo,
                                  (long long)nh * p_dim, q, p_dim, vec_x);
    load_tile<T, XT, PM, THREADS>(sb + C::SDY, gsb + C::SDY, dy + xo,
                                  (long long)nh * p_dim, q, p_dim, vec_x);
    const char* im = images + ((bi * nh + hh) * nc + k) * 4LL * IMG;
    for (int j = threadIdx.x; j < 4 * IMG / 16; j += THREADS)
      cp_async16(sb + C::SIM + 16 * j, im + 16 * j, true);
    load_a<THREADS>(sb + C::SA, a, row0, nh, hh, q);
    cp_async_arrive(bars + 8 * (i & 1));
  };

  if (threadIdx.x == 0) {
    mbar_init(bars, THREADS);
    mbar_init(bars + 8, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  // C and B join head 0's stage
  load_tile<T, RowT, NM, THREADS>(cs, gsm, c + row0 * n_dim, n_dim, q, n_dim,
                                  vec_bc);
  load_tile<T, RowT, NM, THREADS>(bs, gsm + C::R_B, b + row0 * n_dim, n_dim,
                                  q, n_dim, vec_bc);
  load_head(0);
  if (hn > 1) load_head(1);

  // warpgroup 0: dB (rows s, n); warpgroup 1: dC (rows t, n). Element 4
  // j + e of a tile is row r0 + 8 (e / 2), column 8 j + c2 + e % 2
  float acc[NM / 2];
#pragma unroll
  for (int i = 0; i < NM / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < hn; ++i) {
    const int hh = h0 + i;
    const uint32_t sb = sm + C::ST0 + (i & 1) * C::STAGE;
    char* const gsb = gsm + C::ST0 + (i & 1) * C::STAGE;
    const uint32_t xs = sb + C::SX, ys = sb + C::SDY;
    const uint32_t s0h = sb + C::SIM, s0l = s0h + IMG;
    const uint32_t dsh = s0l + IMG, dsl = dsh + IMG;
    mbar_wait(bars + 8 * (i & 1), (i >> 1) & 1);
    if (warp == 0)
      chunk_cum(reinterpret_cast<const float*>(gsb + C::SA), vcum, vecum,
                vetail, q);
    fence_proxy_async();
    __syncthreads();                 // the head's tiles and its vectors

    // <dS, S0> from the images (the same layout), hi + lo, 8 a copy
    {
      const uint4* ims = reinterpret_cast<const uint4*>(gsb + C::SIM);
      constexpr int Q16 = IMG / 16;
      float dot = 0.f;
      for (int j = threadIdx.x; j < Q16; j += THREADS) {
        const uint4 v[4] = {ims[j], ims[Q16 + j], ims[2 * Q16 + j],
                            ims[3 * Q16 + j]};
        const char* w[4] = {reinterpret_cast<const char*>(&v[0]),
                            reinterpret_cast<const char*>(&v[1]),
                            reinterpret_cast<const char*>(&v[2]),
                            reinterpret_cast<const char*>(&v[3])};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 sh = bf16x2_at(w[0] + 4 * u), sl = bf16x2_at(w[1] + 4 * u);
          const float2 dh = bf16x2_at(w[2] + 4 * u), dl = bf16x2_at(w[3] + 4 * u);
          dot = fmaf(sh.x + sl.x, dh.x + dl.x, dot);
          dot = fmaf(sh.y + sl.y, dh.y + dl.y, dot);
        }
      }
      dot = lane_sum(dot);
      if (lane == 0) vdot[warp] = dot;
    }

    // the scores B C^T (warpgroup 0: rows s) or C B^T (warpgroup 1: rows
    // t), formed again for each head (kept across the heads, they would
    // spill warpgroup 0's dX products), and this head's X dY^T or dY X^T
    float sc[QT / 2], xd[QT / 2];
    wgmma_fence();
    {
      const uint64_t ka = kmaj<RowT>(wg ? cs : bs);
      const uint64_t kb = kmaj<RowT>(wg ? bs : cs);
#pragma unroll
      for (int kk = 0; kk < NM * 2 / 32; ++kk)
        Wgmma<QT>::ss_bf16(sc, at(ka, RowT::start(0, 32 * kk)),
                           at(kb, RowT::start(0, 32 * kk)), kk > 0);
    }
    {
      const uint64_t ka = kmaj<XT>(wg ? ys : xs), kb = kmaj<XT>(wg ? xs : ys);
#pragma unroll
      for (int kk = 0; kk < PM * 2 / 32; ++kk)
        Wgmma<QT>::ss_bf16(xd, at(ka, XT::start(0, 32 * kk)),
                           at(kb, XT::start(0, 32 * kk)), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(xd);

    // the mask and decays: W = L o (C B^T) and R2 = L o (dY X^T), with L
    // = exp2(cum_t - cum_s) for s <= t, transposed in warpgroup 0; G2 = W
    // o (dY X^T) summed along the rows (warpgroup 0: G2's column sums,
    // warpgroup 1: its row sums), exact from exact bf16 operands
    float wv[QT / 2], gsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), col = 8 * j + c2 + (e & 1);
        const int s = wg ? col : row, t = wg ? row : col;
        const float l = exp2f(vcum[t] - vcum[s]);
        const float w = s <= t ? sc[4 * j + e] * l : 0.f;
        const float r = s <= t ? xd[4 * j + e] * l : 0.f;
        gsum[e >> 1] = fmaf(w, xd[4 * j + e], gsum[e >> 1]);
        wv[4 * j + e] = w;
        xd[4 * j + e] = r;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float v = quad_sum(gsum[hf]);
      const int row = r0 + 8 * hf;
      if (lane % 4 == 0 && row < q) (wg ? vrow : vcol)[row] = v;
    }
    Frag fr;                                 // R2^T (wg 0) or R2 (wg 1)
    fr.pack(xd);

    if (wg == 0) {
      // dX = W^T dY + etail o (B dS^T) (rows s, columns p)
      Frag fw;
      fw.pack(wv);
      float dxa[QT / 2], bds[QT / 2];
      const uint64_t my = mnmaj<XT>(ys), kb = kmaj<RowT>(bs);
      const uint64_t kd = kmaj<ImgT>(dsh);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < QT / 16; ++t)
        Wgmma<QT>::rs_bf16_bmn(dxa, fw.r[t], at(my, XT::start(16 * t, 0)),
                               t > 0);
#pragma unroll
      for (int kk = 0; kk < NM * 2 / 32; ++kk)
        Wgmma<QT>::ss_bf16(bds, at(kb, RowT::start(0, 32 * kk)),
                           at(kd, ImgT::start(0, 32 * kk)), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(bds);
      fw.fence();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = r0 + 8 * hf;
        if (s >= q) continue;
        const float et = vetail[s];
        T* row = dx + ((row0 + s) * nh + hh) * p_dim;
#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const int p = 8 * j + c2;
          const float v0 = fmaf(et, bds[4 * j + 2 * hf], dxa[4 * j + 2 * hf]);
          const float v1 =
              fmaf(et, bds[4 * j + 2 * hf + 1], dxa[4 * j + 2 * hf + 1]);
          if (p + 1 < p_dim && !(p_dim & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(row + p) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < p_dim) row[p] = __float2bfloat16_rn(v0);
            if (p + 1 < p_dim) row[p + 1] = __float2bfloat16_rn(v1);
          }
        }
      }

      // X dS (dS hi + lo) and dB += R2^T C
      float xds[NM / 2];
      const uint64_t kx = kmaj<XT>(xs), mc = mnmaj<RowT>(cs);
      const uint64_t mdh = mnmaj<ImgT>(dsh), mdl = mnmaj<ImgT>(dsl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PM / 16; ++kk)
        Wgmma<NM>::ss_bf16_bmn(xds, at(kx, XT::start(0, 32 * kk)),
                               at(mdh, ImgT::start(16 * kk, 0)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < PM / 16; ++kk)
        Wgmma<NM>::ss_bf16_bmn(xds, at(kx, XT::start(0, 32 * kk)),
                               at(mdl, ImgT::start(16 * kk, 0)), 1);
#pragma unroll
      for (int t = 0; t < QT / 16; ++t)
        Wgmma<NM>::rs_bf16_bmn(acc, fr.r[t], at(mc, RowT::start(16 * t, 0)),
                               1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xds);
      fence_regs(acc);
      fr.fence();
      // e_s = etail_s b_s . (X dS)_s, and dB += etail o (X dS)
      float ep[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NM / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int s = r0 + 8 * hf, n = 8 * j + c2;
          const float2 bv = bf16x2_at(gsm + C::R_B + RowT::offset(s, 2 * n));
          const float u0 = xds[4 * j + 2 * hf], u1 = xds[4 * j + 2 * hf + 1];
          ep[hf] = fmaf(bv.y, u1, fmaf(bv.x, u0, ep[hf]));
          acc[4 * j + 2 * hf] = fmaf(vetail[s], u0, acc[4 * j + 2 * hf]);
          acc[4 * j + 2 * hf + 1] =
              fmaf(vetail[s], u1, acc[4 * j + 2 * hf + 1]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(ep[hf]);
        const int s = r0 + 8 * hf;
        if (lane % 4 == 0 && s < q) vev[s] = vetail[s] * v;
      }
    } else {
      // dC += R2 B, and dY S0 (S0 hi + lo)
      float ys0[NM / 2];
      const uint64_t mb = mnmaj<RowT>(bs), ky = kmaj<XT>(ys);
      const uint64_t msh = mnmaj<ImgT>(s0h), msl = mnmaj<ImgT>(s0l);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < QT / 16; ++t)
        Wgmma<NM>::rs_bf16_bmn(acc, fr.r[t], at(mb, RowT::start(16 * t, 0)),
                               1);
#pragma unroll
      for (int kk = 0; kk < PM / 16; ++kk)
        Wgmma<NM>::ss_bf16_bmn(ys0, at(ky, XT::start(0, 32 * kk)),
                               at(msh, ImgT::start(16 * kk, 0)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < PM / 16; ++kk)
        Wgmma<NM>::ss_bf16_bmn(ys0, at(ky, XT::start(0, 32 * kk)),
                               at(msl, ImgT::start(16 * kk, 0)), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ys0);
      fence_regs(acc);
      fr.fence();
      // the S0 term ecum_t c_t . (dY S0)_t, and dC += ecum o (dY S0)
      float sp[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NM / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = r0 + 8 * hf, n = 8 * j + c2;
          const float2 cv = bf16x2_at(gsm + RowT::offset(t, 2 * n));
          const float u0 = ys0[4 * j + 2 * hf], u1 = ys0[4 * j + 2 * hf + 1];
          sp[hf] = fmaf(cv.y, u1, fmaf(cv.x, u0, sp[hf]));
          acc[4 * j + 2 * hf] = fmaf(vecum[t], u0, acc[4 * j + 2 * hf]);
          acc[4 * j + 2 * hf + 1] =
              fmaf(vecum[t], u1, acc[4 * j + 2 * hf + 1]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(sp[hf]);
        const int t = r0 + 8 * hf;
        if (lane % 4 == 0 && t < q) vs0[t] = vecum[t] * v;
      }
    }
    __syncthreads();                 // the sums; the stage is read
    if (i + 2 < hn) load_head(i + 2);

    // da of this head: g's suffix sums inside the chunk, by warp 0 (two
    // steps a lane), every sum in one order
    if (warp == 0) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < 2 * WG / 32; ++w) dot += vdot[w];
      const int s0 = 2 * lane, s1 = s0 + 1;
      const float e0 = s0 < q ? vev[s0] : 0.f, e1 = s1 < q ? vev[s1] : 0.f;
      const float tail = lane_sum(e0 + e1) + vecum[q - 1] * dot;
      float g0 = s0 < q ? vrow[s0] - vcol[s0] + vs0[s0] - e0 : 0.f;
      float g1 = s1 < q ? vrow[s1] - vcol[s1] + vs0[s1] - e1 : 0.f;
      if (s0 == q - 1) g0 += tail;
      if (s1 == q - 1) g1 += tail;
      float suf = g0 + g1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += o;
      }
      if (s0 < q) da[(row0 + s0) * nh + hh] = suf;
      if (s1 < q) da[(row0 + s1) * nh + hh] = suf - g0;
    }
  }

  // dB (warpgroup 0) or dC (warpgroup 1) of the group's heads
  float* out = (wg ? dcg : dbg) + (((long long)bi * ng + g) * t_len + t0) *
                                      n_dim;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    if (row >= q) continue;
#pragma unroll
    for (int j = 0; j < NM / 8; ++j) {
      const int n = 8 * j + c2;
      const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
      float* o = out + (long long)row * n_dim + n;
      if (n + 1 < n_dim && !(n_dim & 1)) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (n < n_dim) o[0] = v0;
        if (n + 1 < n_dim) o[1] = v1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------
using RowF = Tile<QT, NM * 4>;       // C, B: rows steps, N along (32 KB)
using XF = Tile<QT, PM * 4>;         // X, dY (hi or lo): rows steps, P along
using ImgF = Tile<NM, PM * 4>;       // an S0 or dS image: rows N, P along
using SlT = Tile<PM, QT * 4>;        // the scaled X^T or dY^T: rows p
using DsS = Tile<PM, NM * 4>;        // dS: rows p, N along (32 KB)
using DerT = Tile<QT, QT * 4>;       // W^T, R2, R2^T: 64 x 64 (16 KB)
constexpr int IMG_F = ImgF::BYTES;   // 32 KB: one float32 image
constexpr int HG_F = 10;             // heads a float32 chunk-pass block

// wgmma operand helpers: a float32 tile's hi and lo as tf32 B descriptors
// (K-major, k-step s), and 3xTF32 into `acc` from a split A fragment
template <typename TL>
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int row, int s) {
  return kmaj<TL>(base + TL::start(row, 32 * s));
}
// the same as a base descriptor and k-step s moved from it: the chunk
// pass's form (with kdesc its register allocation spilled)
template <typename TL>
__device__ __forceinline__ uint64_t kbase(uint32_t base) {
  return kmaj<TL>(base);
}
template <typename TL>
__device__ __forceinline__ uint64_t kstep(uint64_t d, int row, int s) {
  return at(d, TL::start(row, 32 * s));
}
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N / 2],
                                     uint32_t (&hi)[4], uint32_t (&lo)[4],
                                     uint64_t bh, uint64_t bl, bool more) {
  Wgmma<N>::rs_tf32(acc, lo, bh, more);
  Wgmma<N>::rs_tf32(acc, hi, bl, 1);
  Wgmma<N>::rs_tf32(acc, hi, bh, 1);
}
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
}
__device__ __forceinline__ void put_split(char* hi, char* lo, uint32_t off,
                                          float v) {
  uint32_t h, l;
  split_tf32(v, h, l);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = l;
}

// ---- the float32 state pass ----------------------------------------------
// two stages of M (B forwards, C backwards) | X or dY | a; B (backwards:
// the dX term), on a barrier of its own, which the warpgroups' halves of
// that term cross through once both have read it; dS hi | lo, which the
// scaled X^T or dY^T hi | lo reuses; cum | ecum | etail | decay; three
// mbarriers
struct StateCfgF {
  static constexpr int XS = RowF::BYTES;                      // 32 KB
  static constexpr int A_OFF = XS + XF::BYTES;                // + 16 KB
  static constexpr int STAGE = align1024(A_OFF + QT * 4);
  static constexpr int BB = 2 * STAGE;
  static constexpr int TS = BB + RowF::BYTES;
  static constexpr int VEC = TS + 2 * DsS::BYTES;
  static constexpr int BARS = VEC + (3 * QT + 4) * 4;
  static constexpr int BYTES = BARS + 24 + 1024;              // + alignment
  static constexpr int THREADS = 2 * WG;
  static_assert(BYTES <= 232448, "state pass: shared memory");
  static_assert(SlT::BYTES <= DsS::BYTES, "the scaled tile's room");
  static_assert(THREADS * QT / 2 * 4 <= RowF::BYTES, "the exchange's room");
};

// blocks: (batch, head, direction), direction innermost, every column of
// P; two warpgroups, warpgroup w owning the chain's rows n in [64 w, 64 w
// + 64). Each chunk: the chain's value at its start out to the image
// (rows N, P along, float32: the scratch (B, H, chunks, 2, N, P));
// backwards also the dX term etail o (B dS^T) of the chunk's steps (each
// warpgroup contracting its 64 n, the halves summed warpgroup 0's first),
// written to dx for the chunk pass to add to; then the chain's update,
// all 3xTF32 with the A operand split from registers. The next chunk's
// tiles land while one computes.
__device__ __forceinline__ void state_pass_f32(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ dy, const float* __restrict__ dstate,
    const float* __restrict__ state0, float* __restrict__ ds0,
    char* __restrict__ images, float* __restrict__ dx, int nh, int t_len,
    int p_dim, int n_dim, int vec_x, int vec_bc) {
  using C = StateCfgF;
  constexpr int THREADS = C::THREADS;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);
  float* const vcum = reinterpret_cast<float*>(gsm + C::VEC);
  float* const vecum = vcum + QT;
  float* const vetail = vecum + QT;
  float* const vdecay = vetail + QT;

  const bool back = blockIdx.x & 1;
  const int bh = blockIdx.x >> 1, hh = bh % nh;
  const long long bi = bh / nh;
  const int nc = (t_len + QT - 1) / QT;
  const int wg = threadIdx.x / WG, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp % 4 * 16 + lane / 4;   // accumulator rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);             // and columns c2, c2 + 1 of 8
  const int n0 = 64 * wg;                    // this warpgroup's rows n
  const float* msrc = back ? c : b;
  const float* xsrc = back ? dy : x;
  const float* vscale = back ? vecum : vetail;
  const uint32_t bars = sm + C::BARS, bar_b = bars + 16;

  auto chunk_of = [&](int it) { return back ? nc - 1 - it : it; };
  auto load = [&](int it) {
    const int t0 = chunk_of(it) * QT, rows = min(QT, t_len - t0);
    const long long row0 = bi * t_len + t0;
    const uint32_t sb = sm + (it & 1) * C::STAGE;
    char* const gsb = gsm + (it & 1) * C::STAGE;
    load_tile<float, RowF, NM, THREADS>(sb, gsb, msrc + row0 * n_dim, n_dim,
                                        rows, n_dim, vec_bc);
    load_tile<float, XF, PM, THREADS>(sb + C::XS, gsb + C::XS,
                                      xsrc + (row0 * nh + hh) * p_dim,
                                      (long long)nh * p_dim, rows, p_dim,
                                      vec_x);
    load_a<THREADS>(sb + C::A_OFF, a, row0, nh, hh, rows);
    cp_async_arrive(bars + 8 * (it & 1));
  };
  auto load_b = [&](int it) {
    const int t0 = chunk_of(it) * QT, rows = min(QT, t_len - t0);
    load_tile<float, RowF, NM, THREADS>(sm + C::BB, gsm + C::BB,
                                        b + (bi * t_len + t0) * n_dim, n_dim,
                                        rows, n_dim, vec_bc);
    cp_async_arrive(bar_b);
  };

  if (threadIdx.x == 0) {
    mbar_init(bars, THREADS);
    mbar_init(bars + 8, THREADS);
    mbar_init(bar_b, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  load(0);
  if (nc > 1) load(1);
  if (back) load_b(0);

  // S^T or dS^T: rows n = n0 + r0 (+ 8), columns p = 8 j + c2 (+ 1)
  const float* init = back ? dstate : state0;
  float sacc[PM / 2];
#pragma unroll
  for (int j = 0; j < PM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
      sacc[4 * j + e] = init != nullptr && n < n_dim && p < p_dim
                            ? init[((long long)bh * p_dim + p) * n_dim + n]
                            : 0.f;
    }

  for (int it = 0; it < nc; ++it) {
    const int k = chunk_of(it), t0 = k * QT;
    const int rows = min(QT, t_len - t0);
    const long long row0 = bi * t_len + t0;
    char* const gsb = gsm + (it & 1) * C::STAGE;
    mbar_wait(bars + 8 * (it & 1), (it >> 1) & 1);

    // the chain's value at the chunk's start: the image's rows n (columns
    // past P and rows past N are 0 in the chain)
    float* img = reinterpret_cast<float*>(
        images + (((long long)bh * nc + k) * 2 + back) * IMG_F);
#pragma unroll
    for (int j = 0; j < PM / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(img + (n0 + r0 + 8 * hf) * PM + 8 * j +
                                   c2) =
            make_float2(sacc[4 * j + 2 * hf], sacc[4 * j + 2 * hf + 1]);
    if (warp == 0) {
      const float decay = chunk_cum(
          reinterpret_cast<const float*>(gsb + C::A_OFF), vcum, vecum,
          vetail, rows);
      if (lane == 0) *vdecay = decay;
    }
    // backwards: dS (rows p, N along), hi | lo, the B operand of B dS^T
    if (back) {
#pragma unroll
      for (int j = 0; j < PM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
          put_split(gsm + C::TS, gsm + C::TS + DsS::BYTES,
                    DsS::offset(p, 4 * n), sacc[4 * j + e]);
        }
    }
    fence_proxy_async();
    __syncthreads();                         // the scales, dS, the stage

    if (back) {
      // dX's term etail o (B dS^T) (rows s, columns p): this warpgroup's
      // K = n in [n0, n0 + 64), A = B's rows split from registers, three
      // products in three accumulators, (lo hi + hi lo) + hi hi
      mbar_wait(bar_b, it & 1);
      float z[3][PM / 2];
      split_walk<NM / 16, 1>(
          [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
            float v[4];
            frag_kmajor<RowF>(gsm + C::BB, r0, n0 / 8 + s, v);
            split4(v, hi, lo);
          },
          [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
            const uint64_t dh = kdesc<DsS>(sm + C::TS, 0, n0 / 8 + s);
            const uint64_t dl =
                kdesc<DsS>(sm + C::TS + DsS::BYTES, 0, n0 / 8 + s);
            Wgmma<PM>::rs_tf32(z[0], lo[0], dh, s > 0);
            Wgmma<PM>::rs_tf32(z[1], hi[0], dl, s > 0);
            Wgmma<PM>::rs_tf32(z[2], hi[0], dh, s > 0);
          });
#pragma unroll
      for (int i = 0; i < 3; ++i) fence_regs(z[i]);
      // the halves cross through B's tile, warpgroup 0's first in both
      float zs[PM / 2];
#pragma unroll
      for (int i = 0; i < PM / 2; ++i) zs[i] = (z[0][i] + z[1][i]) + z[2][i];
      __syncthreads();                       // B and dS are read
      float4* xz = reinterpret_cast<float4*>(gsm + C::BB);
#pragma unroll
      for (int i = 0; i < PM / 8; ++i)
        xz[i * THREADS + threadIdx.x] =
            make_float4(zs[4 * i], zs[4 * i + 1], zs[4 * i + 2], zs[4 * i + 3]);
      __syncthreads();
      // warpgroup w writes columns [32 w, 32 w + 32) of the sum
#pragma unroll
      for (int i = 0; i < PM / 8; ++i) {
        if (i / 4 != wg) continue;
        const float4 u = xz[i * THREADS + (threadIdx.x ^ WG)];
        const float o[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          zs[4 * i + e] = wg ? o[e] + zs[4 * i + e] : zs[4 * i + e] + o[e];
      }
      __syncthreads();                       // the exchange is read
      if (it + 1 < nc) load_b(it + 1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = r0 + 8 * hf;
        if (s >= rows) continue;
        const float et = vetail[s];
        float* row = dx + ((row0 + s) * nh + hh) * p_dim;
#pragma unroll
        for (int j = 0; j < PM / 8; ++j) {
          if (j / 4 != wg) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = 8 * j + c2 + e;
            if (p < p_dim) row[p] = et * zs[4 * j + 2 * hf + e];
          }
        }
      }
    }

    // the scaled X or dY (etail o X, ecum o dY), transposed, hi | lo
    for (int i = threadIdx.x; i < QT * PM; i += THREADS) {
      const int p = i % PM, st = i / PM;
      const float v = *reinterpret_cast<const float*>(
                          gsb + C::XS + XF::offset(st, 4 * p)) * vscale[st];
      put_split(gsm + C::TS, gsm + C::TS + SlT::BYTES, SlT::offset(p, 4 * st),
                v);
    }
    const float decay = *vdecay;
#pragma unroll
    for (int i = 0; i < PM / 2; ++i) sacc[i] *= decay;
    fence_proxy_async();
    __syncthreads();                         // the scaled tile

    // S^T = decay S^T + M^T (scaled tile), this warpgroup's rows n: A =
    // M^T (K = steps) split from M's tile
    split_walk<QT / 8, 1>(
        [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          float v[4];
          frag_mn<RowF>(gsb, n0 + r0, s, v);
          split4(v, hi, lo);
        },
        [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
          mma3<PM>(sacc, hi[0], lo[0], kdesc<SlT>(sm + C::TS, 0, s),
                   kdesc<SlT>(sm + C::TS + SlT::BYTES, 0, s), true);
        });
    fence_regs(sacc);
    __syncthreads();                         // the stage and the tiles
    if (it + 2 < nc) load(it + 2);
  }

  if (back && ds0 != nullptr) {
#pragma unroll
    for (int j = 0; j < PM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + r0 + 8 * (e >> 1), p = 8 * j + c2 + (e & 1);
        if (n < n_dim && p < p_dim)
          ds0[((long long)bh * p_dim + p) * n_dim + n] = sacc[4 * j + e];
      }
  }
}

// ---- the float32 chunk pass -----------------------------------------------
// C | B | X hi | X lo | dY hi | dY lo | S0 image | dS image | a | vectors |
// one mbarrier. Once a head's X and images are read, W^T (hi | lo) takes
// X's room and R2, R2^T the images'; the prologue's B hi | lo takes X's
// and dY's.
struct ChunkCfgF {
  static constexpr int CS = 0, BS = RowF::BYTES;
  static constexpr int XH = 2 * RowF::BYTES, XL = XH + XF::BYTES;
  static constexpr int YH = XL + XF::BYTES, YL = YH + XF::BYTES;
  static constexpr int S0I = YL + XF::BYTES, DSI = S0I + IMG_F;
  static constexpr int DXS = DSI + IMG_F;     // the state pass's dX term
  static constexpr int AR = DXS + XF::BYTES;
  static constexpr int WTH = XH, WTL = XL;
  static constexpr int R2H = S0I, R2L = S0I + DerT::BYTES;
  static constexpr int RTH = DSI, RTL = DSI + DerT::BYTES;
  static constexpr int GBH = XH, GBL = XH + RowF::BYTES;
  // cum, ecum, etail; e; the S0 term's partials by warp (4 x QT); G2's
  // row partials by warpgroup (2 x QT) and column partials by warp (8 x
  // 32); the warps' <dS, S0>
  static constexpr int VEC = AR + QT * 4;
  static constexpr int NVEC = 3 * QT + 5 * QT + 2 * QT + 8 * 32 + 8;
  static constexpr int BARS = VEC + NVEC * 4;
  static constexpr int BYTES = BARS + 8 + 1024;              // + alignment
  static_assert(BYTES <= 232448, "chunk pass: shared memory");
  static_assert(DerT::BYTES == XF::BYTES && 2 * DerT::BYTES == IMG_F,
                "derived tiles over X and the images");
};

// blocks: (batch, chunk, group of HG_F heads), groups innermost; two
// warpgroups. The scores C B^T once a block (its columns split between
// the warpgroups); then for each head in order: e_s = sum_p X[s][p]
// Z[s][p] from the state pass's dX term Z = etail o (B dS^T), which lands
// with the head's tiles; (C) warpgroup 0 forms dS^T X^T and dB^T +=
// etail o it, warpgroup 1 S0^T dY^T, its S0 terms and dC^T += ecum o it;
// (A) each warpgroup forms half the
// columns of dY X^T, then W, R2 and G2's sums, and writes W^T, R2 and R2^T
// hi | lo; (B) warpgroup 0 dB^T += C^T R2, warpgroup 1 dC^T += B^T R2^T,
// and each half the columns of dX^T = dY^T W, added to Z into dx. dB^T and
// dC^T sum over the block's heads and leave once a block to dbg / dcg (B,
// groups, T, N).
__device__ __forceinline__ void chunk_pass_f32(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ dy, const char* __restrict__ images,
    float* __restrict__ dx, float* __restrict__ da, float* __restrict__ dbg,
    float* __restrict__ dcg, int nh, int t_len, int p_dim, int n_dim, int ng,
    int vec_x, int vec_bc) {
  using C = ChunkCfgF;
  constexpr int THREADS = 2 * WG;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  char* const gsm = smem_raw + (sm - raw);

  const int nc = (t_len + QT - 1) / QT;
  const int g = blockIdx.x % ng, k = blockIdx.x / ng % nc;
  const long long bi = blockIdx.x / ng / nc;
  const int h0 = g * HG_F, hn = min(HG_F, nh - h0);
  const int t0 = k * QT, q = min(QT, t_len - t0);
  const long long row0 = bi * t_len + t0;
  const int wg = threadIdx.x / WG, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp % 4 * 16 + lane / 4;   // accumulator rows r0, r0 + 8
  const int c2 = 2 * (lane % 4);             // and columns c2, c2 + 1 of 8
  const uint32_t bar = sm + C::BARS;

  auto load_head = [&](int i) {
    const int hh = h0 + i;
    const long long xo = (row0 * nh + hh) * p_dim;
    load_tile<float, XF, PM, THREADS>(sm + C::XH, gsm + C::XH, x + xo,
                                      (long long)nh * p_dim, q, p_dim, vec_x);
    load_tile<float, XF, PM, THREADS>(sm + C::YH, gsm + C::YH, dy + xo,
                                      (long long)nh * p_dim, q, p_dim, vec_x);
    load_tile<float, XF, PM, THREADS>(sm + C::DXS, gsm + C::DXS, dx + xo,
                                      (long long)nh * p_dim, q, p_dim, vec_x);
    const char* im = images + ((bi * nh + hh) * nc + k) * 2LL * IMG_F;
    for (int j = threadIdx.x; j < 2 * IMG_F / 16; j += THREADS) {
      const int d = j / (IMG_F / 16), r = j % (IMG_F / 16) / 16;
      const int cb = j % 16 * 16;
      cp_async16(sm + (d ? C::DSI : C::S0I) + ImgF::offset(r, cb),
                 im + d * IMG_F + r * PM * 4 + cb, true);
    }
    load_a<THREADS>(sm + C::AR, a, row0, nh, hh, q);
    cp_async_arrive(bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  load_tile<float, RowF, NM, THREADS>(sm + C::CS, gsm + C::CS,
                                      c + row0 * n_dim, n_dim, q, n_dim,
                                      vec_bc);
  load_tile<float, RowF, NM, THREADS>(sm + C::BS, gsm + C::BS,
                                      b + row0 * n_dim, n_dim, q, n_dim,
                                      vec_bc);
  cp_async_arrive(bar);
  mbar_wait(bar, 0);
  __syncthreads();

  // the scores G = C B^T, columns [32 wg, 32 wg + 32) (rows t, columns s):
  // A = C split from registers, B = B's hi | lo
  float gacc[QT / 4];
  {
    for (int i = threadIdx.x; i < RowF::BYTES / 16; i += THREADS) {
      const float4 v = *reinterpret_cast<const float4*>(gsm + C::BS + 16 * i);
      uint32_t hv[4], lv[4];
      split4({v.x, v.y, v.z, v.w}, hv, lv);
      *reinterpret_cast<uint4*>(gsm + C::GBH + 16 * i) =
          make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(gsm + C::GBL + 16 * i) =
          make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    fence_proxy_async();
    __syncthreads();
    split_walk<NM / 8, 1>(
        [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          float v[4];
          frag_kmajor<RowF>(gsm + C::CS, r0, s, v);
          split4(v, hi, lo);
        },
        [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
          mma3<QT / 2>(gacc, hi[0], lo[0], kdesc<RowF>(sm + C::GBH, 32 * wg, s),
                       kdesc<RowF>(sm + C::GBL, 32 * wg, s), s > 0);
        });
    fence_regs(gacc);
    __syncthreads();                         // B's hi | lo are read
  }
  load_head(0);

  // dB^T (warpgroup 0) or dC^T (warpgroup 1): rows n = 64 w + r0 (+ 8),
  // columns s or t = 8 j + c2 (+ 1)
  float acc[2][QT / 2];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < QT / 2; ++i) acc[w][i] = 0.f;

  for (int i = 0; i < hn; ++i) {
    const int hh = h0 + i;
    float* const vcum = reinterpret_cast<float*>(gsm + C::VEC);
    float* const vecum = vcum + QT;
    float* const vetail = vecum + QT;
    float* const vev = vetail + QT;      // [QT]: e
    float* const vgp = vev + QT;         // [4][QT]: sum_n C o (S0^T dY^T)
    float* const vrowp = vgp + 4 * QT;   // [2][QT]: G2's row sums by half
    float* const vcolp = vrowp + 2 * QT; // [8][32]: G2's column sums
    float* const vdot = vcolp + 8 * 32;  // [8]: <dS, S0> by warp
    mbar_wait(bar, (i + 1) & 1);
    __syncthreads();                 // and the tiles' element-wise stores
    if (warp == 0)
      chunk_cum(reinterpret_cast<const float*>(gsm + C::AR), vcum, vecum,
                vetail, q);
    split_flat<THREADS>(gsm + C::XH, XF::BYTES, XF::BYTES);
    split_flat<THREADS>(gsm + C::YH, XF::BYTES, XF::BYTES);
    // <dS, S0> from the images (the same layout)
    {
      float dot = 0.f;
      for (int j = threadIdx.x; j < IMG_F / 16; j += THREADS) {
        const float4 u = reinterpret_cast<const float4*>(gsm + C::S0I)[j];
        const float4 v = reinterpret_cast<const float4*>(gsm + C::DSI)[j];
        dot = fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, fmaf(u.w, v.w,
                                                                dot))));
      }
      dot = lane_sum(dot);
      if (lane == 0) vdot[warp] = dot;
    }
    // e_s = etail_s b_s . (X dS)_s = sum_p X[s][p] Z[s][p], Z the state
    // pass's dX term etail o (B dS^T): a row's quarter a thread, X as hi +
    // lo (rows past the chunk are 0 in both)
    {
      const int r = threadIdx.x / 4, p0 = threadIdx.x % 4 * (PM / 4);
      float e = 0.f;
#pragma unroll
      for (int u = 0; u < PM / 4; ++u) {
        const uint32_t off = XF::offset(r, 4 * (p0 + u));
        const float xv = *reinterpret_cast<const float*>(gsm + C::XH + off) +
                         *reinterpret_cast<const float*>(gsm + C::XL + off);
        e = fmaf(xv, *reinterpret_cast<const float*>(gsm + C::DXS + off), e);
      }
      e = quad_sum(e);
      if (threadIdx.x % 4 == 0) vev[r] = e;
    }
    fence_proxy_async();
    __syncthreads();                 // the split tiles and the vectors

    // (C) warpgroup 0: dS^T X^T (rows n, columns s), into dB^T scaled by
    // etail; warpgroup 1: S0^T dY^T (rows n, columns t), into dC^T scaled
    // by ecum, and the S0 term's partial sums over this warp's n of C o
    // it. K = p, A = the image's rows split; one M tile of 64 n at a time.
    // (Element (col, n) of C at RowF::offset(col, 4 n): col & 7 = c2 + e1
    // and n / 32 = 2 w + r0 / 32, so four bases and constants.)
    {
      const char* img = gsm + (wg ? C::S0I : C::DSI);
      const uint32_t bo = sm + (wg ? C::YH : C::XH);
      const uint64_t bh = kbase<XF>(bo), bl = kbase<XF>(bo + XF::BYTES);
      const float* sc = wg ? vecum : vetail;
      float gs[QT / 8][2] = {};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        float pc[QT / 2];
        split_walk<PM / 8, 1>(
            [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
              float v[4];
              frag_kmajor<ImgF>(img, 64 * w + r0, s, v);
              split4(v, hi, lo);
            },
            [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
              mma3<QT>(pc, hi[0], lo[0], kstep<XF>(bh, 0, s),
                       kstep<XF>(bl, 0, s), s > 0);
            });
        fence_regs(pc);
        if (wg) {
#pragma unroll
          for (int j = 0; j < QT / 8; ++j)
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
                gs[j][e1] = fmaf(
                    *reinterpret_cast<const float*>(
                        gsm + C::CS + (2 * w + r0 / 32) * RowF::PANEL +
                        128 * (c2 + e1) + 1024 * j +
                        ((4 * (r0 + 8 * hf) % 128) ^ ((c2 + e1) << 4))),
                    pc[4 * j + 2 * hf + e1], gs[j][e1]);
        }
#pragma unroll
        for (int j = 0; j < QT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[w][4 * j + e] =
                fmaf(pc[4 * j + e], sc[8 * j + c2 + (e & 1)],
                     acc[w][4 * j + e]);
      }
      if (wg) {
#pragma unroll
        for (int j = 0; j < QT / 8; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            float sum = gs[j][e1];
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            sum += __shfl_xor_sync(0xffffffffu, sum, 8);
            sum += __shfl_xor_sync(0xffffffffu, sum, 16);
            if (lane < 4) vgp[warp % 4 * QT + 8 * j + c2 + e1] = sum;
          }
      }
    }

    // (A) D = dY X^T, columns [32 wg, 32 wg + 32) (rows t, columns s);
    // W = L o G, R2 = L o D, G2 = W o D, L = exp2(cum_t - cum_s) for s <= t
    float wv[QT / 4], rv[QT / 4];
    {
      float dacc[QT / 4];
      const uint64_t ah0 = kbase<XF>(sm + C::YH), al0 = kbase<XF>(sm + C::YL);
      const uint64_t bh0 = kbase<XF>(sm + C::XH), bl0 = kbase<XF>(sm + C::XL);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < PM / 8; ++s) {
        const uint64_t ah = kstep<XF>(ah0, 0, s);
        const uint64_t al = kstep<XF>(al0, 0, s);
        const uint64_t bh = kstep<XF>(bh0, 32 * wg, s);
        const uint64_t bl = kstep<XF>(bl0, 32 * wg, s);
        Wgmma<QT / 2>::ss_tf32(dacc, al, bh, s > 0);
        Wgmma<QT / 2>::ss_tf32(dacc, ah, bl, 1);
        Wgmma<QT / 2>::ss_tf32(dacc, ah, bh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dacc);
      float rs[2] = {0.f, 0.f}, cs[QT / 16][2] = {};
#pragma unroll
      for (int j = 0; j < QT / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = r0 + 8 * (e >> 1), s = 32 * wg + 8 * j + c2 + (e & 1);
          const float l = s <= t ? exp2f(vcum[t] - vcum[s]) : 0.f;
          const float w = gacc[4 * j + e] * l, g2 = w * dacc[4 * j + e];
          wv[4 * j + e] = w;
          rv[4 * j + e] = dacc[4 * j + e] * l;
          rs[e >> 1] += g2;
          cs[j][e & 1] += g2;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float v = quad_sum(rs[hf]);
        if (lane % 4 == 0) vrowp[wg * QT + r0 + 8 * hf] = v;
      }
#pragma unroll
      for (int j = 0; j < QT / 16; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          float v = cs[j][e1];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) vcolp[warp * 32 + 8 * j + c2 + e1] = v;
        }
    }
    __syncthreads();                 // X and the images are read
    // W^T (rows s, t along), R2 (rows t, s along), R2^T, hi | lo
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + 8 * (e >> 1), s = 32 * wg + 8 * j + c2 + (e & 1);
        put_split(gsm + C::WTH, gsm + C::WTL, DerT::offset(s, 4 * t),
                  wv[4 * j + e]);
        put_split(gsm + C::R2H, gsm + C::R2L, DerT::offset(t, 4 * s),
                  rv[4 * j + e]);
        put_split(gsm + C::RTH, gsm + C::RTL, DerT::offset(s, 4 * t),
                  rv[4 * j + e]);
      }
    fence_proxy_async();
    __syncthreads();                 // the derived tiles

    // (B) warpgroup 0: C^T R2 (rows n, columns s, K = t); warpgroup 1: B^T
    // R2^T (rows n, columns t, K = s); A = C^T or B^T split from registers,
    // one M tile of 64 n at a time, into dB^T or dC^T
    {
      const char* m = gsm + (wg ? C::BS : C::CS);
      const uint32_t bo = sm + (wg ? C::R2H : C::RTH);
      const uint64_t bh = kbase<DerT>(bo), bl = kbase<DerT>(bo + DerT::BYTES);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        split_walk<QT / 8, 1>(
            [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
              float v[4];
              frag_mn<RowF>(m, 64 * w + r0, s, v);
              split4(v, hi, lo);
            },
            [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
              mma3<QT>(acc[w], hi[0], lo[0], kstep<DerT>(bh, 0, s),
                       kstep<DerT>(bl, 0, s), true);
            });
        fence_regs(acc[w]);
      }
    }
    // dX^T = dY^T W, columns [32 wg, 32 wg + 32) (rows p, columns s, K =
    // t): A = dY^T from dY's hi and lo tiles, B = W^T's rows
    float xacc[QT / 4];
    const uint64_t wh = kbase<DerT>(sm + C::WTH), wl = kbase<DerT>(sm + C::WTL);
    split_walk<QT / 8, 1>(
        [&](int s, int, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          float v[4], u[4];
          frag_mn<XF>(gsm + C::YH, r0, s, v);
          frag_mn<XF>(gsm + C::YL, r0, s, u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = __float_as_uint(v[e]);
            lo[e] = __float_as_uint(u[e]);
          }
        },
        [&](int s, uint32_t (&hi)[1][4], uint32_t (&lo)[1][4]) {
          mma3<QT / 2>(xacc, hi[0], lo[0], kstep<DerT>(wh, 32 * wg, s),
                       kstep<DerT>(wl, 32 * wg, s), s > 0);
        });
    fence_regs(xacc);

    // dx = the state pass's term + dX^T: rows p = r0 (+ 8), columns s = 32
    // wg + 8 j + c2 (+ 1)
#pragma unroll
    for (int j = 0; j < QT / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = r0 + 8 * (e >> 1), s = 32 * wg + 8 * j + c2 + (e & 1);
        if (s < q && p < p_dim)
          dx[((row0 + s) * nh + hh) * p_dim + p] =
              *reinterpret_cast<const float*>(gsm + C::DXS +
                                              XF::offset(s, 4 * p)) +
              xacc[4 * j + e];
      }

    __syncthreads();                 // every tile of this head is read
    if (i + 1 < hn) load_head(i + 1);

    // da of this head: g's suffix sums inside the chunk, by warp 0 (two
    // steps a lane), every sum in one order
    if (warp == 0) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) dot += vdot[w];
      float gv[2], ev[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = 2 * lane + u;
        float s0t = 0.f, col = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          s0t += vgp[w * QT + s];
          col += vcolp[(s / 32 * 4 + w) * 32 + s % 32];
        }
        ev[u] = s < q ? vev[s] : 0.f;
        gv[u] = s < q ? vrowp[s] + vrowp[QT + s] - col + vecum[s] * s0t - ev[u]
                      : 0.f;
      }
      const float tail = lane_sum(ev[0] + ev[1]) + vecum[q - 1] * dot;
      if (2 * lane == q - 1) gv[0] += tail;
      if (2 * lane + 1 == q - 1) gv[1] += tail;
      float suf = gv[0] + gv[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += o;
      }
      if (2 * lane < q) da[(row0 + 2 * lane) * nh + hh] = suf;
      if (2 * lane + 1 < q) da[(row0 + 2 * lane + 1) * nh + hh] = suf - gv[0];
    }
  }

  // dB^T (warpgroup 0) or dC^T (warpgroup 1) of the group's heads
  float* out = (wg ? dcg : dbg) + (((long long)bi * ng + g) * t_len + t0) *
                                      n_dim;
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int j = 0; j < QT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * w + r0 + 8 * (e >> 1), s = 8 * j + c2 + (e & 1);
        if (s < q && n < n_dim)
          out[(long long)s * n_dim + n] = acc[w][4 * j + e];
      }
}

// the kernels: the bf16 passes above or the float32 ones, by type
template <typename T>
__global__ void __launch_bounds__(std::is_same<T, float>::value ? 2 * WG : WG,
                                  std::is_same<T, float>::value ? 1 : 3)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy,
                     const float* __restrict__ dstate,
                     const float* __restrict__ state0,
                     float* __restrict__ ds0, char* __restrict__ images,
                     T* __restrict__ dx, int nh, int t_len, int p_dim,
                     int n_dim, int nps, int vec_x, int vec_bc) {
  if constexpr (std::is_same<T, float>::value)
    state_pass_f32(x, a, b, c, dy, dstate, state0, ds0, images, dx, nh,
                   t_len, p_dim, n_dim, vec_x, vec_bc);
  else
    state_pass<T>(x, a, b, c, dy, dstate, state0, ds0, images, nh, t_len,
                  p_dim, n_dim, nps, vec_x, vec_bc);
}

template <typename T>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy,
                     const char* __restrict__ images, T* __restrict__ dx,
                     float* __restrict__ da, float* __restrict__ dbg,
                     float* __restrict__ dcg, int nh, int t_len, int p_dim,
                     int n_dim, int ng, int vec_x, int vec_bc) {
  if constexpr (std::is_same<T, float>::value)
    chunk_pass_f32(x, a, b, c, dy, images, dx, da, dbg, dcg, nh, t_len,
                   p_dim, n_dim, ng, vec_x, vec_bc);
  else
    chunk_pass<T>(x, a, b, c, dy, images, dx, da, dbg, dcg, nh, t_len,
                  p_dim, n_dim, ng, vec_x, vec_bc);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the state pass, the chunk pass, the sum over the head groups
template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const void* dstate, const void* state0, void* dx,
           void* da, void* db, void* dc, void* ds0, void* images, void* dbg,
           void* dcg, int bsz, int h, int t_len, int p, int n,
           void* stream) {
  if (bsz < 1 || h < 1 || t_len < 1 || p < 1 || p > PM || n < 1 || n > NM ||
      (long long)bsz * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int SB = F32 ? StateCfgF::BYTES : StateCfg::BYTES;
  constexpr int CB = F32 ? ChunkCfgF::BYTES : ChunkCfg::BYTES;
  constexpr int hg = F32 ? HG_F : HG;
  auto state = ssd_bwd_state_kernel<T>;
  auto chunk = ssd_bwd_chunk_kernel<T>;
  static const int err_s = ftile::allow_smem(state, SB);
  static const int err_c = ftile::allow_smem(chunk, CB);
  if (err_s) return err_s;
  if (err_c) return err_c;
  const auto* tx = static_cast<const T*>(x);
  const auto* tb = static_cast<const T*>(b);
  const auto* tc = static_cast<const T*>(c);
  const auto* tdy = static_cast<const T*>(dy);
  const auto* fa = static_cast<const float*>(a);
  auto* tdx = static_cast<T*>(dx);
  auto* fdbg = static_cast<float*>(dbg);
  auto* fdcg = static_cast<float*>(dcg);
  auto* img = static_cast<char*>(images);
  auto st = static_cast<cudaStream_t>(stream);
  // float32 state blocks cover all of P, bf16's a slice of PB columns
  const int nc = (t_len + QT - 1) / QT, nps = F32 ? 1 : (p + PB - 1) / PB;
  const int ng = (h + hg - 1) / hg;
  const int e = sizeof(T);
  const int vec_x = (p * e) % 16 == 0 && aligned16(x) && aligned16(dy) &&
                    aligned16(dx);
  const int vec_bc = (n * e) % 16 == 0 && aligned16(b) && aligned16(c);
  state<<<2 * bsz * h * nps, F32 ? StateCfgF::THREADS : WG, SB, st>>>(
      tx, fa, tb, tc, tdy, static_cast<const float*>(dstate),
      static_cast<const float*>(state0), static_cast<float*>(ds0), img, tdx,
      h, t_len, p, n, nps, vec_x, vec_bc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk<<<bsz * nc * ng, 2 * WG, CB, st>>>(
      tx, fa, tb, tc, tdy, img, tdx, static_cast<float*>(da), fdbg, fdcg, h,
      t_len, p, n, ng, vec_x, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)bsz * t_len * n;
  ssd_bwd_sum_kernel<T><<<static_cast<int>((total + 255) / 256), 256, 0,
                          st>>>(fdbg, fdcg, static_cast<T*>(db),
                                static_cast<T*>(dc), ng, t_len, n, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SSD_BWD_ARGS                                                       \
  const void *x, const void *a, const void *b, const void *c,             \
      const void *dy, const void *dstate, const void *state0, void *dx,   \
      void *da, void *db, void *dc, void *ds0, void *states, void *dbh,   \
      void *dch, int bsz, int h, int t_len, int p, int n, void *stream

extern "C" int ssd_bwd_f32(SSD_BWD_ARGS) {
  return launch<float>(x, a, b, c, dy, dstate, state0, dx, da, db, dc, ds0,
                       states, dbh, dch, bsz, h, t_len, p, n, stream);
}

extern "C" int ssd_bwd_bf16(SSD_BWD_ARGS) {
  return launch<__nv_bfloat16>(x, a, b, c, dy, dstate, state0, dx, da, db,
                               dc, ds0, states, dbh, dch, bsz, h, t_len, p,
                               n, stream);
}
