// flash_attn backward: the gradients of o = softmax(q k^T * scale) v with
// respect to q, k and v, given do, for q (BH, Sq, DH), k / v
// (BH / group, Skv, DH) and the forward's o; DH in {16, 32, 64, 128,
// 256}, bidirectional or causal (Sq == Skv), a causal window w > 0 also
// masking keys j <= i - w, or a causal prefix P > 0 keeping every key
// j < P (the VLM's image tokens). float32 or bfloat16 in and out, float32
// sums, every pass on the tensor cores (below; Dh 256 splits its dk/dv
// pass in two and, in float32, splits the row side's tf32 fragments in
// registers: the Dh-256 section at the end says why).
//
// Replaces no Pallas kernel: the JAX package has no backward kernel (no
// custom_vjp under src/repro/kernels/), and its training differentiates
// plain jnp attention by autodiff. The port's training path on the card
// runs the forward through the flash_attn kernel, whose output has no
// autograd graph, so its gradient needs a kernel of its own (the wrapper
// wraps both in a torch.autograd.Function).
//
// Bound on the H100 (`flash_attn.bwd_work`): operations. Five products of
// Sq x Skv x DH multiply-adds over the kept pairs (S, dP, dq, dk, dv); in
// float32 at 3xTF32's 495 / 3 = 165 TFLOP/s (three tf32 products for each
// float32 one), in bf16 at 989. M_g's finetune, (96, 512, 64) float32
// bidirectional, does 16.1 GFLOP: 0.0976 ms; it reads and writes 25 MB
// (7.5 us at 3.35 TB/s). This kernel does seven products, not five: S and
// dP once in each pass.
//
// Design: FlashAttention-2's backward on Hopper's tensor cores (`wgmma`,
// wgmma_ops.cuh; tiles and descriptors from hopper_tile.cuh, as the
// forward in flash_attn.cu), no S x S tensor in memory, in two launches,
// neither with atomics:
// - fa_bwd_dq_kernel: a block of two warpgroups, each owning 64 query rows
//   (Q and dO resident in shared memory), walks the key tiles once. D =
//   rowsum(do * o) comes first, from device memory. Each key tile: S = Q
//   K^T and dP = dO V^T (both operands K-major over DH), then, on S's
//   accumulator fragments, the online row max m and sum l (as the
//   forward's), P~ = exp2(S * scale * log2 e - m) and dS~ = P~ * (dP - D),
//   dq~ rescaled by the change of m and dq~ += dS~ K with dS~ in registers
//   as the A operand. At the end dq = dq~ * scale / l, and each row's
//   lse = m + log2 l (base 2) and D are written for the second launch. One
//   walk, not two: S is formed once in this pass, not again for the lse.
// - fa_bwd_dkdv_kernel: a block of two warpgroups, each owning 64 keys (K
//   and V resident), walks the group's q heads, and each one's query
//   tiles, in order: S^T = K Q^T and dP^T = V dO^T, so that P^T = exp2(S^T
//   * scale * log2 e - lse) and dS^T = P^T * (dP^T - D) come out in the
//   accumulator layout that is the A operand's, then dv += P^T dO and dk
//   += dS^T Q. dk and dv sum over a kv head's group in a fixed order, so a
//   second launch is bitwise equal.
// - bf16: the S products are bf16 (ss, K-major); P^T, dS^T and dS~ are
//   rounded to bf16 in registers, and the B operands of the products that
//   contract over keys or queries are the same tiles read MN-major (the
//   transpose bit), as the forward's P V.
// - float32 (3xTF32): every operand x splits into hi = tf32(x) and lo =
//   tf32(x - hi) and a product is lo hi + hi lo + hi hi (the forward's
//   scheme). tf32 `wgmma` takes K-major operands only, so the B operands
//   that contract over keys or queries are transposed copies (K^T in the
//   dq pass, Q^T and dO^T in the dk/dv pass), written by the split from
//   the landed tile, hi and lo, with the columns permuted within groups
//   of 8 (element 2c at column c, 2c + 1 at c + 4): the tf32 A fragment
//   holds columns (c, c + 4) where the accumulator holds (2c, 2c + 1), so
//   the product sums over the same pairs.
// - P agrees between the passes: both form S from the same split and the
//   same three tf32 products of the same values in the same k-order (dq:
//   Q lo K hi, Q hi K lo, Q hi K hi; dk/dv: K hi Q lo, K lo Q hi, K hi Q
//   hi), then one unfused product by scale * log2 e (__fmul_rn). The dq
//   pass normalises by l at the end where the dk/dv pass subtracts the
//   lse, so its P differs from the other's by rounding only.
// - float32 sums: the tensor cores' accumulation loses accuracy over long
//   chains, so at Dh <= 64 each step's dq, dk and dv products start a
//   fresh accumulator, which the next step's wait completes and adds to
//   the float32 sum in registers (STEP_SUM). Against float64 at M_g's
//   case, with every step chained into one accumulator (up to 192 tf32
//   products) the gradients' RMS error was 4.3e-6 of their RMS, with
//   per-step sums 1.3e-6, the plain float32 version's 0.57e-6
//   (tools/flash_attn_bwd_ab.py's case, NVIDIA H100 80GB HBM3 at 700 W);
//   adding the dropped lo lo product changed nothing. Three Adam steps
//   amplify that error near Adam's eps: chip_smoke.py's phase 8c gate.
// - Column tiles land by `cp.async` on an mbarrier (as the forward's). In
//   bf16 they stream through two stages: step i waits for the products of
//   step i - 1, then loads tile i + 1 into the stage those read. In
//   float32 one stage fits beside the resident tiles and the transposed
//   copies: its tiles are read only by the S and dP products, so tile i +
//   1 is loaded as soon as those end in every warpgroup and lands under
//   step i's softmax and register-A products; the split of tile i + 1
//   waits for those products, which read the copies it overwrites.
// - Wholly masked tiles are skipped: the dq pass ends at its last row's
//   diagonal (or at the prefix, where that lies further) and starts at
//   the first row's window; the dk/dv pass starts at its first key's
//   diagonal (at query 0 if its block holds a key of the prefix) and
//   ends at the last query whose window holds its last key. A tile
//   wholly inside the prefix is kept whole, as one below the diagonal.
//   Masked scores are -inf before the exp (P = 0).
//   Rows past S are zero-filled by the copies, masked (columns) and never
//   stored (rows).
// Shared memory at float32 Dh 64: the dq pass 224 KB (Q, dO and their lo
// halves for 128 rows 128 KB; 64 keys of K, V and their lo halves 64 KB;
// K^T and its lo half 32 KB), the dk/dv pass 193 KB (K, V and lo halves
// for 128 keys 128 KB; 32 queries of Q, dO, lo halves, lse and D 33 KB;
// Q^T, dO^T and lo halves 32 KB). One warpgroup a block at float32 Dh
// 128, and column tiles halved there, for the same reason.
// What holds it back (tools/flash_attn_bwd_ab.py, NVIDIA H100 80GB HBM3 at
// 700 W, M_g's case float32: 0.42 ms, 23 % of the bound): each step is a
// chain of the split, the S and dP products, the softmax and the register
// products, with two warpgroups to overlap it; removing any one of them
// saves 7-23 %, none dominates (PERF.md). Later work: a producer warp
// that loads and splits while ping-ponged consumers compute.
#include <type_traits>

#include "float_tile.cuh"
#include "hopper_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;

// Tiles (tests/test_torch_flash_bwd_tiles.py reads these lines): ROWS rows
// a warpgroup owns (one wgmma M: queries in the dq pass, keys in the dk/dv
// pass); *_BN the column tile a step walks (keys in the dq pass, queries
// in the dk/dv pass), halved at Dh 128, *_F32_256 float32's at Dh 256;
// *_NWG warpgroups a block, 1 at float32 Dh 128 (float32 Dh 256: two that
// share a block's 64 rows, Cfg::NRT).
constexpr int ROWS = 64;
constexpr int DQ_BN_BF16 = 64;
constexpr int DQ_BN_F32 = 64;
constexpr int DKDV_BN_BF16 = 64;
constexpr int DKDV_BN_F32 = 32;
constexpr int DQ_BN_F32_256 = 16;
constexpr int DKDV_BN_F32_256 = 16;
constexpr int DQ_NWG = 2;
constexpr int DKDV_NWG = 2;
constexpr int WG = 128;          // threads of a warpgroup

template <typename T, int DH, bool DQ>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int E = sizeof(T);
  static constexpr bool BIG = F32 && DH >= 128;
  // bf16 Dh 256's dq pass: one warpgroup a block and whole column tiles
  // (Q and dO 64 KB, two stages of K and V at 64 keys 128 KB): twice the
  // blocks of two warpgroups, half the steps of 32-key tiles
  static constexpr bool DQ256 = DQ && !F32 && DH == 256;
  // float32 Dh 256: the row side stays raw float32 and each k-step's A
  // fragment is split hi + lo in registers; two warpgroups share a
  // block's 64 rows, each forming S and dP over half of Dh and owning half
  // the columns of dq, dk or dv (the Dh-256 section says why)
  static constexpr bool RSPLIT = F32 && DH == 256;
  static constexpr int NWG =
      RSPLIT ? 2 : BIG || DQ256 ? 1 : DQ ? DQ_NWG : DKDV_NWG;
  static constexpr int NRT = RSPLIT ? 1 : NWG;     // 64-row tiles a block
  static constexpr int DC = RSPLIT ? DH / 2 : DH;  // columns a warpgroup owns
  static constexpr int BN =
      RSPLIT ? (DQ ? DQ_BN_F32_256 : DKDV_BN_F32_256)
             : (DQ ? (F32 ? DQ_BN_F32 : DQ_BN_BF16)
                   : (F32 ? DKDV_BN_F32 : DKDV_BN_BF16)) /
                   (DH >= 128 && !DQ256 ? 2 : 1);
  static constexpr int THREADS = WG * NWG;
  static constexpr int KS = 32 / E;          // elements a k-step: 32 B
  // float32: each step's register-A products into a fresh accumulator,
  // added to the running sum on the CUDA cores (where registers allow)
  static constexpr bool STEP_SUM = F32 && DH <= 64;
  // float32 transposed copies: K^T (dq); Q^T and dO^T (dk/dv), or at Dh
  // 256 the one its pass reads (Q^T for dk, dO^T for dv)
  static constexpr int NTR = DQ || RSPLIT ? 1 : 2;
  using RT = Tile<ROWS, DH * E>;   // row side: dq Q, dO; dk/dv K, V
  using CT = Tile<BN, DH * E>;     // column side: dq K, V; dk/dv Q, dO
  using TT = Tile<DH, BN * 4>;     // float32 column side transposed
  static constexpr int R_B = align1024(RT::BYTES);
  static constexpr int C_B = align1024(CT::BYTES);
  static constexpr int T_B = align1024(TT::BYTES);
  // row side: A1 x NRT | A2 x NRT | [their lo halves, A_LO further; not
  // at Dh 256]
  static constexpr int A1 = 0, A2 = NRT * R_B, A_LO = 2 * NRT * R_B;
  static constexpr int ST0 = F32 && !RSPLIT ? 2 * A_LO : A_LO;
  // a tile stage: B1 | B2 | [B1 lo | B2 lo] | (lse, D in two halves), B_i
  // lo 2 C_B past B_i; NB of them: two in bf16, whose register-A products
  // read the tiles, one in float32, whose products read the transposed
  // copies at TQ (K^T or Q^T) and TO (dO^T), each with its lo T_B further
  static constexpr int B1 = 0, B2 = C_B, LD = (F32 ? 4 : 2) * C_B;
  static constexpr int STAGE = align1024(LD + (DQ ? 0 : 16 * BN));
  static constexpr int NB = F32 ? 1 : 2;
  static constexpr int C0 = ST0 + NB * STAGE;
  static constexpr int TQ = C0, TO = C0 + (NTR == 2 ? 2 * T_B : 0);
  static constexpr int BARS = C0 + (F32 ? 2 * NTR * T_B : 0);
  static constexpr int BYTES = BARS + 8 * NB + 1024;       // + alignment
  static_assert(BYTES <= 232448, "tiles do not fit in shared memory");
  static_assert(BN % 16 == 0 || (F32 && BN % 8 == 0), "bad column tile");
};

// the position of column `j` in a float32 transposed row: 2c and 2c + 1
// of each group of 8 at c and c + 4 (the tf32 A fragment's)
__device__ __forceinline__ int vt_col(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// NR rows of DH elements from row r0 of x (nrows rows) into a tile; rows
// past the end are zero-filled
template <typename T, int DH, typename TL, int NR, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* x, int r0,
                                          int nrows) {
  constexpr int CH = DH * (int)sizeof(T) / 16;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < NR * CH; i += THREADS) {
    const int r = i / CH, cb = (i % CH) * 16;
    const bool ok = r0 + r < nrows;
    const char* src = reinterpret_cast<const char*>(
                          x + (ok ? (long long)(r0 + r) * DH : 0)) + cb;
    cp_async16(dst + TL::offset(r, cb), src, ok);
  }
}

// float32: a landed column tile at `x` (NR rows of DH) -> hi in place, lo
// `lo` bytes further, and both transposed into the tiles at `t` and `t +
// t_lo` (row d, column vt_col(r)). A warp takes 32 rows of one 16-byte
// chunk, so the transposed stores of a warp fill one row's 32 banks.
template <int NR, int DH, int THREADS>
__device__ __forceinline__ void split_transpose(char* x, int lo, char* t,
                                                int t_lo) {
  using XT = Tile<NR, DH * 4>;
  using TT = Tile<DH, NR * 4>;
  for (int i = threadIdx.x; i < NR * DH / 4; i += THREADS) {
    const int r = i % NR, d = i / NR * 4;
    const uint32_t off = XT::offset(r, d * 4);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    const float h[4] = {tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w)};
    const float l[4] = {tf32(v.x - h[0]), tf32(v.y - h[1]), tf32(v.z - h[2]),
                        tf32(v.w - h[3])};
    *reinterpret_cast<float4*>(x + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(x + lo + off) =
        make_float4(l[0], l[1], l[2], l[3]);
    const int cb = vt_col(r) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t to = TT::offset(d + e, cb);
      *reinterpret_cast<float*>(t + to) = h[e];
      *reinterpret_cast<float*>(t + t_lo + to) = l[e];
    }
  }
}

// X = A B^T over DH, for the row tile at `a` and the column tile at `b`
// (K-major both; N = BN columns). float32 issues the three tf32 products
// in the order of their values, which the two passes share: Q lo K hi, Q
// hi K lo, Q hi K hi in the dq pass (A = Q), and from the other side in
// the dk/dv pass (A = K): K hi Q lo, K lo Q hi, K hi Q hi.
template <typename C, int DH, bool DQ>
__device__ __forceinline__ void issue_ss(float (&x)[C::BN / 2], uint32_t a,
                                         uint32_t b) {
  constexpr int WA = C::RT::W, WB = C::CT::W;
#pragma unroll
  for (int kk = 0; kk < DH / C::KS; ++kk) {
    const int cb = kk * 32;
    const uint64_t da = desc(a + C::RT::start(0, cb), 16, 8 * WA, WA);
    const uint64_t db = desc(b + C::CT::start(0, cb), 16, 8 * WB, WB);
    if constexpr (C::F32) {
      const uint64_t dal = desc(a + C::A_LO + C::RT::start(0, cb), 16,
                                8 * WA, WA);
      const uint64_t dbl = desc(b + 2 * C::C_B + C::CT::start(0, cb), 16,
                                8 * WB, WB);
      if constexpr (DQ) {
        Wgmma<C::BN>::ss_tf32(x, dal, db, kk > 0);
        Wgmma<C::BN>::ss_tf32(x, da, dbl, 1);
      } else {
        Wgmma<C::BN>::ss_tf32(x, da, dbl, kk > 0);
        Wgmma<C::BN>::ss_tf32(x, dal, db, 1);
      }
      Wgmma<C::BN>::ss_tf32(x, da, db, 1);
    } else {
      Wgmma<C::BN>::ss_bf16(x, da, db, kk > 0);
    }
  }
}

// float32 Dh 256: X = A B^T (and Y = A2 B2^T, if TWO) over this
// warpgroup's half of DH (exchange() adds the other's), A the raw float32
// row tile at `a` (RT's swizzled layout): each k-step's tf32 A fragment
// is split hi + lo in registers (split_walk), B's hi and lo tiles at `b`
// and 2 C_B further. The three products of issue_ss's order go to three
// accumulators, summed as (lo hi + hi lo) + hi hi at the end: a chain of
// 16 dependent products each, where one accumulator would chain 48 and
// wait on the tensor cores' latency. The fragment loads find 32 banks
// (frag_kmajor).
template <typename C, int DH, bool DQ, bool TWO>
__device__ __forceinline__ void issue_split(float (&x)[C::BN / 2],
                                            float (&y)[TWO ? C::BN / 2 : 1],
                                            const char* a, const char* a2,
                                            uint32_t b, uint32_t b2) {
  constexpr int WB = C::CT::W, NA = TWO ? 2 : 1, N2 = C::BN / 2;
  constexpr int KSW = DH / 8 / C::NWG;           // this warpgroup's k-steps
  const int fm = threadIdx.x % WG / 32 * 16 + threadIdx.x % 32 / 4;
  const int s0 = threadIdx.x / WG * KSW;
  float part[NA][3][N2];
  auto load = [&](int s, int i, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    float v[4];
    frag_kmajor<typename C::RT>(i ? a2 : a, fm, s0 + s, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
  };
  auto one = [&](float (&p)[3][N2], uint32_t (&hi)[4], uint32_t (&lo)[4],
                 uint32_t bt, int s) {
    const uint64_t db =
        desc(bt + C::CT::start(0, 32 * (s0 + s)), 16, 8 * WB, WB);
    const uint64_t dbl = desc(bt + 2 * C::C_B + C::CT::start(0, 32 * (s0 + s)),
                              16, 8 * WB, WB);
    // (A lo, B hi), (A hi, B lo), (A hi, B hi): the dk/dv pass issues K hi
    // Q lo and K lo Q hi, the same values as the dq pass's Q lo K hi and Q
    // hi K lo
    if constexpr (DQ) {
      Wgmma<C::BN>::rs_tf32(p[0], lo, db, s > 0);
      Wgmma<C::BN>::rs_tf32(p[1], hi, dbl, s > 0);
    } else {
      Wgmma<C::BN>::rs_tf32(p[0], hi, dbl, s > 0);
      Wgmma<C::BN>::rs_tf32(p[1], lo, db, s > 0);
    }
    Wgmma<C::BN>::rs_tf32(p[2], hi, db, s > 0);
  };
  split_walk<KSW, NA>(
      load, [&](int s, uint32_t (&hi)[NA][4], uint32_t (&lo)[NA][4]) {
        one(part[0], hi[0], lo[0], b, s);
        if constexpr (TWO) one(part[NA - 1], hi[NA - 1], lo[NA - 1], b2, s);
      });
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) fence_regs(part[i][j]);
#pragma unroll
  for (int i = 0; i < N2; ++i) x[i] = (part[0][0][i] + part[0][1][i]) +
                                      part[0][2][i];
  if constexpr (TWO) {
#pragma unroll
    for (int i = 0; i < N2; ++i)
      y[i] = (part[NA - 1][0][i] + part[NA - 1][1][i]) + part[NA - 1][2][i];
  }
}

// float32 Dh 256: each warpgroup's S and dP (or S^T and dP^T) over its
// half of Dh, summed with the other's through shared memory at `buf` (a
// stage tile no product reads any more; 16 bytes a thread a row of the
// exchange, so a warp's stores fill 32 banks), warpgroup 0's half first
// in both, so the two hold the same sums. Ends with `buf` read.
template <int N2, bool TWO>
__device__ __forceinline__ void exchange(float (&x)[N2],
                                         float (&y)[TWO ? N2 : 1],
                                         char* buf) {
  static_assert(N2 % 4 == 0, "whole float4s");
  constexpr int NV = N2 / 4, NT = 2 * WG;
  float4* v = reinterpret_cast<float4*>(buf);
  const int me = threadIdx.x, other = threadIdx.x ^ WG;
  __syncthreads();                   // every warpgroup's products are done
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i * NT + me] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2],
                                 x[4 * i + 3]);
    if constexpr (TWO)
      v[(NV + i) * NT + me] = make_float4(y[4 * i], y[4 * i + 1],
                                          y[4 * i + 2], y[4 * i + 3]);
  }
  __syncthreads();
  const bool first = threadIdx.x < WG;
  auto add = [&](float& a, float b) { a = first ? a + b : b + a; };
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 u = v[i * NT + other];
    add(x[4 * i], u.x);
    add(x[4 * i + 1], u.y);
    add(x[4 * i + 2], u.z);
    add(x[4 * i + 3], u.w);
    if constexpr (TWO) {
      const float4 w = v[(NV + i) * NT + other];
      add(y[4 * i], w.x);
      add(y[4 * i + 1], w.y);
      add(y[4 * i + 2], w.z);
      add(y[4 * i + 3], w.w);
    }
  }
}

// an accumulator tile (64 x BN) as wgmma A fragments: bf16 hi only (a
// k-step of 16 columns is n-blocks 2t, 2t + 1, whose accumulator pairs are
// the fragment's); float32 hi and lo (a k-step of 8 columns is n-block t:
// columns 2c, 2c + 1 stand for the fragment's c, c + 4, as the transposed
// copies are stored)
template <typename C>
struct Frag {
  static constexpr int NK = C::F32 ? C::BN / 8 : C::BN / 16;
  uint32_t hi[NK][4];
  uint32_t lo[C::F32 ? NK : 1][4];

  __device__ __forceinline__ void pack(const float (&p)[C::BN / 2]) {
#pragma unroll
    for (int t = 0; t < NK; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (C::F32) {
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
    for (int t = 0; t < NK; ++t) fence_regs(hi[t]);
    if constexpr (C::F32) {
#pragma unroll
      for (int t = 0; t < NK; ++t) fence_regs(lo[t]);
    }
  }
};

// acc += F B over the BN columns, B the column tile at `b` (bf16, read
// MN-major: its rows are the k) or its transposed copy at `t` (float32,
// K-major, lo T_B further): lo hi + hi lo + hi hi
template <typename C, int DH>
__device__ __forceinline__ void issue_rs(float (&acc)[C::DC / 2], Frag<C>& f,
                                         uint32_t b, uint32_t t) {
#pragma unroll
  for (int s = 0; s < Frag<C>::NK; ++s) {
    if constexpr (C::F32) {
      constexpr int WT = C::TT::W;
      const int cb = s * 32;
      const uint64_t dt = desc(t + C::TT::start(0, cb), 16, 8 * WT, WT);
      const uint64_t dtl = desc(t + C::T_B + C::TT::start(0, cb), 16,
                                8 * WT, WT);
      Wgmma<C::DC>::rs_tf32(acc, f.lo[s], dt, !(C::STEP_SUM && s == 0));
      Wgmma<C::DC>::rs_tf32(acc, f.hi[s], dtl, 1);
      Wgmma<C::DC>::rs_tf32(acc, f.hi[s], dt, 1);
    } else {
      constexpr int WC = C::CT::W;
      Wgmma<C::DC>::rs_bf16_bmn(
          acc, f.hi[s],
          desc(b + C::CT::start(16 * s, 0), C::CT::PANEL, 8 * WC, WC), 1);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH, true>::THREADS, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ dsum_out,
                 int nbh, int nqb, int group, int sq, int skv, int causal,
                 int window, int prefix, float scale, float scale_log2,
                 int nsq, float* __restrict__ dqp, float* __restrict__ mlp) {
  using C = Cfg<T, DH, true>;
  constexpr int BN = C::BN;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  const uint32_t bars = sm + C::BARS;
  char* const gsm = smem_raw + (sm - raw);     // generic view of `sm`

  // heaviest (last) query blocks first, heads innermost, then the parts
  // of a block's key walk (float32 Dh 256: `nsq` of them); warpgroup `wg`
  // owns rows [qw, qw + 64) of the block's [q0, q0 + 64 NRT) (float32 Dh
  // 256: both warpgroups the block's 64, columns [dc, dc + DC) of dq)
  const int bh = blockIdx.x % nbh, sp = blockIdx.x / nbh % nsq;
  const int q0 = (nqb - 1 - blockIdx.x / nbh / nsq) * ROWS * C::NRT;
  const long long qoff = (long long)bh * sq * DH;
  const T* kb = k + (long long)(bh / group) * skv * DH;
  const T* vb = v + (long long)(bh / group) * skv * DH;
  const int wg = threadIdx.x / WG, rw = C::RSPLIT ? 0 : wg;
  const int qw = q0 + ROWS * rw, dc = C::RSPLIT ? wg * C::DC : 0;
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4;     // and row0 + 8
  const int c2 = 2 * (lane % 4);             // and c2 + 1, in each 8

  const int kend = causal ? min(skv, max(q0 + ROWS * C::NRT, prefix)) : skv;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  const int ntw = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;
  // this block's part: key tiles [t_lo, t_lo + nt) of the walk
  const int per = (ntw + nsq - 1) / nsq, t_lo = min(ntw, sp * per);
  const int nt = min(ntw, t_lo + per) - t_lo, kfirst = kbeg + t_lo * BN;

  // D = rowsum(do * o) for rows row0 and row0 + 8: each of a row's four
  // lanes sums a quarter of it, in order (float32 16 bytes a load); it is
  // formed while the first tiles land
  float dsum[2];
  auto row_sums = [&] {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + row0 + 8 * h;
      float s = 0.f;
      if (i < sq) {
        const long long at = qoff + (long long)i * DH + (lane % 4) * (DH / 4);
        if constexpr (C::F32) {
          const float4* d4 = reinterpret_cast<const float4*>(dout + at);
          const float4* o4 = reinterpret_cast<const float4*>(o + at);
#pragma unroll
          for (int d = 0; d < DH / 16; ++d) {
            const float4 a = d4[d], b = o4[d];
            s = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y,
                                                    fmaf(a.x, b.x, s))));
          }
        } else {
#pragma unroll
          for (int d = 0; d < DH / 4; ++d)
            s = fmaf(ftile::to_f(dout[at + d]), ftile::to_f(o[at + d]), s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dsum[h] = s;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NB; ++s) mbar_init(bars + 8 * s, C::THREADS);
    fence_mbar_init();
  }
  __syncthreads();

  // dq~, and (STEP_SUM) the last step's dS~ K, which the wait at the top
  // of the next step completes and folds in; without it `stp` is one
  // unused register, so that bf16 Dh 256 holds only dq~'s 128
  constexpr int NSTP = C::STEP_SUM ? C::DC / 2 : 1;
  float acc[C::DC / 2], stp[NSTP];
#pragma unroll
  for (int i = 0; i < C::DC / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NSTP; ++i) stp[i] = 0.f;
  auto fold = [&] {
    fence_regs(acc);
    if constexpr (C::STEP_SUM) {
      fence_regs(stp);
#pragma unroll
      for (int i = 0; i < C::DC / 2; ++i) acc[i] += stp[i];
    }
  };
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  Frag<C> f;

  auto load_stage = [&](int it) {
    const int st = it % C::NB, k0 = kfirst + it * BN;
    const uint32_t sb = sm + C::ST0 + st * C::STAGE;
    load_rows<T, DH, typename C::CT, BN, C::THREADS>(sb + C::B1, kb, k0, skv);
    load_rows<T, DH, typename C::CT, BN, C::THREADS>(sb + C::B2, vb, k0, skv);
    cp_async_arrive(bars + 8 * st);
  };

  // no key, no tile: dq is 0
  if (nt > 0) {
    // Q and dO join stage 0's barrier
    for (int w = 0; w < C::NRT; ++w) {
      load_rows<T, DH, typename C::RT, ROWS, C::THREADS>(
          sm + C::A1 + w * C::R_B, q + qoff, q0 + ROWS * w, sq);
      load_rows<T, DH, typename C::RT, ROWS, C::THREADS>(
          sm + C::A2 + w * C::R_B, dout + qoff, q0 + ROWS * w, sq);
    }
    for (int s = 0; s < C::NB && s < nt; ++s) load_stage(s);
  }
  row_sums();
  if (nt > 0) {
    mbar_wait(bars, 0);
    if constexpr (C::F32 && !C::RSPLIT)
      split_flat<C::THREADS>(gsm + C::A1, C::A_LO, C::A_LO);
    float zero[BN / 2] = {};
    f.pack(zero);                  // defined values for the first fence

    for (int it = 0; it < nt; ++it) {
      const int st = it % C::NB, k0 = kfirst + it * BN;
      const uint32_t sb = sm + C::ST0 + st * C::STAGE;
      char* const gsb = gsm + C::ST0 + st * C::STAGE;
      // float32: dq~ += dS~ K of the step before reads K^T, so that
      // product ends (in every warpgroup) before the split writes it
      if constexpr (C::F32) {
        wgmma_wait<0>();
        fold();
        f.fence();
        __syncthreads();
      }
      mbar_wait(bars + 8 * st, (it / C::NB) & 1);
      if constexpr (C::F32) {
        split_transpose<BN, DH, C::THREADS>(gsb + C::B1, 2 * C::C_B,
                                            gsm + C::TQ, C::T_B);
        split_flat<C::THREADS>(gsb + C::B2, 2 * C::C_B, C::CT::BYTES);
      }
      fence_proxy_async();
      // bf16: dq~ += dS~ K of the step before reads K there; past the
      // barrier (in every warpgroup) that stage takes tile it + 1
      if constexpr (!C::F32) {
        wgmma_wait<0>();
        fence_regs(acc);
        f.fence();
      }
      __syncthreads();
      if (!C::F32 && it >= 1 && it + 1 < nt) load_stage(it + 1);

      float s[BN / 2], dp[BN / 2];
      if constexpr (C::RSPLIT) {
        issue_split<C, DH, true, true>(s, dp, gsm + C::A1, gsm + C::A2,
                                       sb + C::B1, sb + C::B2);
        // S and dP over the other half of Dh; V's tile is read by no
        // product any more
        exchange<BN / 2, true>(s, dp, gsb + C::B2);
      } else {
        wgmma_fence();
        issue_ss<C, DH, true>(s, sm + C::A1 + wg * C::R_B, sb + C::B1);
        issue_ss<C, DH, true>(dp, sm + C::A2 + wg * C::R_B, sb + C::B2);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      // float32: past the barrier no warpgroup reads K or V again (dq~ +=
      // dS~ K reads K^T), so tile it + 1 lands under the softmax and the
      // products
      if constexpr (C::F32) {
        __syncthreads();
        if (it + 1 < nt) load_stage(it + 1);
      }

      // mask, then the online softmax on the fragments: s[4j + e] is row
      // qw + row0 + 8 (e / 2), key k0 + 8 j + c2 + e % 2
      const bool edge = k0 + BN > skv ||
                        (causal && k0 + BN - 1 > qw && k0 + BN > prefix) ||
                        (window > 0 && k0 <= qw + ROWS - 1 - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
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
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __fmul_rn(s[4 * j + e], scale_log2);
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
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[4 * j + e] - mu[e >> 1]);
          l[e >> 1] += p;
          s[4 * j + e] = p * (dp[4 * j + e] - dsum[e >> 1]);
        }
      f.pack(s);
#pragma unroll
      for (int j = 0; j < C::DC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

      // float32 Dh 256: K^T's rows [dc, dc + DC), this warpgroup's columns
      wgmma_fence();
      if constexpr (C::STEP_SUM)
        issue_rs<C, DH>(stp, f, sb + C::B1, sm + C::TQ);
      else
        issue_rs<C, DH>(acc, f, sb + C::B1,
                        sm + C::TQ + C::TT::start(dc, 0));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fold();
    f.fence();
  }

  // dq = dq~ scale / l; lse = m + log2 l (base 2) and D for the dk/dv pass
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int i = qw + row0 + 8 * h;
    if (i >= sq) continue;
    if (C::RSPLIT && nsq > 1) {
      // a part of the walk: dq~ unscaled, the row's m and l, combined by
      // fa_bwd256_dq_sum_kernel
      const long long at = ((long long)sp * nbh + bh) * sq + i;
      if (lane % 4 == 0 && dc == 0) {
        mlp[2 * at] = m[h];
        mlp[2 * at + 1] = l[h];
        if (sp == 0) dsum_out[(long long)bh * sq + i] = dsum[h];
      }
      float* prow = dqp + at * DH + dc;
#pragma unroll
      for (int j = 0; j < C::DC / 8; ++j)
        store2(prow + 8 * j + c2, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      continue;
    }
    if (lane % 4 == 0 && dc == 0) {
      lse_out[(long long)bh * sq + i] = m[h] + log2f(l[h]);
      dsum_out[(long long)bh * sq + i] = dsum[h];
    }
    const float r = scale / fmaxf(l[h], 1e-30f);
    T* row = dq + qoff + (long long)i * DH + dc;
#pragma unroll
    for (int j = 0; j < C::DC / 8; ++j)
      store2(row + 8 * j + c2, acc[4 * j + 2 * h] * r,
             acc[4 * j + 2 * h + 1] * r);
  }
}

// which gradients a dk/dv pass forms: both (Dh <= 128), or at Dh 256 dk
// alone or dv alone (each a 128-register accumulator: see the Dh-256
// section below)
enum Part { DKDV = 0, DK = 1, DV = 2 };

// the dk/dv pass of one block: keys [k0, k0 + 64 NRT) of kv head `kvh`,
// walking q heads h0 .. h0 + nh - 1 and each one's query tiles in order;
// dk and dv (as `part` says) go to rows k0.. of `dk` / `dv` from element
// `ooff` (the kv head's rows, or a q head's float32 partial); the block
// walks part `sp` of `nspl` contiguous parts of the query tiles
template <typename T, int DH, int PART, typename O>
__device__ __forceinline__ void dkdv_pass(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse_in, const float* __restrict__ dsum_in,
    O* __restrict__ dk, O* __restrict__ dv, int kvh, int h0, int nh, int k0,
    long long ooff, int sp, int nspl, int sq, int skv, int causal,
    int window, int prefix, float scale, float scale_log2) {
  using C = Cfg<T, DH, false>;
  constexpr int BN = C::BN;
  constexpr bool WDK = PART != DV, WDV = PART != DK;   // forms dk / dv
  constexpr int NK = WDK ? C::DC / 2 : 1, NV = WDV ? C::DC / 2 : 1;
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;
  const uint32_t bars = sm + C::BARS;
  char* const gsm = smem_raw + (sm - raw);

  // warpgroup `wg` owns keys [kw, kw + 64) (float32 Dh 256: both the
  // block's 64, columns [dc, dc + DC) of dk or dv)
  const long long koff = (long long)kvh * skv * DH;
  const int wg = threadIdx.x / WG, rw = C::RSPLIT ? 0 : wg;
  const int kw = k0 + ROWS * rw, dc = C::RSPLIT ? wg * C::DC : 0;
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);

  // query tiles holding a query that keeps a key of [k0, klast]: from the
  // first key's diagonal (causal; from query 0 if a key lies in the
  // prefix) to the last query whose window holds the last key
  const int klast = min(skv, k0 + ROWS * C::NRT) - 1;
  const int qbeg = causal && k0 >= prefix ? k0 / BN * BN : 0;
  const int qend = causal && window > 0 ? min(sq, klast + window) : sq;
  const int nq = qend > qbeg ? (qend - qbeg + BN - 1) / BN : 0;
  // this block's part: query tiles [t_lo, t_lo + nqs) of each head
  const int per = (nq + nspl - 1) / nspl, t_lo = min(nq, sp * per);
  const int nqs = min(nq, t_lo + per) - t_lo;
  const int nt = nh * nqs;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NB; ++s) mbar_init(bars + 8 * s, C::THREADS);
    fence_mbar_init();
  }
  __syncthreads();

  // dk, dv and (STEP_SUM) the last step's products, folded in as in the
  // dq pass; an accumulator the pass does not form is one unused register
  constexpr int SK = C::STEP_SUM ? NK : 1, SV = C::STEP_SUM ? NV : 1;
  float dka[NK], dva[NV], dks[SK], dvs[SV];
#pragma unroll
  for (int i = 0; i < NK; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SK; ++i) dks[i] = 0.f;
#pragma unroll
  for (int i = 0; i < SV; ++i) dvs[i] = 0.f;
  auto fence_acc = [&] {
    if constexpr (WDK) fence_regs(dka);
    if constexpr (WDV) fence_regs(dva);
  };
  auto fold = [&] {
    fence_acc();
    if constexpr (C::STEP_SUM) {
      fence_regs(dks);
      fence_regs(dvs);
#pragma unroll
      for (int i = 0; i < NK; ++i) dka[i] += dks[i];
#pragma unroll
      for (int i = 0; i < NV; ++i) dva[i] += dvs[i];
    }
  };
  Frag<C> fp, fd;
  auto fence_frags = [&] {
    if constexpr (WDV) fp.fence();
    if constexpr (WDK) fd.fence();
  };

  // step `it`: q head h0 + it / nqs, query tile t_lo + it % nqs
  auto load_stage = [&](int it) {
    const int st = it % C::NB, q0 = qbeg + (t_lo + it % nqs) * BN;
    const long long bh = (long long)h0 + it / nqs;
    const uint32_t sb = sm + C::ST0 + st * C::STAGE;
    const uint32_t ld = sb + C::LD + (it & 1) * 8 * BN;
    load_rows<T, DH, typename C::CT, BN, C::THREADS>(sb + C::B1,
                                                     q + bh * sq * DH, q0, sq);
    load_rows<T, DH, typename C::CT, BN, C::THREADS>(
        sb + C::B2, dout + bh * sq * DH, q0, sq);
    for (int c = threadIdx.x; c < BN; c += C::THREADS) {
      const bool ok = q0 + c < sq;
      const long long at = ok ? bh * sq + q0 + c : 0;
      cp_async4(ld + 4 * c, lse_in + at, ok);
      cp_async4(ld + 4 * (BN + c), dsum_in + at, ok);
    }
    cp_async_arrive(bars + 8 * st);
  };

  if (nt > 0) {
    // K (and V, where dP^T is formed) join stage 0's barrier
    for (int w = 0; w < C::NRT; ++w) {
      load_rows<T, DH, typename C::RT, ROWS, C::THREADS>(
          sm + C::A1 + w * C::R_B, k + koff, k0 + ROWS * w, skv);
      if constexpr (WDK)
        load_rows<T, DH, typename C::RT, ROWS, C::THREADS>(
            sm + C::A2 + w * C::R_B, v + koff, k0 + ROWS * w, skv);
    }
    for (int s = 0; s < C::NB && s < nt; ++s) load_stage(s);
    mbar_wait(bars, 0);
    if constexpr (C::F32 && !C::RSPLIT)
      split_flat<C::THREADS>(gsm + C::A1, C::A_LO, C::A_LO);
    float zero[BN / 2] = {};
    fp.pack(zero);                 // defined values for the first fence
    fd.pack(zero);

    for (int it = 0; it < nt; ++it) {
      const int st = it % C::NB, q0 = qbeg + (t_lo + it % nqs) * BN;
      const uint32_t sb = sm + C::ST0 + st * C::STAGE;
      char* const gsb = gsm + C::ST0 + st * C::STAGE;
      // as in the dq pass: the step before's dv and dk products end before
      // the split (float32) or free the other stage for tile it + 1 (bf16)
      if constexpr (C::F32) {
        wgmma_wait<0>();
        fold();
        fence_frags();
        __syncthreads();
      }
      mbar_wait(bars + 8 * st, (it / C::NB) & 1);
      // float32: Q and dO split in place, and transposed where a product
      // reads Q^T (dk) or dO^T (dv)
      if constexpr (C::F32) {
        if constexpr (WDK)
          split_transpose<BN, DH, C::THREADS>(gsb + C::B1, 2 * C::C_B,
                                              gsm + C::TQ, C::T_B);
        else
          split_flat<C::THREADS>(gsb + C::B1, 2 * C::C_B, C::CT::BYTES);
        if constexpr (WDV)
          split_transpose<BN, DH, C::THREADS>(gsb + C::B2, 2 * C::C_B,
                                              gsm + C::TO, C::T_B);
        else
          split_flat<C::THREADS>(gsb + C::B2, 2 * C::C_B, C::CT::BYTES);
      }
      fence_proxy_async();
      if constexpr (!C::F32) {
        wgmma_wait<0>();
        fence_acc();
        fence_frags();
      }
      __syncthreads();
      if (!C::F32 && it >= 1 && it + 1 < nt) load_stage(it + 1);

      float s[BN / 2], dp[WDK ? BN / 2 : 1];
      if constexpr (C::RSPLIT) {
        issue_split<C, DH, false, WDK>(s, dp, gsm + C::A1, gsm + C::A2,
                                       sb + C::B1, sb + C::B2);
        // S^T and dP^T over the other half of Dh; Q's tile is read by no
        // product any more (dk += dS^T Q reads Q^T)
        exchange<BN / 2, WDK>(s, dp, gsb + C::B1);
      } else {
        wgmma_fence();
        issue_ss<C, DH, false>(s, sm + C::A1 + wg * C::R_B, sb + C::B1);
        if constexpr (WDK)
          issue_ss<C, DH, false>(dp, sm + C::A2 + wg * C::R_B, sb + C::B2);
        wgmma_commit();
        wgmma_wait<0>();
      }
      fence_regs(s);
      if constexpr (WDK) fence_regs(dp);
      // float32: Q and dO are free past the barrier (the products below
      // read Q^T and dO^T); lse and D alternate halves
      if constexpr (C::F32) {
        __syncthreads();
        if (it + 1 < nt) load_stage(it + 1);
      }

      // P^T and dS^T on the fragments: s[4j + e] is key kw + row0 + 8 (e /
      // 2), query q0 + 8 j + c2 + e % 2 (column 8 j + c2 + e % 2 of the
      // stage's lse and D)
      const float* ls =
          reinterpret_cast<const float*>(gsb + C::LD + (it & 1) * 8 * BN);
      const float* ds = ls + BN;
      const bool edge = kw + ROWS > skv || q0 + BN > sq ||
                        (causal && kw + ROWS - 1 > q0 && kw + ROWS > prefix) ||
                        (window > 0 && kw <= q0 + BN - 1 - window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + c2 + (e & 1);
          const int key = kw + row0 + 8 * (e >> 1), query = q0 + col;
          const bool keep =
              !edge || (key < skv && query < sq &&
                        (!causal || ((key <= query || key < prefix) &&
                                     (window == 0 || key > query - window))));
          const float p =
              keep ? exp2f(__fmul_rn(s[4 * j + e], scale_log2) - ls[col])
                   : 0.f;
          s[4 * j + e] = p;
          if constexpr (WDK) dp[4 * j + e] = p * (dp[4 * j + e] - ds[col]);
        }
      if constexpr (WDV) fp.pack(s);
      if constexpr (WDK) fd.pack(dp);

      // dv += P^T dO, dk += dS^T Q
      wgmma_fence();
      if constexpr (WDV) {
        if constexpr (C::STEP_SUM)
          issue_rs<C, DH>(dvs, fp, sb + C::B2, sm + C::TO);
        else
          issue_rs<C, DH>(dva, fp, sb + C::B2,
                          sm + C::TO + C::TT::start(dc, 0));
      }
      if constexpr (WDK) {
        if constexpr (C::STEP_SUM)
          issue_rs<C, DH>(dks, fd, sb + C::B1, sm + C::TQ);
        else
          issue_rs<C, DH>(dka, fd, sb + C::B1,
                          sm + C::TQ + C::TT::start(dc, 0));
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fold();
    fence_frags();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = kw + row0 + 8 * h;
    if (j >= skv) continue;
#pragma unroll
    for (int c = 0; c < C::DC / 8; ++c) {
      if constexpr (WDK)
        store2(dk + ooff + (long long)j * DH + dc + 8 * c + c2,
               dka[4 * c + 2 * h] * scale, dka[4 * c + 2 * h + 1] * scale);
      if constexpr (WDV)
        store2(dv + ooff + (long long)j * DH + dc + 8 * c + c2,
               dva[4 * c + 2 * h], dva[4 * c + 2 * h + 1]);
    }
  }
}

// Dh <= 128: a block of NWG warpgroups walks the group's q heads in order,
// so that dk and dv sum over them in a fixed order
template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH, false>::THREADS, 1)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse_in,
                   const float* __restrict__ dsum_in, T* __restrict__ dk,
                   T* __restrict__ dv, int nkv, int group, int sq, int skv,
                   int causal, int window, int prefix, float scale,
                   float scale_log2) {
  // key blocks in order (the causal form's first ones see every query),
  // kv heads innermost
  const int kvh = blockIdx.x % nkv;
  const int k0 = blockIdx.x / nkv * ROWS * Cfg<T, DH, false>::NRT;
  dkdv_pass<T, DH, DKDV, T>(q, k, v, dout, lse_in, dsum_in, dk, dv, kvh,
                            kvh * group, group, k0, (long long)kvh * skv * DH,
                            0, 1, sq, skv, causal, window, prefix, scale,
                            scale_log2);
}

template <typename T, int DH>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, T* dq,
        T* dk, T* dv, float* lse, float* dsum, int bh, int group, int sq,
        int skv, int causal, int window, int prefix, float scale,
        cudaStream_t stream) {
  using CQ = Cfg<T, DH, true>;
  using CK = Cfg<T, DH, false>;
  auto dq_kernel = fa_bwd_dq_kernel<T, DH>;
  auto dkdv_kernel = fa_bwd_dkdv_kernel<T, DH>;
  static const int err_q = ftile::allow_smem(dq_kernel, CQ::BYTES);
  static const int err_k = ftile::allow_smem(dkdv_kernel, CK::BYTES);
  if (err_q) return err_q;
  if (err_k) return err_k;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int nqb = (sq + ROWS * CQ::NRT - 1) / (ROWS * CQ::NRT);
  dq_kernel<<<nqb * bh, CQ::THREADS, CQ::BYTES, stream>>>(
      q, k, v, o, dout, dq, lse, dsum, bh, nqb, group, sq, skv, causal,
      window, prefix, scale, scale_log2, 1, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkb = (skv + ROWS * CK::NRT - 1) / (ROWS * CK::NRT);
  dkdv_kernel<<<nkb * (bh / group), CK::THREADS, CK::BYTES, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, bh / group, group, sq, skv, causal,
      window, prefix, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Dh 256. A 64-row wgmma accumulator of that width is 128 float32
// registers a thread: dq~ fits (the dq pass above runs unchanged, as the
// forward holds its O), dk and dv together (256) do not. Two ways to keep
// the dk/dv pass on the tensor cores were weighed, at bf16 (the path's):
// (a) two warpgroups each own half the columns of dk and dv for the same
//     64 keys, one forming S^T and the other dP^T, P^T and dS^T crossing
//     between them through shared memory as bf16 each step behind a named
//     barrier: K and V resident for 64 keys 64 KB, two stages of Q and dO
//     at 64 queries 128 KB, P^T and dS^T 16 KB: 208 KB a block of 64 keys;
// (b) two passes, dk (S^T, dP^T, dk += dS^T Q) and dv (S^T, dv += P^T dO),
//     each with one 128-register accumulator: the Dh <= 128 pass itself
//     (dkdv_pass, PART), at the cost of S^T formed in both (8 products a
//     kept tile pair against 7) and Q read twice.
// (b) is taken: no new exchange or barrier to get right, one templated
// body, and two warpgroups of 64 keys a block as at Dh <= 128. Its tiles
// at Dh 256 bf16 (Cfg): the dq pass, one warpgroup a block, holds Q and
// dO for 64 rows (64 KB) and two stages of K and V at 64 keys (128 KB),
// 193 KB, 250 registers (dq~ 128, S and dP 32 each, dS~ as bf16
// fragments 16); the dk/dv passes K and V for 128 keys (128 KB; the dv
// pass leaves V's half unused) and two stages of Q, dO, lse and D at 32
// queries (66 KB), 195 KB, 200 registers. On NVIDIA H100 80GB HBM3 at
// 700 W (tools/flash_attn_bwd_ab.py), the dq pass at one warpgroup and
// 64-key tiles took 58.3 us at the local case against 79.5 at two
// warpgroups of 32-key tiles (80 blocks on 132 SMs); the dk/dv passes at
// one warpgroup took 73-84 us against 71.
// Filling the card: the dk and dv passes run as one launch
// (fa_bwd_kv256_kernel), each block one q head's 128 keys, the group
// split across blocks, so each head's dk and dv go to a float32 scratch
// (2, BH, Skv, 256) that a third launch (fa_bwd256_sum_kernel) sums over
// the group in head order. At RecurrentGemma's local layer, (20, 512,
// 256) group 10, that is 160 dq blocks, 160 dk/dv blocks and 21.0 MB of
// scratch written and read once (12.5 us at 3.35 TB/s, beside a bound of
// 6.9 us); at PaliGemma's prefix case, (16, 768, 256) group 8, 192 and 192
// blocks and 25.2 MB (15.0 us, bound 13.6 us). Walking g heads of a group
// in a block cuts the scratch g-fold but the blocks too: at g = 2, 80 and
// 96 dk/dv blocks on 132 SMs.
//
// float32 at Dh 256 runs the same three launches on the tensor cores
// (3xTF32), the dq pass and the dk and dv passes being the templates
// above at Cfg<float, 256, *>. What stands in the way is shared memory: a
// 64-row row tile of 256 float32 columns is 64 KB, 128 KB with its tf32
// lo half, so Q and dO (dq pass) or K and V (dk pass) with lo halves take
// 256 KB, more than a block's 227 KB. So (RSPLIT):
// - The row side stays raw float32 and S and dP take their A operand
//   from registers: each k-step of 8 columns, a warp loads its tf32
//   fragment from the row tile and splits it hi + lo in registers
//   (issue_split; split_walk and frag_kmajor in hopper_tile.cuh). The row
//   tiles keep the swizzled layout, whose 16-byte chunks XOR with the row,
//   so a fragment's eight rows find 32 banks. The split rounds as the
//   stored one and the three products take the same values in the same
//   k-order, so P still agrees between the passes. Each product has its
//   own accumulator, summed (lo hi + hi lo) + hi hi: one accumulator
//   chains 96 dependent products.
// - Column tiles of BN = 16 (K, V, Q or dO BN x 1 KB raw, 2 KB with lo;
//   a transposed copy 256 x BN x 4 B = 16 KB, 32 KB with lo). Shared
//   memory, one block a SM: the dq pass Q and dO raw 128 KB, K and V with
//   lo halves 64 KB, K^T with its lo 32 KB: 224 KB (230,408 B with the
//   barrier and alignment); the dk / dv passes K and V raw 128 KB (the dv
//   pass leaves V's unused), Q and dO with lo halves and the tile's lse
//   and D 65 KB, and one transposed copy with its lo, Q^T (dk) or dO^T
//   (dv), 32 KB: 225 KB (231,048 B). The dk pass splits dO in place and
//   transposes Q; the dv pass splits Q in place and transposes dO. BN 32
//   would need 64 KB more in either pass.
// - Two warpgroups share a block's 64 rows: each forms S and dP (S^T and
//   dP^T) over its half of Dh, the halves cross through a stage tile that
//   no product reads any more (exchange: V's in the dq pass, Q's in the
//   dk/dv pass; 16 KB), warpgroup 0's first, so both hold the same sums,
//   and each owns half the columns of dq, dk or dv (a 64-register
//   accumulator, products of N = 128 on its rows of the transposed copy).
//   Registers (no spill): the accumulator 64, S and dP's three partial
//   accumulators 48, two fragment sets 32, dS~ or dS^T as fragments 16.
//   No STEP_SUM at Dh 256, as at float32 Dh 128, where the dq pass chains
//   as long.
// - Where the dk and dv blocks (two a q head and 64 keys) would not fill
//   the card, each block walks one of `nspl` contiguous parts of its
//   query tiles and writes its own float32 partial, which the group sum
//   adds in head order, a head's parts in order (flash_attn.bwd_splits:
//   at most 4, as many as keep the blocks within two a SM).
// Blocks at phase 2's (8, 300, 256) group 2 causal case: 40 dq blocks and
// 80 dk/dv blocks in 3 parts, 240; at the float32 twins of the path
// cases, (20, 512, 256) group 10 local and (16, 768, 256) group 8 prefix,
// 160 and 320, 192 and 384 (no parts). The scratch: 2 x 7.4 MB at phase
// 2's case, 2 x 21.0 MB and 2 x 25.2 MB at the twins.
// What holds it back (PERF.md §6): S and dP take 192 tf32 `wgmma`
// of N = 16 for every 16 keys (three products, two operands, 32
// k-steps), which the SM retires far below the tensor cores' rate (a
// second warpgroup did not shorten the dq walk); shared memory bounds N.
// A block's tiles run in turn, one block a SM.
// ---------------------------------------------------------------------------

// dk, dv (BH / group, Skv, 256) = each kv head's group of the per-head
// scratch (each head's `nspl` parts of its query walk) summed in head
// order, a head's parts in order
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd256_sum_kernel(const float* __restrict__ dk_part,
                     const float* __restrict__ dv_part, T* __restrict__ dk,
                     T* __restrict__ dv, int group, int nspl,
                     long long per_head, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long kvh = i / per_head, r = i - kvh * per_head;
  float sk = 0.f, sv = 0.f;
  for (int g = 0; g < group * nspl; ++g) {
    const long long at = (kvh * group * nspl + g) * per_head + r;
    sk += dk_part[at];
    sv += dv_part[at];
  }
  dk[i] = from_f<T>(sk);
  dv[i] = from_f<T>(sv);
}

// float32 Dh 256 with the dq pass's key walk in `nsq` parts: dq = sum_i
// w_i dq~_i scale / sum_i w_i l_i and lse = max m + log2 sum_i w_i l_i,
// w_i = exp2(m_i - max m), the parts in order; a thread four columns of a
// row
__global__ void __launch_bounds__(256)
fa_bwd256_dq_sum_kernel(const float* __restrict__ dqp,
                        const float* __restrict__ mlp, float* __restrict__ dq,
                        float* __restrict__ lse, int nsq, long long rows,
                        float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * 64) return;
  const long long r = i / 64;
  const int cg = static_cast<int>(i % 64);
  float mx = -INFINITY;
  for (int s = 0; s < nsq; ++s) mx = fmaxf(mx, mlp[2 * (s * rows + r)]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsq; ++s) {
    const long long at = s * rows + r;
    const float w = exp2f(mlp[2 * at] - mu);
    l = fmaf(w, mlp[2 * at + 1], l);
    const float4 v = reinterpret_cast<const float4*>(dqp + at * 256)[cg];
    acc = make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y),
                      fmaf(w, v.z, acc.z), fmaf(w, v.w, acc.w));
  }
  const float sc = scale / fmaxf(l, 1e-30f);
  reinterpret_cast<float4*>(dq + r * 256)[cg] =
      make_float4(acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc);
  if (cg == 0) lse[r] = mx + log2f(l);
}

// Dh 256: the dk/dv pass split in two passes of one launch, dk (S^T,
// dP^T, dS^T Q) and dv (S^T, P^T dO), each block a key block of one q
// head, odd blocks dv and even ones dk of the same keys and head (their Q
// and dO tiles read together through L2); each head's dk and dv go to the
// float32 scratch that fa_bwd256_sum_kernel sums over the group
template <typename T>
__global__ void __launch_bounds__(Cfg<T, 256, false>::THREADS, 1)
fa_bwd_kv256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse_in,
                    const float* __restrict__ dsum_in,
                    float* __restrict__ dk_part, float* __restrict__ dv_part,
                    int nbh, int group, int nspl, int sq, int skv, int causal,
                    int window, int prefix, float scale, float scale_log2) {
  const int i = blockIdx.x >> 1, sp = i % nspl, j = i / nspl;
  const int bh = j % nbh;
  const int k0 = j / nbh * ROWS * Cfg<T, 256, false>::NRT;
  const long long ooff = ((long long)bh * nspl + sp) * skv * 256;
  if (blockIdx.x & 1)
    dkdv_pass<T, 256, DV, float>(q, k, v, dout, lse_in, dsum_in, dk_part,
                                 dv_part, bh / group, bh, 1, k0, ooff, sp,
                                 nspl, sq, skv, causal, window, prefix, scale,
                                 scale_log2);
  else
    dkdv_pass<T, 256, DK, float>(q, k, v, dout, lse_in, dsum_in, dk_part,
                                 dv_part, bh / group, bh, 1, k0, ooff, sp,
                                 nspl, sq, skv, causal, window, prefix, scale,
                                 scale_log2);
}

// Dh 256: the templated dq pass, the split dk/dv passes and the group sum
template <typename T>
int run256(const T* q, const T* k, const T* v, const T* o, const T* dout,
           T* dq, T* dk, T* dv, float* lse, float* dsum, float* part, int bh,
           int group, int nsq, int nspl, int sq, int skv, int causal,
           int window, int prefix, float scale, cudaStream_t stream) {
  // `part`: the dk and dv partials (2, BH nspl, Skv, 256), then (nsq > 1,
  // float32) the dq pass's parts (nsq, BH, Sq, 256) and their rows' m and
  // l (nsq, BH, Sq, 2)
  if (part == nullptr || nspl < 1 || nsq < 1 ||
      (nsq > 1 && !std::is_same<T, float>::value))
    return static_cast<int>(cudaErrorInvalidValue);
  using CQ = Cfg<T, 256, true>;
  using CK = Cfg<T, 256, false>;
  auto dq_kernel = fa_bwd_dq_kernel<T, 256>;
  auto kv_kernel = fa_bwd_kv256_kernel<T>;
  static const int err_q = ftile::allow_smem(dq_kernel, CQ::BYTES);
  static const int err_k = ftile::allow_smem(kv_kernel, CK::BYTES);
  if (err_q) return err_q;
  if (err_k) return err_k;
  const float scale_log2 = scale * 1.4426950408889634f;
  const int nqb = (sq + ROWS * CQ::NRT - 1) / (ROWS * CQ::NRT);
  const long long per_part = (long long)bh * nspl * skv * 256;
  float* dqp = part + 2 * per_part;
  float* mlp = dqp + (long long)nsq * bh * sq * 256;
  dq_kernel<<<nqb * bh * nsq, CQ::THREADS, CQ::BYTES, stream>>>(
      q, k, v, o, dout, dq, lse, dsum, bh, nqb, group, sq, skv, causal,
      window, prefix, scale, scale_log2, nsq, dqp, mlp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsq > 1) {
    const long long rows = (long long)bh * sq;
    fa_bwd256_dq_sum_kernel<<<static_cast<int>((rows * 64 + 255) / 256), 256,
                              0, stream>>>(dqp, mlp,
                                           reinterpret_cast<float*>(dq), lse,
                                           nsq, rows, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nkb = (skv + ROWS * CK::NRT - 1) / (ROWS * CK::NRT);
  kv_kernel<<<2 * nkb * bh * nspl, CK::THREADS, CK::BYTES, stream>>>(
      q, k, v, dout, lse, dsum, part, part + per_part, bh, group, nspl, sq,
      skv, causal, window, prefix, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)bh / group * skv * 256;
  fa_bwd256_sum_kernel<T><<<static_cast<int>((total + 255) / 256), 256, 0,
                            stream>>>(part, part + per_part, dk, dv, group,
                                      nspl, (long long)skv * 256, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, void* part, int bh, int group, int nsq, int nspl,
           int sq, int skv, int dh, int causal, int window, int prefix,
           float scale, void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || skv < 1 ||
      (causal && sq != skv) || window < 0 || (window && !causal) ||
      prefix < 0 || (prefix && (!causal || window)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tq = static_cast<const T*>(q);
  const auto* tk = static_cast<const T*>(k);
  const auto* tv = static_cast<const T*>(v);
  const auto* to = static_cast<const T*>(o);
  const auto* td = static_cast<const T*>(dout);
  auto* gq = static_cast<T*>(dq);
  auto* gk = static_cast<T*>(dk);
  auto* gv = static_cast<T*>(dv);
  auto* fl = static_cast<float*>(lse);
  auto* fd = static_cast<float*>(dsum);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return run<T, 16>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, sq, skv, causal, window, prefix, scale, st);
    case 32: return run<T, 32>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, sq, skv, causal, window, prefix, scale, st);
    case 64: return run<T, 64>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, sq, skv, causal, window, prefix, scale, st);
    case 128: return run<T, 128>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, bh, group, sq, skv, causal, window, prefix, scale, st);
    case 256: return run256<T>(tq, tk, tv, to, td, gq, gk, gv, fl, fd, static_cast<float*>(part), bh, group, nsq, nspl, sq, skv, causal, window, prefix, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_bwd_f32(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, void* dq,
                                  void* dk, void* dv, void* lse, void* dsum,
                                  void* part, int bh, int group, int nsq,
                                  int nspl, int sq, int skv, int dh,
                                  int causal, int window, int prefix,
                                  float scale, void* stream) {
  return launch<float>(q, k, v, o, dout, dq, dk, dv, lse, dsum, part, bh,
                       group, nsq, nspl, sq, skv, dh, causal, window, prefix,
                       scale, stream);
}

extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* dsum,
                                   void* part, int bh, int group, int nsq,
                                   int nspl, int sq, int skv, int dh,
                                   int causal, int window, int prefix,
                                   float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, part,
                               bh, group, nsq, nspl, sq, skv, dh, causal,
                               window, prefix, scale, stream);
}
