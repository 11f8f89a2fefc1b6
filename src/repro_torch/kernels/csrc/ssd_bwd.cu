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
// launches and no atomics:
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
// float32 (13c's one step and the gates) keeps the CUDA-core kernels
// (namespace cuda_cores): its 3xTF32 split and transposed copies do not
// fit the tiles above, and no path runs it at size. One block of 512
// threads a (batch, head) first walks the chunks forwards, the state in
// registers, storing each chunk's entry state S0 to a scratch (B, H,
// T / QC, P, N), then walks them backwards with dS in shared memory, every
// operand of a chunk there in float32 (rows padded by one float, so that
// a warp's walk down a column hits 32 banks); a warp owns rows of each
// product and its lanes the columns, so a row's sums close in shuffles, in
// one order. dX and da are written, dB and dC per head to a scratch (B,
// H, T, N) that ssd_bwd_sum_kernel sums over the heads. No HGMMA.
// Two launches agree bitwise, in either type.
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

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace cuda_cores {

constexpr int QC = 64;          // steps a chunk
constexpr int PMAX = 64;        // head dim
constexpr int NMAX = 128;       // state dim
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = PMAX * NMAX / THREADS;   // state elements a thread
constexpr int XS = PMAX + 1;    // row strides in shared memory
constexpr int BS = NMAX + 1;
constexpr int WS = QC + 1;

// shared memory, in floats
constexpr int OFF_X = 0;
constexpr int OFF_DY = OFF_X + QC * XS;
constexpr int OFF_B = OFF_DY + QC * XS;
constexpr int OFF_C = OFF_B + QC * BS;
constexpr int OFF_DS = OFF_C + QC * BS;
constexpr int OFF_S0 = OFF_DS + PMAX * BS;
constexpr int OFF_W = OFF_S0 + PMAX * BS;
constexpr int OFF_R2 = OFF_W + QC * WS;
constexpr int OFF_G2 = OFF_R2 + QC * WS;
constexpr int OFF_VEC = OFF_G2 + QC * WS;   // 8 vectors of QC
constexpr int OFF_RED = OFF_VEC + 8 * QC;
constexpr int SMEM_FLOATS = OFF_RED + WARPS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(SMEM_BYTES <= 232448, "ssd backward: shared memory");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [t0, t0 + q) of a (B, T, H, P) tensor's head `hh` into sm[s * XS +
// p], and of a (B, T, N) tensor into sm[s * BS + n], as float
template <typename T>
__device__ __forceinline__ void load_heads(float* sm, const T* x, long long
                                           base, int q, int h, int p) {
  for (int i = threadIdx.x; i < q * p; i += THREADS) {
    const int s = i / p, j = i - s * p;
    sm[s * XS + j] = ftile::to_f(x[base + (long long)s * h * p + j]);
  }
}
template <typename T>
__device__ __forceinline__ void load_rows(float* sm, const T* b, long long
                                          base, int q, int n) {
  for (int i = threadIdx.x; i < q * n; i += THREADS) {
    const int s = i / n, j = i - s * n;
    sm[s * BS + j] = ftile::to_f(b[base + (long long)s * n + j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_head_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const T* __restrict__ b, const T* __restrict__ c,
                    const T* __restrict__ dy,
                    const float* __restrict__ dstate,
                    const float* __restrict__ state0, T* __restrict__ dx,
                    float* __restrict__ da, float* __restrict__ ds0,
                    float* __restrict__ states, float* __restrict__ dbh,
                    float* __restrict__ dch, int h, int t_len, int p,
                    int n) {
  extern __shared__ float sm[];
  float* const X = sm + OFF_X;
  float* const DY = sm + OFF_DY;
  float* const Bm = sm + OFF_B;
  float* const Cm = sm + OFF_C;
  float* const dS = sm + OFF_DS;
  float* const S0 = sm + OFF_S0;
  float* const W = sm + OFF_W;
  float* const R2 = sm + OFF_R2;
  float* const G2 = sm + OFF_G2;
  float* const cum = sm + OFF_VEC;
  float* const ecum = cum + QC;
  float* const etail = ecum + QC;
  float* const rsum = etail + QC;
  float* const csum = rsum + QC;
  float* const ev = csum + QC;
  float* const g2 = ev + QC;
  float* const araw = g2 + QC;
  float* const red = sm + OFF_RED;

  const int bi = blockIdx.x / h, hh = blockIdx.x % h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pn = p * n, nc = (t_len + QC - 1) / QC;
  const long long hbase = (long long)blockIdx.x * pn;     // (B, H, P, N)
  float* const st = states + (long long)blockIdx.x * nc * pn;

  // ---- forward: each chunk's entry state -------------------------------
  float S[EPT];
  int xo[EPT], bo[EPT];      // the element's offsets in X's and B's rows
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + THREADS * i;
    S[i] = state0 != nullptr && e < pn ? state0[hbase + e] : 0.f;
    xo[i] = e < pn ? e / n : 0;
    bo[i] = e < pn ? e - xo[i] * n : 0;
  }
  for (int k = 0; k < nc; ++k) {
    const int t0 = k * QC, q = min(QC, t_len - t0);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + THREADS * i;
      if (e < pn) st[(long long)k * pn + e] = S[i];
    }
    load_heads(X, x, ((long long)bi * t_len + t0) * h * p + (long long)hh * p,
               q, h, p);
    load_rows(Bm, b, ((long long)bi * t_len + t0) * n, q, n);
    for (int s = tid; s < q; s += THREADS)
      araw[s] = a[((long long)bi * t_len + t0 + s) * h + hh];
    __syncthreads();
    for (int s = 0; s < q; ++s) {
      const float dec = expf(araw[s]);
#pragma unroll
      for (int i = 0; i < EPT; ++i)
        S[i] = fmaf(X[s * XS + xo[i]], Bm[s * BS + bo[i]], S[i] * dec);
    }
    __syncthreads();
  }

  // ---- backward, chunk by chunk from the last ---------------------------
  for (int e = tid; e < pn; e += THREADS) {
    const int pp = e / n, nn = e - pp * n;
    dS[pp * BS + nn] = dstate != nullptr ? dstate[hbase + e] : 0.f;
  }
  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * QC, q = min(QC, t_len - t0);
    const long long xrow = ((long long)bi * t_len + t0) * h * p +
                           (long long)hh * p;
    const long long brow = ((long long)bi * t_len + t0) * n;
    for (int e = tid; e < pn; e += THREADS) {
      const int pp = e / n, nn = e - pp * n;
      S0[pp * BS + nn] = __ldcg(st + (long long)k * pn + e);
    }
    load_heads(X, x, xrow, q, h, p);
    load_heads(DY, dy, xrow, q, h, p);
    load_rows(Bm, b, brow, q, n);
    load_rows(Cm, c, brow, q, n);
    for (int s = tid; s < q; s += THREADS)
      araw[s] = a[((long long)bi * t_len + t0 + s) * h + hh];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int s = 0; s < q; ++s) {
        run += araw[s];
        cum[s] = run;
      }
    }
    __syncthreads();
    for (int s = tid; s < q; s += THREADS) {
      ecum[s] = expf(cum[s]);
      etail[s] = expf(cum[q - 1] - cum[s]);
    }

    // W, R2, G2 (rows t by warp, columns s by lane) and G2's row sums
    for (int t = warp; t < q; t += WARPS) {
      float rs = 0.f;
      for (int s = lane; s < QC; s += 32) {
        float w = 0.f, r = 0.f, gg = 0.f;
        if (s <= t) {
          float cb = 0.f, dxs = 0.f;
          for (int j = 0; j < n; ++j) cb = fmaf(Cm[t * BS + j], Bm[s * BS + j], cb);
          for (int j = 0; j < p; ++j) dxs = fmaf(DY[t * XS + j], X[s * XS + j], dxs);
          const float l = expf(cum[t] - cum[s]);
          w = l * cb;
          r = l * dxs;
          gg = w * dxs;
        }
        W[t * WS + s] = w;
        R2[t * WS + s] = r;
        G2[t * WS + s] = gg;
        rs += gg;
      }
      rs = warp_sum(rs);
      if (lane == 0) rsum[t] = rs;
    }
    __syncthreads();

    // G2's column sums
    for (int s = tid; s < q; s += THREADS) {
      float cs = 0.f;
      for (int t = s; t < q; ++t) cs += G2[t * WS + s];
      csum[s] = cs;
    }
    // dX (rows s by warp, p by lane)
    for (int s = warp; s < q; s += WARPS) {
      for (int j = lane; j < p; j += 32) {
        float v = 0.f, u = 0.f;
        for (int t = s; t < q; ++t) v = fmaf(W[t * WS + s], DY[t * XS + j], v);
        for (int m = 0; m < n; ++m) u = fmaf(Bm[s * BS + m], dS[j * BS + m], u);
        dx[xrow + (long long)s * h * p + j] = from_f<T>(fmaf(etail[s], u, v));
      }
    }
    // dB per head (rows s by warp, n by lane) and e_s
    for (int s = warp; s < q; s += WARPS) {
      float ep = 0.f;
      for (int m = lane; m < n; m += 32) {
        float v = 0.f, t6 = 0.f;
        for (int t = s; t < q; ++t) v = fmaf(R2[t * WS + s], Cm[t * BS + m], v);
        for (int j = 0; j < p; ++j) t6 = fmaf(X[s * XS + j], dS[j * BS + m], t6);
        dbh[((long long)blockIdx.x * t_len + t0 + s) * n + m] =
            fmaf(etail[s], t6, v);
        ep = fmaf(Bm[s * BS + m], t6, ep);
      }
      ep = warp_sum(ep);
      if (lane == 0) ev[s] = etail[s] * ep;
    }
    // dC per head (rows t by warp, n by lane) and the S0 term of g_t
    for (int t = warp; t < q; t += WARPS) {
      float gp = 0.f;
      for (int m = lane; m < n; m += 32) {
        float v = 0.f, t7 = 0.f;
        for (int s = 0; s <= t; ++s) v = fmaf(R2[t * WS + s], Bm[s * BS + m], v);
        for (int j = 0; j < p; ++j) t7 = fmaf(DY[t * XS + j], S0[j * BS + m], t7);
        dch[((long long)blockIdx.x * t_len + t0 + t) * n + m] =
            fmaf(ecum[t], t7, v);
        gp = fmaf(Cm[t * BS + m], t7, gp);
      }
      gp = warp_sum(gp);
      if (lane == 0) g2[t] = ecum[t] * gp;
    }
    // <dS, S0>
    {
      float dot = 0.f;
      for (int e = tid; e < pn; e += THREADS) {
        const int pp = e / n, nn = e - pp * n;
        dot = fmaf(dS[pp * BS + nn], S0[pp * BS + nn], dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) red[warp] = dot;
    }
    __syncthreads();

    // da inside the chunk (one thread, in step order) and the state
    // gradient carried to the chunk before
    if (tid == 0) {
      float dot = 0.f, esum = 0.f;
      for (int w = 0; w < WARPS; ++w) dot += red[w];
      for (int s = 0; s < q; ++s) esum += ev[s];
      float acc = 0.f;
      for (int s = q - 1; s >= 0; --s) {
        float g = rsum[s] - csum[s] + g2[s] - ev[s];
        if (s == q - 1) g += esum + ecum[q - 1] * dot;
        acc += g;
        da[((long long)bi * t_len + t0 + s) * h + hh] = acc;
      }
    }
    const float elast = ecum[q - 1];
    for (int pp = warp; pp < p; pp += WARPS) {
      for (int m = lane; m < n; m += 32) {
        float v = 0.f;
        for (int t = 0; t < q; ++t)
          v = fmaf(ecum[t] * DY[t * XS + pp], Cm[t * BS + m], v);
        dS[pp * BS + m] = fmaf(elast, dS[pp * BS + m], v);
      }
    }
    __syncthreads();
  }
  if (ds0 != nullptr) {
    for (int e = tid; e < pn; e += THREADS) {
      const int pp = e / n, nn = e - pp * n;
      ds0[hbase + e] = dS[pp * BS + nn];
    }
  }
}

}  // namespace cuda_cores

// db, dc (B, T, N) = the partial gradients (B, H, T, N) summed over H in
// order: the heads (float32) or the head groups (bf16)
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
__global__ void __launch_bounds__(WG, 3)
ssd_bwd_state_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy,
                     const float* __restrict__ dstate,
                     const float* __restrict__ state0,
                     float* __restrict__ ds0, char* __restrict__ images,
                     int nh, int t_len, int p_dim, int n_dim, int nps,
                     int vec_x, int vec_bc) {
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
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy,
                     const char* __restrict__ images, T* __restrict__ dx,
                     float* __restrict__ da, float* __restrict__ dbg,
                     float* __restrict__ dcg, int nh, int t_len, int p_dim,
                     int n_dim, int ng, int vec_x, int vec_bc) {
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// bf16: the state pass, the chunk pass, the sum over the head groups
template <typename T>
int launch_tc(const T* x, const float* a, const T* b, const T* c, const T* dy,
              const float* dstate, const float* state0, T* dx, float* da,
              T* db, T* dc, float* ds0, char* images, float* dbg, float* dcg,
              int bsz, int h, int t_len, int p, int n, cudaStream_t st) {
  auto state = ssd_bwd_state_kernel<T>;
  auto chunk = ssd_bwd_chunk_kernel<T>;
  static const int err_s = ftile::allow_smem(state, StateCfg::BYTES);
  static const int err_c = ftile::allow_smem(chunk, ChunkCfg::BYTES);
  if (err_s) return err_s;
  if (err_c) return err_c;
  const int nc = (t_len + QT - 1) / QT, nps = (p + PB - 1) / PB;
  const int ng = (h + HG - 1) / HG;
  const int vec_x = (p * 2) % 16 == 0 && aligned16(x) && aligned16(dy);
  const int vec_bc = (n * 2) % 16 == 0 && aligned16(b) && aligned16(c);
  state<<<2 * bsz * h * nps, WG, StateCfg::BYTES, st>>>(
      x, a, b, c, dy, dstate, state0, ds0, images, h, t_len, p, n, nps,
      vec_x, vec_bc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk<<<bsz * nc * ng, 2 * WG, ChunkCfg::BYTES, st>>>(
      x, a, b, c, dy, images, dx, da, dbg, dcg, h, t_len, p, n, ng, vec_x,
      vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)bsz * t_len * n;
  ssd_bwd_sum_kernel<T><<<static_cast<int>((total + 255) / 256), 256, 0,
                          st>>>(dbg, dcg, db, dc, ng, t_len, n, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const void* dstate, const void* state0, void* dx,
           void* da, void* db, void* dc, void* ds0, void* states, void* dbh,
           void* dch, int bsz, int h, int t_len, int p, int n,
           void* stream) {
  using cuda_cores::NMAX;
  using cuda_cores::PMAX;
  if (bsz < 1 || h < 1 || t_len < 1 || p < 1 || p > PMAX || n < 1 ||
      n > NMAX || (long long)bsz * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if constexpr (!std::is_same<T, float>::value) {
    return launch_tc<T>(
        static_cast<const T*>(x), static_cast<const float*>(a),
        static_cast<const T*>(b), static_cast<const T*>(c),
        static_cast<const T*>(dy), static_cast<const float*>(dstate),
        static_cast<const float*>(state0), static_cast<T*>(dx),
        static_cast<float*>(da), static_cast<T*>(db), static_cast<T*>(dc),
        static_cast<float*>(ds0), static_cast<char*>(states),
        static_cast<float*>(dbh), static_cast<float*>(dch), bsz, h, t_len, p,
        n, st);
  } else {
    auto head = cuda_cores::ssd_bwd_head_kernel<T>;
    static const int err_smem = ftile::allow_smem(head,
                                                  cuda_cores::SMEM_BYTES);
    if (err_smem) return err_smem;
    head<<<bsz * h, cuda_cores::THREADS, cuda_cores::SMEM_BYTES, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(a),
        static_cast<const T*>(b), static_cast<const T*>(c),
        static_cast<const T*>(dy), static_cast<const float*>(dstate),
        static_cast<const float*>(state0), static_cast<T*>(dx),
        static_cast<float*>(da), static_cast<float*>(ds0),
        static_cast<float*>(states), static_cast<float*>(dbh),
        static_cast<float*>(dch), h, t_len, p, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = (long long)bsz * t_len * n;
    ssd_bwd_sum_kernel<T><<<static_cast<int>((total + 255) / 256), 256, 0,
                            st>>>(
        static_cast<const float*>(dbh), static_cast<const float*>(dch),
        static_cast<T*>(db), static_cast<T*>(dc), h, t_len, n, total);
    return static_cast<int>(cudaGetLastError());
  }
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
