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
// Design: the chunked form (the forward's, read in reverse), on the CUDA
// cores in float32, two launches, no atomics:
// - ssd_bwd_head_kernel, one block of THREADS threads a (batch, head).
//   First it walks the chunks of QC steps forwards, the state in
//   registers (EPT elements a thread), and stores each chunk's entry state
//   S0 to a scratch (B, H, T / QC, P, N). Then it walks them backwards
//   with dS, the gradient of the state leaving the chunk, in shared
//   memory (from dstate, or 0). For a chunk of q steps, with cum the
//   running sum of a inside it, L[t, s] = exp(cum_t - cum_s) (s <= t),
//   ecum_t = exp(cum_t) and etail_s = exp(cum_{q-1} - cum_s):
//     W = L o (C B^T),  R2 = L o (dY X^T),  G2 = W o (dY X^T)
//     dX[s] = sum_{t >= s} W[t, s] dY[t] + etail_s dS b_s
//     dB[s] = sum_{t >= s} R2[t, s] c_t + etail_s dS^T x_s
//     dC[t] = sum_{s <= t} R2[t, s] b_s + ecum_t S0^T dy_t
//     dS   <- ecum_{q-1} dS + sum_t ecum_t dy_t c_t^T
//   and the gradient of cum_t, g_t = rowsum_t G2 - colsum_t G2 + ecum_t
//   c_t . (S0^T dy_t) - e_t, with e_s = etail_s x_s^T dS b_s, and g_{q-1}
//   also takes sum_s e_s + ecum_{q-1} <dS, S0>; da_s = sum_{t >= s} g_t
//   inside the chunk. dX and da are written; dB and dC per head to a
//   scratch (B, H, T, N); after the first chunk dS is dstate0.
// - ssd_bwd_sum_kernel sums dB and dC over the heads, in head order.
// Every operand of a chunk (S0 read back from the scratch) sits in
// shared memory in float32 (rows padded by one float, so that a warp's
// walk down a column hits 32 banks); a warp owns rows of each product
// and its lanes the columns, so a row's sums (G2's, e's, the c . S0^T dy
// terms) close in shuffles, in one order.
// Two launches agree bitwise. What holds it back: every product is
// scalar, from shared memory, with QC steps at once; the tensor cores
// (as the forward's HGMMA) are the way to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_tile.cuh"

namespace {

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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// db, dc (B, T, N) = the per-head gradients (B, H, T, N) summed over the
// heads in order
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

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const void* dstate, const void* state0, void* dx,
           void* da, void* db, void* dc, void* ds0, void* states, void* dbh,
           void* dch, int bsz, int h, int t_len, int p, int n,
           void* stream) {
  if (bsz < 1 || h < 1 || t_len < 1 || p < 1 || p > PMAX || n < 1 ||
      n > NMAX || (long long)bsz * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto head = ssd_bwd_head_kernel<T>;
  static const int err_smem = ftile::allow_smem(head, SMEM_BYTES);
  if (err_smem) return err_smem;
  auto st = static_cast<cudaStream_t>(stream);
  head<<<bsz * h, THREADS, SMEM_BYTES, st>>>(
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
