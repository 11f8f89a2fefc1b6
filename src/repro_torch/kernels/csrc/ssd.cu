// ssd: the Mamba-2 chunked state-space scan (state-space duality). For
// one (batch, head), over chunks of q <= 128 steps, with cum the running
// sum of the log decays a inside the chunk:
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
// the (P, N) state sits in VMEM across them. CUDA blocks run in no
// order and share nothing, so one block owns one (batch, head) and loops
// over the chunks itself, with S in shared memory for the whole sequence.
// The TPU kernel returns only y; this one also writes S at the end, which
// is what the model's ssd_scan returns and what prefill keeps as the
// decode cache, so the path needs no second pass.
//
// Shared memory is the constraint. A whole chunk in float32 at Q = 128,
// N = 128, P = 64 would need B and C (64 KB each), X and S (32 KB each)
// and the Q x Q score tile (64 KB): 256 KB, over the 227 KB a block may
// have. So the chunk's queries go in row blocks of R = 32: only C's 32
// rows and a 32 x 128 score tile are resident, with all of B and X (every
// key a query row may read) and S. That is 165 KB, in float32 whatever
// the input type, so float32 inputs lose nothing and bfloat16 inputs are
// widened once at the load. Row block r reads only key columns j < 32 (r +
// 1): the causal half is never computed.
//
// Bound on H100: operations. Per (batch, head, chunk) Q (Q + 1) / 2 (N +
// P) multiply-adds over the causal lower triangle of C B^T and its
// product with X, plus 2 Q P N for the state read and update (3.7 M at
// Q 128, N 128, P 64), against 2 Q P + 2 Q N + Q elements moved: ~75
// flops a byte at bfloat16 inputs, far above the float32 ridge.
// The design keeps the CUDA cores fed from registers: 256 threads as 8
// warps x 32 lanes; a warp shares its query rows (broadcast shared loads)
// and its lanes take consecutive key rows or columns (B, C and S rows at
// an odd stride of 129 floats, so the 32 lanes hit 32 banks). Each thread
// owns 4 x 4 scores, 4 x 2 outputs and 8 x 4 state entries. wgmma on bf16
// tiles is the later redesign.
#include "float_tile.cuh"

namespace {

using ftile::store;
using ftile::to_f;

constexpr int QMAX = 128;       // largest chunk
constexpr int NMAX = 128;       // largest state width
constexpr int PMAX = 64;        // largest head dim
constexpr int R = 32;           // query rows per row block
constexpr int THREADS = 256;    // 8 warps x 32 lanes
constexpr int NS = NMAX + 1;    // row stride of B, C and S (odd: no bank
                                // conflicts across lanes)
constexpr int GS = QMAX + 1;    // row stride of the score tile

constexpr size_t smem_floats() {
  return (size_t)QMAX * NS      // B, every key row of the chunk
         + (size_t)QMAX * PMAX  // X
         + (size_t)PMAX * NS    // S
         + (size_t)R * NS       // C, one row block
         + (size_t)R * GS       // scores of one row block, decay applied
         + 2 * QMAX;            // cum, exp(cum_last - cum)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ a,
           const T* __restrict__ b, const T* __restrict__ c,
           const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ s_out, int nh, int t_len, int q, int p_dim,
           int n_dim) {
  extern __shared__ float smem[];
  float* Bs = smem;                      // QMAX x NS
  float* Xs = Bs + QMAX * NS;            // QMAX x PMAX
  float* Ss = Xs + QMAX * PMAX;          // PMAX x NS
  float* Cs = Ss + PMAX * NS;            // R x NS
  float* Gs = Cs + R * NS;               // R x GS
  float* cum = Gs + R * GS;              // QMAX
  float* dout = cum + QMAX;              // QMAX

  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const long long bh = blockIdx.x;

  for (int i = tid; i < PMAX * NS; i += THREADS) {
    const int p = i / NS, n = i % NS;
    Ss[i] = (s0 != nullptr && p < p_dim && n < n_dim)
                ? s0[(bh * p_dim + p) * n_dim + n]
                : 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += q) {
    const int rows = min(q, t_len - t0);
    const long long row0 = (long long)bi * t_len + t0;   // (b, t0) row
    __syncthreads();                     // the last chunk's readers are done
    for (int i = tid; i < QMAX * NMAX; i += THREADS) {
      const int j = i / NMAX, n = i % NMAX;
      Bs[j * NS + n] =
          j < rows && n < n_dim ? to_f(b[(row0 + j) * n_dim + n]) : 0.f;
    }
    for (int i = tid; i < QMAX * PMAX; i += THREADS) {
      const int j = i / PMAX, p = i % PMAX;
      Xs[i] = j < rows && p < p_dim
                  ? to_f(x[((row0 + j) * nh + h) * p_dim + p])
                  : 0.f;
    }
    if (ty == 0) {                       // cum: one warp, 4 steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = tx * 4 + k;
        run += j < rows ? a[(row0 + j) * nh + h] : 0.f;
        v[k] = run;
      }
      float incl = run;                  // inclusive scan of lane totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tx >= off) incl += o;
      }
      const float base = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) cum[tx * 4 + k] = base + v[k];
    }
    __syncthreads();
    const float last = cum[rows - 1];
    if (tid < QMAX) dout[tid] = expf(last - cum[tid]);

    for (int i0 = 0; i0 < rows; i0 += R) {
      const int rb = i0 / R;
      __syncthreads();                   // the last row block's readers
      for (int i = tid; i < R * NMAX; i += THREADS) {
        const int r = i / NMAX, n = i % NMAX;
        Cs[r * NS + n] = i0 + r < rows && n < n_dim
                             ? to_f(c[(row0 + i0 + r) * n_dim + n])
                             : 0.f;
      }
      __syncthreads();
      // scores of rows i0 + ty + 8 ii against keys tx + 32 jj, jj <= rb
      float g[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) g[ii][jj] = 0.f;
#pragma unroll 4
      for (int n = 0; n < n_dim; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 8 * ii) * NS + n];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bv[jj] = jj <= rb ? Bs[(tx + 32 * jj) * NS + n] : 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            g[ii][jj] = fmaf(cv[ii], bv[jj], g[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = ty + 8 * ii, i = i0 + r;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tx + 32 * jj;
          if (jj <= rb)
            Gs[r * GS + j] = j <= i ? g[ii][jj] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
      __syncthreads();
      // y of rows i0 + ty + 8 ii, columns tx + 32 pp
      float yd[4][2], yo[4][2];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) yd[ii][pp] = yo[ii][pp] = 0.f;
      const int jend = i0 + R;
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float gv[4], xv[2];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) gv[ii] = Gs[(ty + 8 * ii) * GS + j];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) xv[pp] = Xs[j * PMAX + tx + 32 * pp];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
            yd[ii][pp] = fmaf(gv[ii], xv[pp], yd[ii][pp]);
      }
#pragma unroll 4
      for (int n = 0; n < n_dim; ++n) {
        float cv[4], sv[2];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 8 * ii) * NS + n];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) sv[pp] = Ss[(tx + 32 * pp) * NS + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
            yo[ii][pp] = fmaf(cv[ii], sv[pp], yo[ii][pp]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ty + 8 * ii;
        if (i >= rows) continue;
        const float din = expf(cum[i]);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int p = tx + 32 * pp;
          if (p < p_dim)
            store(y + ((row0 + i) * nh + h) * p_dim + p,
                  yd[ii][pp] + yo[ii][pp] * din);
        }
      }
    }
    __syncthreads();                     // every y has read the old S
    // S <- S exp(last) + sum_j dout_j x_j b_j^T, entries (ty + 8 pp, tx + 32 nn)
    float acc[8][4];
#pragma unroll
    for (int pp = 0; pp < 8; ++pp)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) acc[pp][nn] = 0.f;
#pragma unroll 2
    for (int j = 0; j < rows; ++j) {
      const float d = dout[j];
      float xv[8], bv[4];
#pragma unroll
      for (int pp = 0; pp < 8; ++pp) xv[pp] = Xs[j * PMAX + ty + 8 * pp] * d;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) bv[nn] = Bs[j * NS + tx + 32 * nn];
#pragma unroll
      for (int pp = 0; pp < 8; ++pp)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
          acc[pp][nn] = fmaf(xv[pp], bv[nn], acc[pp][nn]);
    }
    const float decay = expf(last);
#pragma unroll
    for (int pp = 0; pp < 8; ++pp)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        float* s = Ss + (ty + 8 * pp) * NS + tx + 32 * nn;
        *s = *s * decay + acc[pp][nn];
      }
  }
  __syncthreads();
  for (int i = tid; i < p_dim * n_dim; i += THREADS) {
    const int p = i / n_dim, n = i % n_dim;
    s_out[bh * p_dim * n_dim + i] = Ss[p * NS + n];
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* s0, void* y, void* s_out, int bsz, int nh, int t_len,
           int q, int p_dim, int n_dim, void* stream) {
  if (q < 1 || q > QMAX || p_dim < 1 || p_dim > PMAX || n_dim < 1 ||
      n_dim > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats() * sizeof(float);
  auto kernel = ssd_kernel<T>;
  static int smem_err = ftile::allow_smem(kernel, bytes);  // once per type
  if (smem_err) return smem_err;
  kernel<<<bsz * nh, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), nh, t_len, q, p_dim, n_dim);
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
