// flash_attn: exact online-softmax attention, out = softmax(Q K^T * scale)
// V, for q (BH, Sq, DH) and k, v (BH / group, Skv, DH) — grouped-query
// attention reads kv head bh / group, so K and V are never repeated.
//
// Replaces the Pallas kernel repro/kernels/flash_attn.py:flash_attn
// (pallas_call at :69). The TPU kernel walks a sequential grid with the
// KV axis innermost and keeps (m, l, acc) in VMEM scratch across grid
// steps. CUDA blocks run in no order, so here one block owns a 64-row
// query tile and loops over the key tiles itself, with the running row
// max m and sum l in shared memory and acc in registers; the S x S score
// matrix never leaves the block. The causal form skips key tiles wholly
// above the diagonal (k0 > q0 + 63), as the TPU kernel's pl.when does.
// A causal `window` w > 0 (the "local" mask of repro/models/common.py:
// key k attends query q when q - w < k <= q) also masks k <= q - w and
// skips the key tiles wholly below the tile's first window (the window
// is the port's addition: the Pallas kernel has none). A row may find
// every key of its first tile masked; NEG_INF is finite, so that tile
// adds exp(0) terms that the next tile's rescale exp(NEG_INF - m)
// multiplies by 0, and the diagonal key keeps every row non-empty.
// Rows and columns past the sequence are zero-filled and masked, so a
// ragged S needs no padding. Accumulation is float32 whatever the input
// type; the output takes the input's type.
//
// Bound on H100: operations. 4 * BH * Sq * Skv * DH multiply-adds' worth
// of float32 work against 4 * BH * S * DH elements moved — at S = 512,
// DH = 64 that is 128 flops per byte, far above the card's 20 flop/byte
// float32 ridge. Float32 inputs have no exact tensor-core path, so the
// design keeps the CUDA cores fed from registers: each thread owns a
// 4 x 4 score micro-tile and a 4 x DH/16 slice of acc, and every shared
// load feeds four multiply-adds. A wgmma (bf16) / TMA pipeline is the
// later redesign.
//
// Head dims 16, 32, 64, 128 and 256 are instantiated (RecurrentGemma's
// attention layers have Dh 256). At Dh 256 the same 64 x 64 tiling needs
// 53,632 floats = 214.5 KB of shared memory (smem_floats), under the
// 227 KB a block may have, one block an SM; each thread's acc slice is
// 4 x 16 floats.
#include "float_tile.cuh"

namespace {

using namespace ftile;

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1) +
         3 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int nq,
                  int group, int sq, int skv, int causal, int window,
                  float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // BQ x (DH + 1)
  float* Ks = Qs + BQ * (DH + 1);        // BK x (DH + 1)
  float* Vs = Ks + BK * (DH + 1);        // BK x DH
  float* Ss = Vs + BK * DH;              // BQ x (BK + 1): scores, then p
  float* m_s = Ss + BQ * (BK + 1);       // running row max
  float* l_s = m_s + BQ;                 // running row sum
  float* a_s = l_s + BQ;                 // this tile's rescale factor

  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const long long kvh = bh / group;
  const T* kb = k + kvh * skv * DH;
  const T* vb = v + kvh * skv * DH;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int warp = t / 32, lane = t % 32;
  constexpr int CJ = DH / 16;

  load_rows<T, BQ, DH>(Qs, DH + 1, q + (long long)bh * sq * DH, q0, sq);
  if (t < BQ) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  const int kend = causal ? min(skv, q0 + BQ) : skv;
  const int kbeg = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();                     // last tile's readers are done
    load_rows<T, BK, DH>(Ks, DH + 1, kb, k0, skv);
    load_rows<T, BK, DH>(Vs, DH, vb, k0, skv);
    __syncthreads();
    float s[4][4];
    score_tile<DH>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int key = k0 + c, query = q0 + r;
        const bool masked = key >= skv || (causal && key > query) ||
                            (window > 0 && key <= query - window);
        Ss[r * (BK + 1) + c] = masked ? NEG_INF : s[i][j] * scale;
      }
    __syncthreads();
    // online softmax: each warp updates BQ / 8 rows, two columns a lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = Ss + r * (BK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[kk * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  T* ob = o + (long long)bh * sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      store(ob + (long long)(q0 + r) * DH + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int DH>
int run(const void* q, const void* k, const void* v, void* o, int bh,
        int group, int sq, int skv, int causal, int window, float scale,
        void* stream) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  auto kernel = flash_attn_kernel<T, DH>;
  static int smem_err = allow_smem(kernel, bytes);   // once per instance
  if (smem_err) return smem_err;
  const int nq = (sq + BQ - 1) / BQ;
  kernel<<<nq * bh, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), nq, group, sq, skv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int group, int sq, int skv, int dh, int causal, int window,
           float scale, void* stream) {
  if (window > 0 && !causal)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16:
      return run<T, 16>(q, k, v, o, bh, group, sq, skv, causal, window,
                        scale, stream);
    case 32:
      return run<T, 32>(q, k, v, o, bh, group, sq, skv, causal, window,
                        scale, stream);
    case 64:
      return run<T, 64>(q, k, v, o, bh, group, sq, skv, causal, window,
                        scale, stream);
    case 128:
      return run<T, 128>(q, k, v, o, bh, group, sq, skv, causal, window,
                        scale, stream);
    case 256:
      return run<T, 256>(q, k, v, o, bh, group, sq, skv, causal, window,
                        scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int bh, int group, int sq, int skv,
                              int dh, int causal, int window, float scale,
                              void* stream) {
  return launch<float>(q, k, v, o, bh, group, sq, skv, dh, causal, window,
                       scale, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int bh, int group, int sq, int skv,
                               int dh, int causal, int window, float scale,
                               void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, group, sq, skv, dh, causal,
                               window, scale, stream);
}
