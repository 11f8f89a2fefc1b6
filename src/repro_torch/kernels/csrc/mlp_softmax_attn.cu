// mlp_softmax_attn: SelectFormer's MLP-emulated attention without the
// probabilities, out = relu((Q K^T * scale) @ W1 + b1) @ U + u0, where
// U = W2 @ V and u0 = b2 @ V come in precomputed (the same reassociation
// as the TPU kernel: probs @ V = relu(S W1 + b1) (W2 V) + b2 V), for
// q (BH, Sq, DH), k (BH / group, Skv, DH), w1 (Skv, hid), b1 (hid),
// u (BH / group, hid, DH), u0 (BH / group, DH); hid <= 64.
//
// Replaces the Pallas kernel repro/kernels/mlp_softmax_attn.py:
// mlp_softmax_attn (pallas_call at :74). There the sequential grid keeps
// H = S @ W1 (bq x hid) in VMEM scratch across the KV steps. Here one
// block owns a 64-row query tile and streams 64-row key tiles itself:
// the score tile lands in shared memory, H += S_tile @ W1[tile rows]
// accumulates in registers (four threads a row, hid / 4 columns each),
// and the epilogue applies relu(H + b1) @ U + u0 from shared memory. The
// S x S scores and probabilities never reach device memory. A ragged
// Skv is zero-filled: a zero key row gives a zero score, and the zero
// W1 row beside it adds nothing to H. Accumulation is float32; the
// output takes q's type.
//
// Bound on H100: operations. 2 * BH * Sq * Skv * (DH + hid) flops for
// Q K^T and S W1 against (2 * BH * S * DH + Skv * hid) elements moved —
// about 80 flops per byte at S = 512, DH = 64, hid = 16, above the
// float32 ridge. As in flash_attn.cu the score micro-tile keeps four
// multiply-adds per shared load on the CUDA cores.
#include "float_tile.cuh"

namespace {

using namespace ftile;

constexpr int HID_MAX = 64;
constexpr int HJ = HID_MAX / 4;        // H columns per thread, at most

template <int DH>
constexpr size_t smem_floats() {
  return (size_t)BQ * (DH + 1) + BK * (DH + 1) + BQ * (BK + 1) +
         BK * HID_MAX;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
mlp_softmax_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ u,
                        const float* __restrict__ u0, T* __restrict__ o,
                        int nq, int group, int sq, int skv, int hid,
                        float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // BQ x (DH + 1)
  float* Ks = Qs + BQ * (DH + 1);        // BK x (DH + 1); U in the epilogue
  float* Ss = Ks + BK * (DH + 1);        // BQ x (BK + 1); relu(H + b1) last
  float* Ws = Ss + BQ * (BK + 1);        // BK x hid: this tile's W1 rows

  const int bh = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const long long kvh = bh / group;
  const T* kb = k + kvh * skv * DH;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int hr = t / 4, hc = t % 4;      // H row, first H column
  const int nh = (hid - hc + 3) / 4;     // this thread's H columns

  load_rows<T, BQ, DH>(Qs, DH + 1, q + (long long)bh * sq * DH, q0, sq);
  float h[HJ];
#pragma unroll
  for (int j = 0; j < HJ; ++j) h[j] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += BK) {
    __syncthreads();                     // last tile's readers are done
    load_rows<T, BK, DH>(Ks, DH + 1, kb, k0, skv);
    for (int i = t; i < BK * hid; i += THREADS)
      Ws[i] = k0 + i / hid < skv ? w1[(long long)k0 * hid + i] : 0.f;
    __syncthreads();
    float s[4][4];
    score_tile<DH>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();
    // H += S_tile @ W1[k0 : k0 + BK]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float sv = Ss[hr * (BK + 1) + kk];
      const float* wrow = Ws + kk * hid + hc;
#pragma unroll
      for (int j = 0; j < HJ; ++j)
        if (j < nh) h[j] = fmaf(sv, wrow[4 * j], h[j]);
    }
  }
  __syncthreads();
  // epilogue: relu(H + b1) into Ss, U into Ks, then out = relu(H) U + u0
#pragma unroll
  for (int j = 0; j < HJ; ++j)
    if (j < nh) {
      const int c = hc + 4 * j;
      Ss[hr * (BK + 1) + c] = fmaxf(h[j] + b1[c], 0.f);
    }
  const float* ub = u + kvh * hid * DH;
  for (int i = t; i < hid * DH; i += THREADS) Ks[i] = ub[i];
  __syncthreads();
  constexpr int CJ = DH / 16;
  const float* u0b = u0 + kvh * DH;
  T* ob = o + (long long)bh * sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int d = tx + 16 * j;
      float acc = 0.f;
      for (int c = 0; c < hid; ++c)
        acc = fmaf(Ss[r * (BK + 1) + c], Ks[c * DH + d], acc);
      store(ob + (long long)(q0 + r) * DH + d, acc + u0b[d]);
    }
  }
}

template <typename T, int DH>
int run(const void* q, const void* k, const float* w1, const float* b1,
        const float* u, const float* u0, void* o, int bh, int group, int sq,
        int skv, int hid, float scale, void* stream) {
  const size_t bytes = smem_floats<DH>() * sizeof(float);
  auto kernel = mlp_softmax_attn_kernel<T, DH>;
  static int smem_err = allow_smem(kernel, bytes);   // once per instance
  if (smem_err) return smem_err;
  const int nq = (sq + BQ - 1) / BQ;
  kernel<<<nq * bh, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), w1, b1, u, u0,
      static_cast<T*>(o), nq, group, sq, skv, hid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* w1, const void* b1,
           const void* u, const void* u0, void* o, int bh, int group, int sq,
           int skv, int dh, int hid, float scale, void* stream) {
  if (hid < 1 || hid > HID_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto* f1 = static_cast<const float*>(w1);
  const auto* fb = static_cast<const float*>(b1);
  const auto* fu = static_cast<const float*>(u);
  const auto* f0 = static_cast<const float*>(u0);
  switch (dh) {
    case 16: return run<T, 16>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, scale, stream);
    case 32: return run<T, 32>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, scale, stream);
    case 64: return run<T, 64>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, scale, stream);
    case 128: return run<T, 128>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mlp_softmax_attn_f32(const void* q, const void* k,
                                    const void* w1, const void* b1,
                                    const void* u, const void* u0, void* o,
                                    int bh, int group, int sq, int skv,
                                    int dh, int hid, float scale,
                                    void* stream) {
  return launch<float>(q, k, w1, b1, u, u0, o, bh, group, sq, skv, dh, hid,
                       scale, stream);
}

extern "C" int mlp_softmax_attn_bf16(const void* q, const void* k,
                                     const void* w1, const void* b1,
                                     const void* u, const void* u0, void* o,
                                     int bh, int group, int sq, int skv,
                                     int dh, int hid, float scale,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, w1, b1, u, u0, o, bh, group, sq, skv,
                               dh, hid, scale, stream);
}
