// mlp_softmax_attn: SelectFormer's MLP-emulated attention without the
// probabilities,
//   out = relu((Q K^T * scale) W1 + b1) U + u0,  U = W2 V,  u0 = b2 V,
// for q (BH, Sq, DH), k (BH / group, Skv, DH), w1 (Skv, hid), b1 (hid),
// and U (BH / group, hid, DH) and u0 (BH / group, DH), made by the wrapper
// in two plain products W2 @ V and b2 @ V; hid <= 64, DH in
// {16, 32, 64, 128}.
//
// Replaces the Pallas kernel repro/kernels/mlp_softmax_attn.py:
// mlp_softmax_attn (pallas_call at :74). There the sequential grid forms
// each score tile S = Q K^T and keeps H = S W1 (bq x hid) in VMEM scratch
// across the key steps. Here nothing forms a score: S W1 is linear in S,
// so S W1 = Q (scale K^T W1) = Q A, and A (DH x hid) is one Skv-long
// reduction a head. The function then costs 2 BH (Skv + 2 Sq) DH hid
// multiply-add flops (plus the wrapper's W2 V and b2 V), against
// 2 BH Sq Skv (DH + hid) for the score form.
//
// Bound on the H100: bytes (`work` in kernels/mlp_softmax_attn.py). The
// clear sieve's phase-2 case (48, 512, 64), hid 16, float32 moves 25.2 MB
// (q, k, v, out and the emulator's weights: 7.5 us at 3.35 TB/s) and does
// 0.20 GFLOP (3.0 us on the CUDA cores' 67 TFLOP/s); about 8 flops a
// byte, far below the float32 ridge. So the products stay on the CUDA
// cores: the tensor cores would shorten the smaller of the two times.
//
// Design: one thread-block cluster a q head (cudaLaunchKernelEx with a
// cluster dimension; a refused launch returns its error, and the wrapper
// raises). A cluster holds C blocks, C = the head's 64-row query tiles,
// at most 8 (`plan` in the wrapper); block r walks query tiles r, r + C,
// ... and owns key rows [r L, r L + L), L = ceil(Skv / C).
// - At its start a block issues its first key chunk (K rows and the W1
//   rows beside them), its first Q tile, U and u0, all as cp.async copies
//   that complete on an mbarrier: 16 bytes a copy, 4 at the unaligned
//   edges of the W1 span; ragged rows are zero-filled. bf16 stays bf16 in
//   shared memory and every sum is float32.
// - It reduces A_r = scale K[slice]^T W1[slice] over its key chunks (two
//   buffers when the slice takes more than one), Q's copy landing
//   meanwhile. A thread owns a 4 x 4 tile of A (4 of DH, 4 of hid); the
//   tiles' count P = DH/4 x ceil(hid/4) is below 256 on the path, so the
//   256 / P groups of threads split the keys and sum their tiles in
//   group order through shared memory.
// - After a cluster barrier, block r sums its share (1/C) of A's
//   elements over A_0 ... A_{C-1}, in rank order, reading them from the
//   peers' shared memory, and writes the sums into every block's A
//   (distributed shared memory, addressed with `mapa` as
//   cluster.map_shared_rank does). A second cluster barrier then leaves
//   every block holding the same A, bitwise, at every launch, and no
//   block touches another's shared memory after it, so none exits while
//   a peer still reads it. No atomics.
// - Per query tile: H = relu(Q A + b1) into shared memory (a thread
//   takes two rows and four columns), then out = H U + u0, 16-byte
//   stores (4 float32 or 8 bf16 a thread).
// On the path four blocks share a SM (50 KB of shared memory, 64
// registers), so the 48 clusters of 8 are resident at once.
#include <cooperative_groups.h>
#include <stdint.h>

#include "float_tile.cuh"
#include "hopper_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using hopper::cp_async4;
using hopper::cp_async16;
using hopper::cp_async_arrive;
using hopper::fence_mbar_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows a tile
constexpr int HID_MAX = 64;
constexpr int CLUSTER_MAX = 8;

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// key rows a chunk: 64, or 32 at DH 128 so that two chunk buffers fit
template <int DH>
constexpr int key_chunk() { return DH == 128 ? 32 : 64; }

// The shared-memory layout, in bytes from the (128-aligned) base; the
// host sizes the launch with it and the kernel finds its buffers with it.
template <typename T, int DH>
struct Layout {
  static constexpr int KC = key_chunk<DH>();
  static constexpr int QLD = DH * (int)sizeof(T) + 16;   // padded Q row
  int hp, ksplit, qs, us, ar, as, bs, ks, kbuf, ws, wbuf, xs, bytes;
  __host__ __device__ Layout(int hid, int nbuf) {
    hp = (hid + 3) / 4 * 4;                  // hid padded to 4 columns
    const int p = DH / 4 * (hp / 4);         // 4 x 4 tiles of A
    ksplit = p >= THREADS ? 1 : THREADS / p;
    qs = 32;                                 // after three mbarriers
    us = qs + BQ * QLD;
    ar = us + align16((hid + 1) * DH * 4);
    as = ar + DH * hp * 4;
    bs = as + DH * hp * 4;                   // b1
    // one region, used in turn by the key chunks and their W1 rows, the
    // split sums, then H
    ks = bs + HID_MAX * 4;
    kbuf = KC * DH * (int)sizeof(T);
    ws = ks + nbuf * kbuf;
    wbuf = align16(KC * hid * 4) + 16;       // + the span's misalignment
    xs = ks;
    const int chunks = nbuf * (kbuf + wbuf);
    const int scratch = ksplit > 1 ? ksplit * p * 16 * 4 : 0;
    const int h = BQ * hp * 4;
    const int region = chunks > scratch ? chunks : scratch;
    bytes = ks + (region > h ? region : h);
  }
};

// four consecutive elements of shared memory, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 16 bytes of output: four float32, or eight bf16
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 r;
  r.x = hopper::pack_bf16(v[0], v[1]);
  r.y = hopper::pack_bf16(v[2], v[3]);
  r.z = hopper::pack_bf16(v[4], v[5]);
  r.w = hopper::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = r;
}

// 16 bytes from `src` (its first `n` of them, 0..16; the rest zero)
__device__ __forceinline__ void cp_async16n(uint32_t dst, const void* src,
                                            int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// Bytes [0, n) of `src` into shared `dst` and zeros into [n, total), both
// multiples of 4, dst and src equal modulo 16: 16-byte copies, 4-byte ones
// before the first 16-byte boundary and after the last. The copy loops
// stay rolled: a block runs each of its phases once, so the kernel's
// time grows with its code, which is fetched as it runs.
__device__ __forceinline__ void copy_span(uint32_t dst, const char* src,
                                          int n, int total) {
  const int head = min((int)((16 - (dst & 15)) & 15), total);
  const int body = (total - head) / 16;
  const int tail0 = head + body * 16;
#pragma unroll 1
  for (int x = threadIdx.x; x < head / 4; x += THREADS)
    cp_async4(dst + 4 * x, 4 * x < n ? src + 4 * x : src, 4 * x < n);
#pragma unroll 1
  for (int x = threadIdx.x; x < body; x += THREADS) {
    const int off = head + 16 * x;
    const int m = max(0, min(16, n - off));
    cp_async16n(dst + off, m ? src + off : src, m);
  }
#pragma unroll 1
  for (int x = threadIdx.x; x < (total - tail0) / 4; x += THREADS) {
    const int off = tail0 + 4 * x;
    cp_async4(dst + off, off < n ? src + off : src, off < n);
  }
}

// Q tile rows [q0, q0 + BQ) of one head into the padded tile, rows past
// sq zero-filled
template <typename T, int DH>
__device__ __forceinline__ void copy_q(uint32_t dst, const T* qh, int q0,
                                       int sq) {
  constexpr int CPR = DH * (int)sizeof(T) / 16;          // copies a row
#pragma unroll 1
  for (int x = threadIdx.x; x < BQ * CPR; x += THREADS) {
    const int r = x / CPR, c = x % CPR;
    const bool ok = q0 + r < sq;
    const char* src = reinterpret_cast<const char*>(
        qh + (long long)(ok ? q0 + r : 0) * DH) + 16 * c;
    cp_async16(dst + r * Layout<T, DH>::QLD + 16 * c, src, ok);
  }
}

// Distributed shared memory: `mapa` gives the address of the same
// variable in cluster block `rank`'s shared memory (what
// cluster.map_shared_rank computes), read and written through the
// shared::cluster window, so the values stay in registers.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_peer(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_peer(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 4 : 2)
mlp_softmax_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ u,
                        const float* __restrict__ u0, T* __restrict__ o,
                        int group, int sq, int skv, int hid, int slice,
                        int nbuf, float scale) {
  using L = Layout<T, DH>;
  constexpr int KC = L::KC, DG = DH / 4;
  constexpr int MT = DH * HID_MAX / 16 > THREADS ? 2 : 1;   // tiles a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(hid, nbuf);
  const uint32_t base = smem_u32(smem);
  const uint32_t kbar = base, qbar = base + 16;   // key buffers 0, 1; Q

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / nc;
  const long long kvh = bh / group;
  const int t = threadIdx.x;
  const int nq = (sq + BQ - 1) / BQ;
  const T* qh = q + (long long)bh * sq * DH;
  const float* uh = u + kvh * hid * DH;
  const float* u0h = u0 + kvh * DH;

  // this block's key rows [j0, j0 + n), in chunks of KC
  const int j0 = min(skv, rank * slice);
  const int n = min(skv, j0 + slice) - j0;
  const int nchunks = (n + KC - 1) / KC;
  auto issue_chunk = [&](int ch) {
    const int b = ch % nbuf, r0 = ch * KC, rows = min(KC, n - r0);
    const T* ksrc = k + (kvh * skv + j0 + r0) * DH;
    copy_span(base + lay.ks + b * lay.kbuf,
              reinterpret_cast<const char*>(ksrc),
              rows * DH * (int)sizeof(T), lay.kbuf);
    const float* wsrc = w1 + (long long)(j0 + r0) * hid;
    const int mis = (int)(reinterpret_cast<uintptr_t>(wsrc) & 15);
    copy_span(base + lay.ws + b * lay.wbuf + mis,
              reinterpret_cast<const char*>(wsrc), rows * hid * 4,
              KC * hid * 4);
    cp_async_arrive(kbar + 8 * b);
  };

  if (t == 0) {
    mbar_init(kbar, THREADS);
    mbar_init(kbar + 8, THREADS);
    mbar_init(qbar, THREADS);
    fence_mbar_init();
  }
  __syncthreads();
  for (int ch = 0; ch < min(nbuf, nchunks); ++ch) issue_chunk(ch);
  float* bs = reinterpret_cast<float*>(smem + lay.bs);
  if (t < hid) bs[t] = b1[t];
  copy_q<T, DH>(base + lay.qs, qh, rank * BQ, sq);
  copy_span(base + lay.us, reinterpret_cast<const char*>(uh), hid * DH * 4,
            hid * DH * 4);
  copy_span(base + lay.us + hid * DH * 4, reinterpret_cast<const char*>(u0h),
            DH * 4, DH * 4);
  cp_async_arrive(qbar);

  // ---- A_r = scale K[slice]^T W1[slice] ---------------------------------
  // tile mt = dg * ncg + cg holds A[4 dg .. 4 dg + 3][4 cg .. 4 cg + 3];
  // with ksplit > 1, thread t owns tile t % P over keys t / P + m ksplit
  const int ncg = lay.hp / 4, p = DG * ncg;
  const int split = lay.ksplit > 1 ? t / p : 0;
  // this thread's m-th tile, or p for none
  auto tile_of = [&](int m) {
    if (lay.ksplit == 1) return min(p, t + m * THREADS);
    return m == 0 && t < lay.ksplit * p ? t % p : p;
  };
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
  const unsigned char* kbase = smem + lay.ks;
  const unsigned char* wbase = smem + lay.ws;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int b = ch % nbuf;
    mbar_wait(kbar + 8 * b, (ch / nbuf) & 1);
    const T* kc = reinterpret_cast<const T*>(kbase + b * lay.kbuf);
    const int mis = (int)(reinterpret_cast<uintptr_t>(
                              w1 + (long long)(j0 + ch * KC) * hid) & 15);
    const float* wc =
        reinterpret_cast<const float*>(wbase + b * lay.wbuf + mis);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = tile_of(m);
      if (mt == p) continue;
      const int dg = mt / ncg, c0 = mt % ncg * 4;
      const int cw = min(4, hid - c0);
      const bool w16 = mis == 0 && hid % 4 == 0;    // W1 rows 16-aligned
      for (int j = split; j < KC; j += lay.ksplit) {
        const float4 kv = load4(kc + j * DH + 4 * dg);
        float w[4];
        if (w16) {
          const float4 wv = load4(wc + j * hid + c0);
          w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w[c] = c < cw ? wc[j * hid + c0 + c] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][c] = fmaf(kv.x, w[c], acc[m][c]);
          acc[m][4 + c] = fmaf(kv.y, w[c], acc[m][4 + c]);
          acc[m][8 + c] = fmaf(kv.z, w[c], acc[m][8 + c]);
          acc[m][12 + c] = fmaf(kv.w, w[c], acc[m][12 + c]);
        }
      }
    }
    if (ch + nbuf < nchunks) {
      __syncthreads();                   // every reader is done with buffer b
      issue_chunk(ch + nbuf);
    }
  }
  float* ar = reinterpret_cast<float*>(smem + lay.ar);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  __syncthreads();                       // the key chunks are read
  // each tile into A_r (ksplit 1) or into its key group's copy of A
  float* dst = lay.ksplit == 1 ? ar : xs + split * DH * lay.hp;
  const float sc = lay.ksplit == 1 ? scale : 1.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = tile_of(m);
    if (mt == p) continue;
    const int dg = mt / ncg, c0 = mt % ncg * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(dst + (4 * dg + r) * lay.hp + c0) =
          make_float4(acc[m][4 * r] * sc, acc[m][4 * r + 1] * sc,
                      acc[m][4 * r + 2] * sc, acc[m][4 * r + 3] * sc);
  }
  if (lay.ksplit > 1) {                  // the key groups' sum, in order
    __syncthreads();
    const int n4 = DH * lay.hp / 4;
    const float4* x4 = reinterpret_cast<const float4*>(xs);
    for (int e = t; e < n4; e += THREADS) {
      float4 s = x4[e];
      for (int g = 1; g < lay.ksplit; ++g) {
        const float4 v = x4[g * n4 + e];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      reinterpret_cast<float4*>(ar)[e] =
          make_float4(s.x * scale, s.y * scale, s.z * scale, s.w * scale);
    }
  }

  // ---- A = A_0 + ... + A_{C-1}, in rank order, through the peers' smem:
  // block r sums its share of A's elements and writes it to every block
  cluster_arrive();
  cluster_wait();
  float* as = reinterpret_cast<float*>(smem + lay.as);
  const int n4 = DH * lay.hp / 4, share = (n4 + nc - 1) / nc;
  for (int e = rank * share + t; e < min(n4, (rank + 1) * share);
       e += THREADS) {
    float4 v[CLUSTER_MAX];               // every peer's load in flight
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < nc)
        v[r] = ld_peer(peer_addr(ar + 4 * e, r));
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < CLUSTER_MAX; ++r)
      if (r < nc) {
        s.x += v[r].x; s.y += v[r].y; s.z += v[r].z; s.w += v[r].w;
      }
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < nc)
        st_peer(peer_addr(as + 4 * e, r), s);
  }
  cluster_arrive();                      // every block's A is whole, and
  cluster_wait();                        // no peer touches this smem again

  // ---- per query tile: H = relu(Q A + b1), out = H U + u0 ---------------
  const T* qs = reinterpret_cast<const T*>(smem + lay.qs);
  const float* us = reinterpret_cast<const float*>(smem + lay.us);
  float* hs = xs;
  constexpr int VEC = 16 / (int)sizeof(T);               // outputs a store
  constexpr int DGV = DH / VEC;
  constexpr int RG = THREADS / DGV;                      // rows a pass
  constexpr int RPT = RG >= BQ ? 1 : BQ / RG;            // rows a thread
  const int dv = t % DGV, rg = t / DGV;
  int it = 0;
  for (int tile = rank; tile < nq; tile += nc, ++it) {
    const int q0 = tile * BQ;
    mbar_wait(qbar, it & 1);
    // rows i and i + 32 and four columns a thread: each A load serves two
    // rows
    for (int item = t; item < BQ / 2 * ncg; item += THREADS) {
      const int i = item / ncg, c0 = item % ncg * 4;
      const T* qr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        qr[rr] = reinterpret_cast<const T*>(
            reinterpret_cast<const unsigned char*>(qs) +
            (i + rr * BQ / 2) * L::QLD);
      float h[2][4] = {};
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float qa[2][4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float4 qv = load4(qr[rr] + d);
          qa[rr][0] = qv.x; qa[rr][1] = qv.y; qa[rr][2] = qv.z;
          qa[rr][3] = qv.w;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 a = load4(as + (d + x) * lay.hp + c0);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            h[rr][0] = fmaf(qa[rr][x], a.x, h[rr][0]);
            h[rr][1] = fmaf(qa[rr][x], a.y, h[rr][1]);
            h[rr][2] = fmaf(qa[rr][x], a.z, h[rr][2]);
            h[rr][3] = fmaf(qa[rr][x], a.w, h[rr][3]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          h[rr][c] = c0 + c < hid ? fmaxf(h[rr][c] + bs[c0 + c], 0.f) : 0.f;
        *reinterpret_cast<float4*>(hs + (i + rr * BQ / 2) * lay.hp + c0) =
            make_float4(h[rr][0], h[rr][1], h[rr][2], h[rr][3]);
      }
    }
    __syncthreads();                     // H is whole; Q is free
    if (tile + nc < nq) {
      copy_q<T, DH>(base + lay.qs, qh, (tile + nc) * BQ, sq);
      cp_async_arrive(qbar);
    }
    if (rg < BQ) {
      float acc_o[RPT][VEC];
#pragma unroll
      for (int m = 0; m < RPT; ++m)
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc_o[m][x] = 0.f;
      for (int c0 = 0; c0 < lay.hp; c0 += 4) {
        float hv[RPT][4];
#pragma unroll
        for (int m = 0; m < RPT; ++m) {
          const float4 h = load4(hs + (rg + m * RG) * lay.hp + c0);
          hv[m][0] = h.x; hv[m][1] = h.y; hv[m][2] = h.z; hv[m][3] = h.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c0 + c >= hid) break;
          const float* ur = us + (c0 + c) * DH + dv * VEC;
#pragma unroll
          for (int x = 0; x < VEC; x += 4) {
            const float4 u = load4(ur + x);
#pragma unroll
            for (int m = 0; m < RPT; ++m) {
              acc_o[m][x] = fmaf(hv[m][c], u.x, acc_o[m][x]);
              acc_o[m][x + 1] = fmaf(hv[m][c], u.y, acc_o[m][x + 1]);
              acc_o[m][x + 2] = fmaf(hv[m][c], u.z, acc_o[m][x + 2]);
              acc_o[m][x + 3] = fmaf(hv[m][c], u.w, acc_o[m][x + 3]);
            }
          }
        }
      }
      const float* u0s = us + hid * DH + dv * VEC;
      T* ob = o + (long long)bh * sq * DH;
#pragma unroll
      for (int m = 0; m < RPT; ++m) {
        const int r = q0 + rg + m * RG;
        if (r >= sq) continue;
#pragma unroll
        for (int x = 0; x < VEC; ++x) acc_o[m][x] += u0s[x];
        store16(ob + (long long)r * DH + dv * VEC, acc_o[m]);
      }
    }
    __syncthreads();                     // H is read before the next tile
  }
}

template <typename T, int DH>
int run(const void* q, const void* k, const float* w1, const float* b1,
        const float* u, const float* u0, void* o, int bh, int group, int sq,
        int skv, int hid, int nc, int slice, float scale, void* stream) {
  constexpr int KC = key_chunk<DH>();
  const int nbuf = slice > KC ? 2 : 1;
  const int bytes = Layout<T, DH>(hid, nbuf).bytes;
  auto kernel = mlp_softmax_attn_kernel<T, DH>;
  // once per instantiation: the most any hid or buffer count takes
  static const int smem_err = ftile::allow_smem(
      kernel, (size_t)Layout<T, DH>(HID_MAX, 2).bytes);
  if (smem_err) return smem_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * nc);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k), w1,
      b1, u, u0, static_cast<T*>(o), group, sq, skv, hid, slice, nbuf,
      scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* w1, const void* b1,
           const void* u, const void* u0, void* o, int bh, int group, int sq,
           int skv, int dh, int hid, int nc, int slice, float scale,
           void* stream) {
  if (hid < 1 || hid > HID_MAX || nc < 1 || nc > CLUSTER_MAX || sq < 1 ||
      (long long)slice * nc < skv ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(u0) |
        reinterpret_cast<uintptr_t>(o)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f1 = static_cast<const float*>(w1);
  const auto* fb = static_cast<const float*>(b1);
  const auto* fu = static_cast<const float*>(u);
  const auto* f0 = static_cast<const float*>(u0);
  switch (dh) {
    case 16: return run<T, 16>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, nc, slice, scale, stream);
    case 32: return run<T, 32>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, nc, slice, scale, stream);
    case 64: return run<T, 64>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, nc, slice, scale, stream);
    case 128: return run<T, 128>(q, k, f1, fb, fu, f0, o, bh, group, sq, skv, hid, nc, slice, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mlp_softmax_attn_f32(const void* q, const void* k,
                                    const void* w1, const void* b1,
                                    const void* u, const void* u0, void* o,
                                    int bh, int group, int sq, int skv,
                                    int dh, int hid, int nc, int slice,
                                    float scale, void* stream) {
  return launch<float>(q, k, w1, b1, u, u0, o, bh, group, sq, skv, dh, hid,
                       nc, slice, scale, stream);
}

extern "C" int mlp_softmax_attn_bf16(const void* q, const void* k,
                                     const void* w1, const void* b1,
                                     const void* u, const void* u0, void* o,
                                     int bh, int group, int sq, int skv,
                                     int dh, int hid, int nc, int slice,
                                     float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, w1, b1, u, u0, o, bh, group, sq, skv, dh,
                               hid, nc, slice, scale, stream);
}
