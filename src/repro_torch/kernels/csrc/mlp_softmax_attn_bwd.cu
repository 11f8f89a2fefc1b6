// mlp_softmax_attn backward: the gradient of
//   out = relu(q A + b1) U + u0,  A = scale K^T W1,  U = W2 V,  u0 = b2 V,
// for q, do (BH, Sq, DH), k, v (BH / group, Skv, DH), w1 (Skv, hid), b1
// (hid), w2 (hid, Skv), b2 (Skv); hid <= 64, DH in {16, 32, 64, 128}.
// With Z = q A + b1 and H = relu(Z):
//   dH = do U^T,  dZ = dH * [Z > 0],  dq = dZ A^T,
// per kv head, summed over its group's query rows:
//   dA = q^T dZ,  dU = H^T do,  du0 = sum do,  db1 = sum dZ,
// per key row:  dk = scale W1 dA^T,  dv = W2^T dU + b2 du0,
// and over all heads:  dw1 = scale sum K dA,  dw2 = sum dU V^T,
// db2 = sum V du0,  db1 = sum dZ.
//
// Replaces no Pallas kernel: the JAX package has no backward kernel (no
// custom_vjp under src/repro/kernels/), and its in-vivo training
// differentiates the materialized MLP_sm attention by autodiff. Like the
// forward (mlp_softmax_attn.cu), it never forms an S x S tile: the
// reassociation through A and U carries over to the gradient.
//
// Bound on the H100: bytes (`bwd_work` in kernels/mlp_softmax_attn.py).
// At in-vivo phase 2's (96, 512, 64), hid 16, float32 the function moves
// q, do, dq, k, v, dk and dv once (88 MB: 26.3 us at 3.35 TB/s) and does
// about 1.1 GFLOP (eleven DH x hid products a row), 16.5 us on the CUDA
// cores' 67 TFLOP/s: about 12 flops a byte, so the products stay on the
// CUDA cores, as register tiles over shared memory. Measured on an H100,
// the same kernel with every product on the tensor cores (mma.sync
// m16n8k8, 3xTF32) was slower (PERF.md): a block's phases are bound by
// latency and barriers, not by its multiply-adds.
//
// Design: two launches, no atomics, every sum in a fixed order (a second
// call is bitwise equal).
// 1. msa_bwd_heads_kernel: one thread-block cluster a kv head
//    (cudaLaunchKernelEx with a cluster dimension; `bwd_plan` in the
//    wrapper). Its work items are the (q head of the group, 64-row query
//    tile) pairs; the cluster has C blocks (a power of two up to 8 and
//    the items, as many as let the heads' clusters run in one wave: 2 at
//    the in-vivo path's 96 heads, 8 at phase 1's 8), block r walks items
//    r, r + C, ... and owns key rows [r L, r L + L), L = ceil(Skv / C),
//    taken in chunks of KC rows (the K, V, W1, W2 and b2 rows of a
//    chunk: K, V and W1 by 16-byte cp.async, W2 transposed and b2 by
//    4-byte ones, on an mbarrier; ragged rows zero-filled).
//    (a) Block r reduces A_r = scale K_r^T W1_r and U_r^T = V_r^T W2_r^T
//        over its key rows (a thread owns 4 x 4 tiles of both; with fewer
//        tiles than threads, KSPLIT groups of threads split the rows and
//        are summed in group order). After a cluster barrier, block r sums
//        its share of the elements over A_0 ... A_{C-1} in rank order,
//        reading them from the peers' shared memory, and writes the sums
//        into every block (distributed shared memory, `mapa` addresses, as
//        the forward sums A); a second barrier leaves every block holding
//        the same A and U^T, bitwise.
//    (b) Per work item (the Q and dO tile by 16-byte cp.async on an
//        mbarrier; rows past Sq zero-filled, which zeroes their share of
//        every sum): Z and dH for pairs of rows (with few items two
//        lanes of a warp split DH and meet in a shuffle), H and dZ into
//        shared memory, dq = dZ A^T in 4-row tiles stored 16 bytes at a
//        time, then dA += q^T dZ and dU^T += do^T H in the same thread
//        tiles as (a), and du0, db1 one thread a column: all held in
//        registers across the block's items, in walk order.
//    (c) As (a): the tiles into shared memory, the split groups summed,
//        then dA, dU^T, du0 and db1 summed over the ranks in rank order
//        through distributed shared memory, between two cluster barriers.
//    (d) For its own key rows, chunk by chunk: dk and dv (4-row tiles,
//        16-byte stores), and the kv head's partial rows of dw1, dw2 and
//        db2 (rank 0: db1) into per-kv-head scratch that the wrapper
//        allocates. Where the block's rows fit one chunk (phase 1's
//        in-vivo case: L = 64 = KC), K, V, W1, W2 and b2 stay in shared
//        memory from (a); otherwise (phase 2's: L = 256) the block loads
//        its chunks a second time.
// 2. msa_bwd_sum_kernel: sums the per-kv-head partials of dw1, dw2, db2
//    and db1 over the heads: a warp a group of consecutive heads, each
//    summed in head order, the groups then in group order; float32 out.
//
// On the path (f32 DH 64, hid 16) a block takes 109 KB of shared memory,
// so two blocks share a SM.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

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
constexpr int BQ = 64;                 // query rows a work item
constexpr int HID_MAX = 64;
constexpr int CLUSTER_MAX = 8;
constexpr int SUM_GROUPS = 8;          // head groups (warps) a sum block

// key rows a chunk: 64, or fewer at DH 128 so that the block fits
template <typename T, int DH>
constexpr int key_chunk() {
  return DH < 128 ? 64 : sizeof(T) == 4 ? 8 : 32;
}

// The shared-memory layout, in bytes from the (128-aligned) base. Every
// row is padded (by 16 bytes, or 32 for a width of hp with hp / 4 odd), so
// that the rows a warp reads at once fall on different banks. Float
// arrays:
//   T (totals):  du0 (DH) | db1 (hp) | X1 (DH x ldh) | X2 (DH x ldh), with
//                X1, X2 = A, U^T after (a) and dA, dU^T after (c);
//   R (region):  du0 | db1 | KSPLIT slices of X1 | X2 (the partials the
//                peers read; slice 0 is the block's partial) in (a) and
//                (c); H, dZ (BQ x ldh) and A^T (hp x LDD) in (b); dA^T
//                and dU (hp x LDD) in (d).
template <typename T, int DH>
struct Layout {
  static constexpr int KC = key_chunk<T, DH>();
  static constexpr int LDX = DH + 16 / (int)sizeof(T);   // q, do, k, v rows
  static constexpr int LDD = DH + 4;                      // A^T, dA^T, dU
  int hp, ldh, hpg, e, np, p, ksplit, region;
  int ts, rs, ks, vs, w1s, w2s, b2s, b1s, qs, dos, bytes;
  __host__ __device__ Layout(int hid) {
    hp = (hid + 3) / 4 * 4;                  // hid padded to 4 columns
    ldh = hp % 8 ? hp + 8 : hp + 4;          // ldh / 4 odd: see pair_rows
    hpg = hp / 4;
    e = 2 * DH * ldh;
    np = DH + hp + e;
    p = 2 * (DH / 4) * hpg;                  // 4 x 4 tiles of X1 and X2
    ksplit = p >= THREADS ? 1 : THREADS / p;
    const int parts = DH + hp + ksplit * e;
    const int items = 2 * BQ * ldh + hp * LDD;
    region = parts > items ? parts : items;
    if (2 * hp * LDD > region) region = 2 * hp * LDD;
    const int xb = KC * LDX * (int)sizeof(T);
    ts = 128;                                // after two mbarriers
    rs = ts + np * 4;
    ks = rs + region * 4;
    vs = ks + xb;
    w1s = vs + xb;
    w2s = w1s + KC * ldh * 4;                // W2 transposed: (KC, hp)
    b2s = w2s + KC * ldh * 4;
    b1s = b2s + KC * 4;
    qs = b1s + hp * 4;
    dos = qs + BQ * LDX * (int)sizeof(T);
    bytes = dos + BQ * LDX * (int)sizeof(T);
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
__device__ __forceinline__ void unpack(float4 v, float* x) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
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

// Four floats at p (16-byte aligned: one store) or the first n of them.
__device__ __forceinline__ void store4(float* p, const float* v, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    store16(p, v);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < n) p[c] = v[c];
}

// Rows [r0, r0 + rows) of a (.., DH) array at `src` into a tile of rows
// LDX elements apart, 16-byte copies; rows at or past `rend` zero-filled.
template <typename T, int DH>
__device__ __forceinline__ void copy_rows(uint32_t dst, const T* src, int r0,
                                          int rows, int rend) {
  constexpr int CPR = DH * (int)sizeof(T) / 16;          // copies a row
  constexpr int LDB = Layout<T, DH>::LDX * (int)sizeof(T);
#pragma unroll 1
  for (int x = threadIdx.x; x < rows * CPR; x += THREADS) {
    const int r = x / CPR, c = x % CPR;
    const bool ok = r0 + r < rend;
    const char* s = reinterpret_cast<const char*>(
        src + (long long)(ok ? r0 + r : 0) * DH) + 16 * c;
    cp_async16(dst + r * LDB + 16 * c, s, ok);
  }
}

// Distributed shared memory: `mapa` gives the address of the same
// variable in cluster block `rank`'s shared memory.
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
// this block's rank in its cluster, read afresh (a volatile read: the
// compiler keeps no earlier copy alive for it)
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// floats [0, n) of `part` (n a multiple of 4) summed over the cluster's
// ranks in rank order, into `tot` of every block: block `rank` takes its
// share of the elements. Cluster barriers before (every partial written)
// and after (every total written; no peer touches this memory again
// until the next round).
__device__ __forceinline__ void cluster_sum(const float* part, float* tot,
                                            int n, int nc, int rank) {
  cluster_sync();
  const int n4 = n / 4, share = (n4 + nc - 1) / nc;
  for (int e = rank * share + threadIdx.x; e < min(n4, (rank + 1) * share);
       e += THREADS) {
    float4 v[CLUSTER_MAX];               // every peer's load in flight
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < nc) v[r] = ld_peer(peer_addr(part + 4 * e, r));
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < CLUSTER_MAX; ++r)
      if (r < nc) {
        s.x += v[r].x; s.y += v[r].y; s.z += v[r].z; s.w += v[r].w;
      }
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < nc) st_peer(peer_addr(tot + 4 * e, r), s);
  }
  cluster_sync();
}

// The thread tiles of X1 = sum_rows x1^T y1 and X2 = sum_rows x2^T y2,
// both (DH, hp) with rows ldh apart: tile mt < p / 2 of X1, the rest of
// X2, each 4 x 4 (4 of DH, 4 of hp). With KSPLIT > 1 thread t owns tile
// t % p over the 4-row blocks t / p, t / p + KSPLIT, ...
struct Tiles {
  int p, hpg, ksplit, split;
  __device__ Tiles(int p_, int hpg_, int ksplit_)
      : p(p_), hpg(hpg_), ksplit(ksplit_),
        split(ksplit_ > 1 ? (int)threadIdx.x / p_ : 0) {}
  // this thread's m-th tile, or p for none
  __device__ int tile(int m) const {
    const int t = threadIdx.x;
    if (ksplit == 1) return min(p, t + m * THREADS);
    return m == 0 && t < ksplit * p ? t % p : p;
  }
};

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][16]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
}

// acc += the thread's tiles over rows [0, rows) (a multiple of 4) of
// x (rows ldx apart, DH wide) and y (rows ldy apart, hp wide)
template <int MT, typename TX>
__device__ __forceinline__ void outer_acc(float (&acc)[MT][16],
                                          const Tiles& tl, const TX* x1,
                                          const float* y1, const TX* x2,
                                          const float* y2, int ldx, int ldy,
                                          int rows) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = tl.tile(m);
    if (mt == tl.p) continue;
    const bool two = mt >= tl.p / 2;
    const int idx = two ? mt - tl.p / 2 : mt;
    const TX* x = (two ? x2 : x1) + 4 * (idx / tl.hpg);
    const float* y = (two ? y2 : y1) + 4 * (idx % tl.hpg);
#pragma unroll 1
    for (int j = 4 * tl.split; j < rows; j += 4 * tl.ksplit) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float a[4], b[4];
        unpack(load4(x + (j + r) * ldx), a);
        unpack(load4(y + (j + r) * ldy), b);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][4 * u + c] = fmaf(a[u], b[c], acc[m][4 * u + c]);
      }
    }
  }
}

// The thread tiles (times `sc` for X1) into split slice `split` of the
// partials at `xs` (X1, then X2 DH * ldh floats later), then, with
// KSPLIT > 1, the slices summed in split order into slice 0.
template <int MT, int DH>
__device__ __forceinline__ void store_tiles(const float (&acc)[MT][16],
                                            const Tiles& tl, float* xs,
                                            int ldh, float sc) {
  const int e = 2 * DH * ldh;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = tl.tile(m);
    if (mt == tl.p) continue;
    const bool two = mt >= tl.p / 2;
    const int idx = two ? mt - tl.p / 2 : mt;
    const float s = two ? 1.f : sc;
    float* dst = xs + tl.split * e + (two ? DH * ldh : 0) +
                 4 * (idx / tl.hpg) * ldh + 4 * (idx % tl.hpg);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(dst + u * ldh) =
          make_float4(acc[m][4 * u] * s, acc[m][4 * u + 1] * s,
                      acc[m][4 * u + 2] * s, acc[m][4 * u + 3] * s);
  }
  if (tl.ksplit == 1) return;
  __syncthreads();
  float4* x4 = reinterpret_cast<float4*>(xs);
  for (int i = threadIdx.x; i < e / 4; i += THREADS) {
    float4 s = x4[i];
    for (int g = 1; g < tl.ksplit; ++g) {
      const float4 v = x4[g * (e / 4) + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    x4[i] = s;
  }
}

// For each pair of rows (r, r + R / 2) of an R-row tile and each 4-column
// group hg of hp: o1 = x1[r] y1[:, 4 hg ..] and o2 = x2[r] y2[:, 4 hg ..],
// summed over DH. With few items two lanes of a warp split DH (its
// 4-column steps taken in turn) and meet in a shuffle; their loads of y
// are four rows apart, which ldy / 4 odd puts on other banks. The lane of
// part 0 hands both rows to epi(r, hg, o1, o2).
template <int DH, typename TX, class Epi>
__device__ __forceinline__ void pair_rows(const TX* x1, const float* y1,
                                          const TX* x2, const float* y2,
                                          int ldx, int ldy, int R, int hpg,
                                          Epi epi) {
  const int items = R / 2 * hpg;
  const int ds = items * 2 <= THREADS ? 2 : 1;
  const int part = threadIdx.x % ds;
#pragma unroll 1
  for (int base = 0; base < items * ds; base += THREADS) {
    const int it = (base + (int)threadIdx.x) / ds;
    const bool on = it < items;
    const int r = on ? it / hpg : 0, c0 = on ? 4 * (it % hpg) : 0;
    float o1[2][4] = {}, o2[2][4] = {};
#pragma unroll 2
    for (int s = part; s < DH / 4; s += ds) {
      const int d = 4 * s;
      float a[2][4], b[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        unpack(load4(x1 + (r + rr * R / 2) * ldx + d), a[rr]);
        unpack(load4(x2 + (r + rr * R / 2) * ldx + d), b[rr]);
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        float u[4], w[4];
        unpack(load4(y1 + (d + y) * ldy + c0), u);
        unpack(load4(y2 + (d + y) * ldy + c0), w);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            o1[rr][c] = fmaf(a[rr][y], u[c], o1[rr][c]);
            o2[rr][c] = fmaf(b[rr][y], w[c], o2[rr][c]);
          }
      }
    }
    for (int off = 1; off < ds; off <<= 1)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o1[rr][c] += __shfl_xor_sync(0xffffffffu, o1[rr][c], off);
          o2[rr][c] += __shfl_xor_sync(0xffffffffu, o2[rr][c], off);
        }
    if (on && part == 0) epi(r, c0, o1, o2);
  }
}

// For each 4-row group of R rows and each DV-column group of DH:
// o[x][c] = sum_h y[4 rg + x][h] z[h][DV cg + c] over h < hp, handed to
// epi(4 rg, DV cg, o).
template <int DH, int DV, class Epi>
__device__ __forceinline__ void rows_by_d(const float* y, const float* z,
                                          int ldy, int ldz, int R, int hp,
                                          Epi epi) {
  constexpr int NCG = DH / DV;
  for (int it = threadIdx.x; it < R / 4 * NCG; it += THREADS) {
    const int r0 = 4 * (it / NCG), c0 = DV * (it % NCG);
    float o[4][DV];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int c = 0; c < DV; ++c) o[x][c] = 0.f;
#pragma unroll 1
    for (int h = 0; h < hp; h += 4) {
      float a[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) unpack(load4(y + (r0 + x) * ldy + h), a[x]);
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int c4 = 0; c4 < DV; c4 += 4) {
          float b[4];
          unpack(load4(z + (h + hh) * ldz + c0 + c4), b);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[x][c4 + c] = fmaf(a[x][hh], b[c], o[x][c4 + c]);
        }
    }
    epi(r0, c0, o);
  }
}

// out[c][r] = in[r][c] for r < rows, c < cols
__device__ __forceinline__ void transpose(float* out, int ldo, const float* in,
                                          int ldi, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int c = i / rows, r = i % rows;
    out[c * ldo + r] = in[r * ldi + c];
  }
}

// the most thread tiles of (a) and (c) a thread can own at DH (hid 64)
template <int DH>
constexpr int mt_max() { return DH >= 64 ? DH / 32 : 1; }

// MT: the thread tiles a thread owns, 1 or mt_max (hid past 32 at DH 64,
// past 16 at DH 128). With one, two blocks share a SM at DH <= 64.
template <typename T, int DH, int MT>
__global__ void __launch_bounds__(THREADS, DH <= 64 && MT == 1 ? 2 : 1)
msa_bwd_heads_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                     const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ part, int group, int sq, int skv,
                     int hid, int slice, int ns4, float scale) {
  using L = Layout<T, DH>;
  constexpr int KC = L::KC, LDX = L::LDX, LDD = L::LDD;
  constexpr int DV = 16 / (int)sizeof(T);         // outputs a 16-byte store
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(hid);
  const int hp = lay.hp, ldh = lay.ldh, t = threadIdx.x;
  const uint32_t base = smem_u32(smem);
  const uint32_t kbar = base, qbar = base + 8;

  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long kvh = blockIdx.x / nc;
  const int nq = (sq + BQ - 1) / BQ, items = group * nq;

  float* ts = reinterpret_cast<float*>(smem + lay.ts);
  float* rs = reinterpret_cast<float*>(smem + lay.rs);
  const T* ks = reinterpret_cast<const T*>(smem + lay.ks);
  const T* vs = reinterpret_cast<const T*>(smem + lay.vs);
  const float* w1s = reinterpret_cast<const float*>(smem + lay.w1s);
  const float* w2s = reinterpret_cast<const float*>(smem + lay.w2s);
  const float* b2s = reinterpret_cast<const float*>(smem + lay.b2s);
  float* b1s = reinterpret_cast<float*>(smem + lay.b1s);
  const T* qs = reinterpret_cast<const T*>(smem + lay.qs);
  const T* dos = reinterpret_cast<const T*>(smem + lay.dos);

  // this block's key rows [j0, j0 + n), in chunks of KC; (d) works them
  // out again from the rank rather than keep them in registers through
  // (b), where the float32 DH 64 kernel needs all it has
  int j0 = min(skv, rank * slice);
  int n = min(skv, j0 + slice) - j0;
  int nchunks = (n + KC - 1) / KC;
  auto issue_chunk = [&](int ch) {
    const int r0 = j0 + ch * KC, rows = min(KC, n - ch * KC);
    copy_rows<T, DH>(base + lay.ks, k + kvh * skv * DH, r0, KC, r0 + rows);
    copy_rows<T, DH>(base + lay.vs, v + kvh * skv * DH, r0, KC, r0 + rows);
    // W1 rows, 16 bytes where the source is aligned
#pragma unroll 1
    for (int x = t; x < KC * lay.hpg; x += THREADS) {
      const int r = x / lay.hpg, c = 4 * (x % lay.hpg);
      const float* s = w1 + (long long)(r0 + r) * hid + c;
      const uint32_t d = base + lay.w1s + (r * ldh + c) * 4;
      if (r < rows && c + 4 <= hid &&
          (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
        cp_async16(d, s, true);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = r < rows && c + u < hid;
          cp_async4(d + 4 * u, ok ? s + u : w1, ok);
        }
      }
    }
    // W2's columns as rows (W2^T), and b2
#pragma unroll 1
    for (int x = t; x < hp * KC; x += THREADS) {
      const int h = x / KC, r = x % KC;
      const bool ok = h < hid && r < rows;
      cp_async4(base + lay.w2s + (r * ldh + h) * 4,
                ok ? w2 + (long long)h * skv + r0 + r : w2, ok);
    }
    for (int r = t; r < KC; r += THREADS)
      cp_async4(base + lay.b2s + 4 * r, r < rows ? b2 + r0 + r : b2,
                r < rows);
    cp_async_arrive(kbar);
  };
  auto issue_item = [&](int it) {
    const long long bh = kvh * group + it / nq;
    const int q0 = it % nq * BQ;
    copy_rows<T, DH>(base + lay.qs, q + bh * sq * DH, q0, BQ, sq);
    copy_rows<T, DH>(base + lay.dos, dout + bh * sq * DH, q0, BQ, sq);
    cp_async_arrive(qbar);
  };

  if (t == 0) {
    mbar_init(kbar, THREADS);
    mbar_init(qbar, THREADS);
    fence_mbar_init();
  }
  for (int h = t; h < hp; h += THREADS) b1s[h] = h < hid ? b1[h] : 0.f;
  __syncthreads();
  if (nchunks > 0) issue_chunk(0);
  issue_item(rank);                      // rank < C <= items

  // ---- (a) A_r = scale K^T W1 and U_r^T = V^T W2^T over the key rows ----
  const Tiles tl(lay.p, lay.hpg, lay.ksplit);
  float acc[MT][16];
  zero(acc);
  for (int ch = 0; ch < nchunks; ++ch) {
    mbar_wait(kbar, ch & 1);             // the barrier's phase ch
    const int rows = min(KC, n - ch * KC);
    outer_acc(acc, tl, ks, w1s, vs, w2s, LDX, ldh, (rows + 3) / 4 * 4);
    if (ch + 1 < nchunks) {
      __syncthreads();                   // every reader is done
      issue_chunk(ch + 1);
    }
  }
  float* xs = rs + DH + hp;              // the partials' slices
  store_tiles<MT, DH>(acc, tl, xs, ldh, scale);
  // ---- A and U^T summed over the ranks, into every block's T ------------
  cluster_sum(xs, ts + DH + hp, lay.e, nc, rank);
  const float* As = ts + DH + hp;
  const float* Uts = As + DH * ldh;
  float* hs = rs;                        // H, dZ, A^T in the region
  float* dzs = hs + BQ * ldh;
  float* ats = dzs + BQ * ldh;
  transpose(ats, LDD, As, ldh, DH, hp);
  __syncthreads();

  // ---- (b) the block's work items ---------------------------------------
  zero(acc);
  float col = 0.f;                       // du0 (t < DH) or db1 (DH + h)
  for (int it = rank; it < items; it += nc) {
    const long long bh = kvh * group + it / nq;
    const int q0 = it % nq * BQ;
    mbar_wait(qbar, (it - rank) / nc & 1);
    // Z = q A + b1, dH = do U^T: H = relu(Z), dZ = dH [Z > 0]
    pair_rows<DH>(qs, As, dos, Uts, LDX, ldh, BQ, lay.hpg,
                  [&](int r, int c0, float (&z)[2][4], float (&g)[2][4]) {
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr) {
                      float hv[4], dz[4];
#pragma unroll
                      for (int c = 0; c < 4; ++c) {
                        const float zz = z[rr][c] + b1s[c0 + c];
                        hv[c] = fmaxf(zz, 0.f);
                        dz[c] = zz > 0.f ? g[rr][c] : 0.f;
                      }
                      const int row = r + rr * BQ / 2;
                      store16(hs + row * ldh + c0, hv);
                      store16(dzs + row * ldh + c0, dz);
                    }
                  });
    __syncthreads();
    // dq = dZ A^T
    T* dqh = dq + bh * sq * DH;
    rows_by_d<DH, DV>(dzs, ats, ldh, LDD, BQ, hp,
                      [&](int r0, int c0, float (&o)[4][DV]) {
#pragma unroll
                        for (int x = 0; x < 4; ++x)
                          if (q0 + r0 + x < sq)
                            store16(dqh + (long long)(q0 + r0 + x) * DH + c0,
                                    o[x]);
                      });
    // dA += q^T dZ, dU^T += do^T H; du0 += sum do, db1 += sum dZ
    outer_acc(acc, tl, qs, dzs, dos, hs, LDX, ldh, BQ);
    if (t < DH) {
      for (int r = 0; r < BQ; ++r) col += ftile::to_f(dos[r * LDX + t]);
    } else if (t < DH + hp) {
      for (int r = 0; r < BQ; ++r) col += dzs[r * ldh + t - DH];
    }
    __syncthreads();                     // q, do, H, dZ are read
    if (it + nc < items) issue_item(it + nc);
  }

  // ---- (c) dA, dU^T, du0, db1 summed over the ranks ----------------------
  store_tiles<MT, DH>(acc, tl, xs, ldh, 1.f);
  if (t < DH + hp) rs[t] = col;
  cluster_sum(rs, ts, lay.np, nc, rank);
  const float* du0s = ts;
  const float* dAs = ts + DH + hp;
  const float* dUts = dAs + DH * ldh;
  float* dats = rs;                      // dA^T, dU in the region
  float* dus = rs + hp * LDD;
  transpose(dats, LDD, dAs, ldh, DH, hp);
  transpose(dus, LDD, dUts, ldh, DH, hp);
  __syncthreads();

  // ---- (d) dk, dv and the head's weight partials for the key rows -------
  float* pw1 = part + kvh * ns4;
  float* pw2 = pw1 + (long long)skv * hid;
  float* pb2 = pw2 + (long long)skv * hid;
  T* dkh = dk + kvh * skv * DH;
  T* dvh = dv + kvh * skv * DH;
  j0 = min(skv, cluster_rank() * slice);
  n = min(skv, j0 + slice) - j0;
  nchunks = (n + KC - 1) / KC;
  for (int ch = 0; ch < nchunks; ++ch) {
    if (nchunks > 1) {                   // streamed: load the chunk again
      if (ch > 0) __syncthreads();
      issue_chunk(ch);
      mbar_wait(kbar, (nchunks + ch) & 1);
    }
    const int r0 = j0 + ch * KC, rows = min(KC, n - ch * KC);
    const int rows4 = (rows + 3) / 4 * 4;
    // dk = scale W1 dA^T
    rows_by_d<DH, DV>(w1s, dats, ldh, LDD, rows4, hp,
                      [&](int j, int c0, float (&o)[4][DV]) {
#pragma unroll
                        for (int x = 0; x < 4; ++x) {
                          if (j + x >= rows) continue;
#pragma unroll
                          for (int c = 0; c < DV; ++c) o[x][c] *= scale;
                          store16(dkh + (long long)(r0 + j + x) * DH + c0,
                                  o[x]);
                        }
                      });
    // dv = W2^T dU + b2 du0
    rows_by_d<DH, DV>(w2s, dus, ldh, LDD, rows4, hp,
                      [&](int j, int c0, float (&o)[4][DV]) {
#pragma unroll
                        for (int x = 0; x < 4; ++x) {
                          if (j + x >= rows) continue;
#pragma unroll
                          for (int c = 0; c < DV; ++c)
                            o[x][c] = fmaf(b2s[j + x], du0s[c0 + c], o[x][c]);
                          store16(dvh + (long long)(r0 + j + x) * DH + c0,
                                  o[x]);
                        }
                      });
    // the head's rows of dw1 = scale K dA and dw2^T = V dU^T
    pair_rows<DH>(ks, dAs, vs, dUts, LDX, ldh, rows4, lay.hpg,
                  [&](int r, int c0, float (&a)[2][4], float (&b)[2][4]) {
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr) {
                      const int j = r + rr * rows4 / 2;
                      if (j >= rows) continue;
                      float w[4];
#pragma unroll
                      for (int c = 0; c < 4; ++c) w[c] = a[rr][c] * scale;
                      store4(pw1 + (long long)(r0 + j) * hid + c0, w,
                             hid - c0);
#pragma unroll
                      for (int c = 0; c < 4; ++c)
                        if (c0 + c < hid)
                          pw2[(long long)(c0 + c) * skv + r0 + j] = b[rr][c];
                    }
                  });
    // db2 = V du0
    for (int j = t; j < rows; j += THREADS) {
      float s = 0.f;
      for (int d = 0; d < DH; d += 4) {
        float x[4];
        unpack(load4(vs + j * LDX + d), x);
#pragma unroll
        for (int c = 0; c < 4; ++c) s = fmaf(x[c], du0s[d + c], s);
      }
      pb2[r0 + j] = s;
    }
  }
  if (rank == 0)
    for (int h = t; h < hid; h += THREADS)
      pb2[skv + h] = ts[DH + h];         // db1
}

// dw1, dw2, db2 and db1 (in that order in each kv head's row of `part`,
// ns4 floats apart) summed over the bhk heads
__global__ void __launch_bounds__(THREADS)
msa_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dw1,
                   float* __restrict__ dw2, float* __restrict__ db2,
                   float* __restrict__ db1, int bhk, int skv, int hid,
                   int ns4) {
  __shared__ float sums[SUM_GROUPS][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const long long sw = (long long)skv * hid;
  const long long ns = 2 * sw + skv + hid;
  const long long e = (long long)blockIdx.x * 32 + lane;
  const int hc = (bhk + SUM_GROUPS - 1) / SUM_GROUPS;
  const int h0 = min(bhk, g * hc), h1 = min(bhk, h0 + hc);
  float s = 0.f;
  if (e < ns) {
#pragma unroll 4
    for (int h = h0; h < h1; ++h) s += part[(long long)h * ns4 + e];
  }
  sums[g][lane] = s;
  __syncthreads();
  if (g != 0 || e >= ns) return;
  for (int x = 1; x < SUM_GROUPS; ++x) s += sums[x][lane];
  if (e < sw) dw1[e] = s;
  else if (e < 2 * sw) dw2[e - sw] = s;
  else if (e < 2 * sw + skv) db2[e - 2 * sw] = s;
  else db1[e - 2 * sw - skv] = s;
}

template <typename T, int DH, int MT>
int run_mt(const void* q, const void* dout, const void* k, const void* v,
           const float* w1, const float* b1, const float* w2, const float* b2,
           void* dq, void* dk, void* dv, float* part, int bhk, int group,
           int sq, int skv, int hid, int nc, int slice, int ns4, float scale,
           cudaStream_t stream) {
  auto kernel = msa_bwd_heads_kernel<T, DH, MT>;
  // once per instantiation: the most any hid takes
  static const int smem_err = [&] {
    int most = 0;
    for (int h = 1; h <= HID_MAX; ++h)
      most = std::max(most, Layout<T, DH>(h).bytes);
    return ftile::allow_smem(kernel, (size_t)most);
  }();
  if (smem_err) return smem_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bhk * nc);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout<T, DH>(hid).bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(dout),
      static_cast<const T*>(k), static_cast<const T*>(v), w1, b1, w2, b2,
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), part,
      group, sq, skv, hid, slice, ns4, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int run(const void* q, const void* dout, const void* k, const void* v,
        const float* w1, const float* b1, const float* w2, const float* b2,
        void* dq, void* dk, void* dv, float* part, int bhk, int group,
        int sq, int skv, int hid, int nc, int slice, int ns4, float scale,
        cudaStream_t stream) {
  if (Layout<T, DH>(hid).p <= THREADS)
    return run_mt<T, DH, 1>(q, dout, k, v, w1, b1, w2, b2, dq, dk, dv, part,
                            bhk, group, sq, skv, hid, nc, slice, ns4, scale,
                            stream);
  return run_mt<T, DH, mt_max<DH>()>(q, dout, k, v, w1, b1, w2, b2, dq, dk,
                                     dv, part, bhk, group, sq, skv, hid, nc,
                                     slice, ns4, scale, stream);
}

template <typename T>
int launch_heads(const void* q, const void* dout, const void* k,
                 const void* v, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* dq, void* dk, void* dv,
                 void* part, int bh, int group, int sq, int skv, int dh,
                 int hid, int nc, int slice, int ns4, float scale,
                 void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || skv < 1 || hid < 1 ||
      hid > HID_MAX || nc < 1 || nc > CLUSTER_MAX ||
      nc > group * ((sq + BQ - 1) / BQ) || (long long)slice * nc < skv ||
      ns4 % 4 || ns4 < 2 * skv * hid + skv + hid ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(dout) |
        reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
        reinterpret_cast<uintptr_t>(dv) | reinterpret_cast<uintptr_t>(part)) &
       15))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f1 = static_cast<const float*>(w1);
  const auto* fb1 = static_cast<const float*>(b1);
  const auto* f2 = static_cast<const float*>(w2);
  const auto* fb2 = static_cast<const float*>(b2);
  auto* fp = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  const int bhk = bh / group;
  switch (dh) {
    case 16: return run<T, 16>(q, dout, k, v, f1, fb1, f2, fb2, dq, dk, dv, fp, bhk, group, sq, skv, hid, nc, slice, ns4, scale, st);
    case 32: return run<T, 32>(q, dout, k, v, f1, fb1, f2, fb2, dq, dk, dv, fp, bhk, group, sq, skv, hid, nc, slice, ns4, scale, st);
    case 64: return run<T, 64>(q, dout, k, v, f1, fb1, f2, fb2, dq, dk, dv, fp, bhk, group, sq, skv, hid, nc, slice, ns4, scale, st);
    case 128: return run<T, 128>(q, dout, k, v, f1, fb1, f2, fb2, dq, dk, dv, fp, bhk, group, sq, skv, hid, nc, slice, ns4, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int msa_bwd_heads_f32(const void* q, const void* dout,
                                 const void* k, const void* v,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* dq,
                                 void* dk, void* dv, void* part, int bh,
                                 int group, int sq, int skv, int dh, int hid,
                                 int nc, int slice, int ns4, float scale,
                                 void* stream) {
  return launch_heads<float>(q, dout, k, v, w1, b1, w2, b2, dq, dk, dv, part,
                             bh, group, sq, skv, dh, hid, nc, slice, ns4,
                             scale, stream);
}

extern "C" int msa_bwd_heads_bf16(const void* q, const void* dout,
                                  const void* k, const void* v,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* dq,
                                  void* dk, void* dv, void* part, int bh,
                                  int group, int sq, int skv, int dh, int hid,
                                  int nc, int slice, int ns4, float scale,
                                  void* stream) {
  return launch_heads<__nv_bfloat16>(q, dout, k, v, w1, b1, w2, b2, dq, dk,
                                     dv, part, bh, group, sq, skv, dh, hid,
                                     nc, slice, ns4, scale, stream);
}

extern "C" int msa_bwd_sum(const void* part, void* dw1, void* dw2, void* db2,
                           void* db1, int bhk, int skv, int hid, int ns4,
                           void* stream) {
  if (bhk < 1 || skv < 1 || hid < 1 || ns4 < 2 * skv * hid + skv + hid)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ns = 2LL * skv * hid + skv + hid;
  msa_bwd_sum_kernel<<<(unsigned)((ns + 31) / 32), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw1),
      static_cast<float*>(dw2), static_cast<float*>(db2),
      static_cast<float*>(db1), bhk, skv, hid, ns4);
  return static_cast<int>(cudaGetLastError());
}
