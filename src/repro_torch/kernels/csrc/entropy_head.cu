// entropy_head: the softmax entropy of each row of logits (R, V), in one
// pass that never forms the probabilities,
//   H = m + log z - s / z,  m = max x,  z = sum e^(x - m),  s = sum x e^(x - m).
//
// Replaces the Pallas kernel repro/kernels/entropy_head.py:entropy_head
// (pallas_call at :53). There a sequential grid walks vocab tiles and
// carries (m, z, s) per row in VMEM scratch.
//
// Bound on the H100: bytes (`work` in kernels/entropy_head.py). A call
// reads R V elements once and writes R floats, for about four operations
// an element (a max, a subtraction, an exp, a multiply-add): at a
// vocabulary-wide head, (256, 30,522) float32, 31.3 MB, 9.3 us at
// 3.35 TB/s. What a kernel has to do is keep enough bytes in flight on
// every SM, however few the rows.
//
// Design. `plan(r, v)` in the wrapper gives the threads a row (`tpr`) and
// the blocks a row (`nc`); blocks are THREADS threads:
// - V <= 16 (a classifier's classes): one thread a row, THREADS rows a
//   block (`entropy_head_rows_kernel`): the max, then one exp a column.
//   At the Oracle's (16, 2) its time is the launch's.
// - Otherwise a row takes tpr threads, 32 to THREADS, enough that the
//   blocks fill the card (`entropy_head_split_kernel`), and where a row
//   fills a block and the rows are fewer than the SMs, a thread-block
//   cluster of nc blocks a row (cudaLaunchKernelEx with a cluster
//   dimension), each block a contiguous share of the row.
// A row's 16-byte vectors start at its first 16-byte boundary: row r
// starts at byte r V size, which is off the boundary for most V (30,522
// float32 rows alternate 0 and 8 mod 16; bfloat16 rows cycle through 0,
// 4, 8, 12). The elements before it (the head) and after the last whole
// vector (the tail), fewer than 16 bytes each, are folded one by one by
// the first threads of the row's first block. Each thread then walks
// the vectors t, t + tpr, ... of its block's share in chunks of VECS:
// it issues the chunk's VECS 16-byte loads (evict-first, `__ldcs`: each
// byte is read once) before it uses one, takes the chunk's max,
// rescales its running (z, s) once, and adds one exp an element. The
// triples are merged in a fixed order: a balanced tree over the lanes
// of a warp (shuffles), then over the row's warps (shared memory), then
// over the cluster's ranks (each block stores its triple into rank 0's
// shared memory through distributed shared memory, `mapa`). No atomics
// and no second pass, so two launches on the same input agree bitwise.
// An element's exp is `__expf(x - mn)`, one multiply by log2 e and the
// hardware's ex2 (2 ulp): x - mn is formed first, so the row's max gets
// exactly 1; the rescales and merges take the accurate expf. x e uses
// the raw x, as the plain version does, so that logits of scale 1e4,
// where m and s / z cancel, come out as it gives them. A thread without
// elements holds the empty triple (m = -1e30, z = s = 0), which merges
// as an identity.
//
// At (256, 30,522) float32: 256 blocks of 512 threads, two a SM (at most
// 64 registers), all resident; 64 KB of loads in flight a SM. At
// (16, 30,522): clusters of 4; at (4, 256,000): clusters of 8. THREADS,
// VECS, the cache policy and the exp were chosen on the card
// (tools/entropy_head_ab.py, PERF.md): 256 threads a block, 8 loads a
// thread at once, or the next chunk's loads issued before the current
// one is used were no faster; evict-first beat the default policy by 3 %
// on logits read from device memory (the default wins only when the same
// logits are read again from the L2), and `__expf` beat expf by 1 %
// (float32) and 5 % (bf16).
#include <cstdint>

#include "float_tile.cuh"

namespace {

using ftile::NEG_INF;
using ftile::to_f;

constexpr int THREADS = 512;      // threads a block
constexpr int VECS = 4;           // 16-byte loads a thread issues at once
constexpr int CLUSTER_MAX = 8;    // blocks a row, the portable most

struct Triple {
  float m, z, s;
};

__device__ __forceinline__ Triple empty_triple() { return {NEG_INF, 0.f, 0.f}; }

// (m, z, s) of p's elements and q's, p's terms first
__device__ __forceinline__ Triple merge(const Triple& p, const Triple& q) {
  const float mn = fmaxf(p.m, q.m);
  const float a = expf(p.m - mn), b = expf(q.m - mn);
  return {mn, p.z * a + q.z * b, p.s * a + q.s * b};
}

// one element into a running triple
__device__ __forceinline__ void fold(Triple& t, float x) {
  t = merge(t, Triple{x, 1.f, x});
}

// lane 0 ends with the balanced tree over the 32 lanes in lane order:
// (0, 1), then (0-1, 2-3), ...
__device__ __forceinline__ Triple warp_merge(Triple t) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Triple o{__shfl_down_sync(0xffffffffu, t.m, off),
                   __shfl_down_sync(0xffffffffu, t.z, off),
                   __shfl_down_sync(0xffffffffu, t.s, off)};
    t = merge(t, o);
  }
  return t;
}

__device__ __forceinline__ float entropy(const Triple& t) {
  const float z = fmaxf(t.z, 1e-30f);
  return t.m + logf(z) - t.s / z;
}

// A 16-byte vector of T: its raw load and its N elements in float32.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using Raw = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void to_f(const Raw& r, float* f) {
    f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ void to_f(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {         // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec16<__half> {
  using Raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ void to_f(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

// Thread t of the tpr threads on row xr, in block `rank` of the row's nc:
// its triple over the head and tail (rank 0) and its vectors of the
// block's share of the body.
template <typename T>
__device__ __forceinline__ Triple walk(const T* __restrict__ xr, int v, int t,
                                       int tpr, int rank, int nc) {
  using V = Vec16<T>;
  using Raw = typename V::Raw;
  constexpr int N = V::N;
  const int head = min(v, (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(xr) & 15)) & 15u) /
                                sizeof(T)));
  const int nvec = (v - head) / N;
  const int tail = v - head - nvec * N;
  const int per = (nvec + nc - 1) / nc;
  const int v0 = min(nvec, rank * per), v1 = min(nvec, v0 + per);
  Triple acc = empty_triple();
  if (rank == 0) {
    if (t < head) fold(acc, to_f(xr[t]));
    if (t < tail) fold(acc, to_f(xr[head + nvec * N + t]));
  }
  const Raw* body = reinterpret_cast<const Raw*>(xr + head);
  for (int j0 = v0 + t; j0 < v1; j0 += VECS * tpr) {
    Raw raw[VECS];
#pragma unroll
    for (int u = 0; u < VECS; ++u)
      raw[u] = j0 + u * tpr < v1 ? __ldcs(body + j0 + u * tpr) : Raw{};
    float f[VECS][N];
#pragma unroll
    for (int u = 0; u < VECS; ++u) V::to_f(raw[u], f[u]);
    float cm = NEG_INF;
#pragma unroll
    for (int u = 0; u < VECS; ++u)
      if (j0 + u * tpr < v1)
#pragma unroll
        for (int k = 0; k < N; ++k) cm = fmaxf(cm, f[u][k]);
    const float mn = fmaxf(acc.m, cm);
    const float a = expf(acc.m - mn);
    float z = acc.z * a, s = acc.s * a;
#pragma unroll
    for (int u = 0; u < VECS; ++u)
      if (j0 + u * tpr < v1)
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float e = __expf(f[u][k] - mn);
          z += e;
          s += f[u][k] * e;
        }
    acc = {mn, z, s};
  }
  return acc;
}

// Distributed shared memory: `mapa` gives the address of the same
// variable in cluster block `rank`'s shared memory.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t a, const Triple& t) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(t.m), "f"(t.z), "f"(t.s), "f"(0.f)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One thread a row, THREADS rows a block: the narrow rows (V <= 16).
template <typename T>
__global__ void __launch_bounds__(THREADS)
entropy_head_rows_kernel(const T* __restrict__ x, float* __restrict__ out,
                         int rows, int v) {
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  const T* xr = x + row * v;
  float m = NEG_INF;
  for (int i = 0; i < v; ++i) m = fmaxf(m, to_f(xr[i]));
  float z = 0.f, s = 0.f;
  for (int i = 0; i < v; ++i) {
    const float xi = to_f(xr[i]);
    const float e = expf(xi - m);
    z += e;
    s += xi * e;
  }
  out[row] = entropy({m, z, s});
}

// tpr threads a row: THREADS / tpr rows a block (nc = 1), or one row a
// block of nc in a cluster (tpr = THREADS). Threads of rows past R still
// take part in the shuffles and barriers, with the empty triple.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
entropy_head_split_kernel(const T* __restrict__ x, float* __restrict__ out,
                          int rows, int v, int tpr, int nc) {
  __shared__ float sm[3][THREADS / 32];
  __shared__ float4 ranks[CLUSTER_MAX];
  // every block of the cluster has started before any stores into rank
  // 0's shared memory (the wait comes after the walk)
  if (nc > 1) cluster_arrive_relaxed();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = THREADS / tpr, wpr = tpr / 32;
  const int rank = (int)(blockIdx.x % nc);
  const long long row = nc > 1 ? (long long)(blockIdx.x / nc)
                               : (long long)blockIdx.x * rpb + threadIdx.x / tpr;
  Triple acc = empty_triple();
  if (row < rows)
    acc = walk<T>(x + row * v, v, (int)(threadIdx.x % tpr), tpr, rank, nc);
  acc = warp_merge(acc);
  if (lane == 0) {
    sm[0][warp] = acc.m;
    sm[1][warp] = acc.z;
    sm[2][warp] = acc.s;
  }
  __syncthreads();
  if (nc > 1) cluster_wait();
  if (warp < rpb) {            // warp g merges row g's warps in order
    const int w = warp * wpr + lane;
    Triple t = lane < wpr ? Triple{sm[0][w], sm[1][w], sm[2][w]}
                          : empty_triple();
    t = warp_merge(t);
    if (nc == 1) {
      const long long r = (long long)blockIdx.x * rpb + warp;
      if (lane == 0 && r < rows) out[r] = entropy(t);
    } else if (lane == 0) {
      st_peer(peer_addr(&ranks[rank], 0), t);
    }
  }
  if (nc > 1) {
    cluster_arrive();          // every rank's triple is in rank 0's
    cluster_wait();            // shared memory
    if (rank == 0 && warp == 0) {
      const float4 q = lane < nc ? ranks[lane] : make_float4(NEG_INF, 0.f, 0.f, 0.f);
      const Triple t = warp_merge(Triple{q.x, q.y, q.z});
      if (lane == 0) out[row] = entropy(t);
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int rows, int v, int tpr, int nc,
           void* stream) {
  const bool pow2 = tpr >= 32 && tpr <= THREADS && (tpr & (tpr - 1)) == 0;
  if (rows < 1 || v < 1 || nc < 1 || nc > CLUSTER_MAX ||
      !(tpr == 1 || pow2) || (nc > 1 && tpr != THREADS) ||
      (reinterpret_cast<uintptr_t>(x) % sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xt = static_cast<const T*>(x);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tpr == 1) {
    entropy_head_rows_kernel<T><<<(rows + THREADS - 1) / THREADS, THREADS, 0,
                                  s>>>(xt, o, rows, v);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = nc > 1 ? (long long)rows * nc
                                  : (rows + THREADS / tpr - 1) / (THREADS / tpr);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (nc == 1) {
    entropy_head_split_kernel<T><<<(int)blocks, THREADS, 0, s>>>(
        xt, o, rows, v, tpr, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, entropy_head_split_kernel<T>, xt, o, rows, v, tpr, nc);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tpr threads a row and nc blocks a row, from `plan` in the wrapper
extern "C" int entropy_head_f32(const void* x, void* out, int rows, int v,
                                int tpr, int nc, void* stream) {
  return launch<float>(x, out, rows, v, tpr, nc, stream);
}

extern "C" int entropy_head_bf16(const void* x, void* out, int rows, int v,
                                 int tpr, int nc, void* stream) {
  return launch<__nv_bfloat16>(x, out, rows, v, tpr, nc, stream);
}

extern "C" int entropy_head_f16(const void* x, void* out, int rows, int v,
                                int tpr, int nc, void* stream) {
  return launch<__half>(x, out, rows, v, tpr, nc, stream);
}
