// Shared device helpers of the hand-written kernels: warp/block reductions
// in a fixed order (so every result is deterministic, with no atomics),
// the soft threshold, the restricted gradient sweep's row-chunk dot
// product c = Xw_b' r, 16-byte loads with a masked scalar fallback, the
// cached residency query the launchers size their grids by, and the
// thread-block cluster's barrier, distributed shared memory and launch.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <utility>

namespace cdt {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T tabs(T a) { return a < T(0) ? -a : a; }

// sign(x) * max(|x| - t, 0), as ops/prox.py::soft_threshold
template <typename T>
__device__ __forceinline__ T soft(T x, T t) {
  T m = tabs(x) - t;
  m = m > T(0) ? m : T(0);
  return x > T(0) ? m : (x < T(0) ? -m : T(0) * m);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block-wide max; blockDim.x a multiple of 32, `red` >= 32 entries of
// shared memory.  Every thread gets the result.
template <typename T>
__device__ T block_max(T v, T* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  T r = red[0];
  for (int q = 1; q < nw; ++q) r = tmax(r, red[q]);
  return r;
}

template <typename T>
__device__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  T r = red[0];
  for (int q = 1; q < nw; ++q) r += red[q];
  return r;
}

// Partial c[k] = sum over rows [row0, row1) of Xb[i * B + k] * r[i] for
// one (n, B) column block, with a (B, G) thread block: thread (k, g) sums
// rows g, g + G, ... of column k (neighbouring threads read neighbouring
// addresses of one row), then the G sums are added in order of g.  `red`
// holds B * G entries of shared memory.
template <typename T>
__device__ void chunk_dot(const T* __restrict__ Xb, const T* __restrict__ r,
                          int row0, int row1, int B, T* red,
                          T* __restrict__ out) {
  const int k = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  T acc = T(0);
  for (int i = row0 + g; i < row1; i += G) acc += Xb[(size_t)i * B + k] * r[i];
  red[g * B + k] = acc;
  __syncthreads();
  if (g == 0) {
    T s = T(0);
    for (int q = 0; q < G; ++q) s += red[q * B + k];
    out[k] = s;
  }
}

// Threads of the second axis of chunk_dot's thread block (B * G <= 256).
inline int dot_groups(int B) { return B >= 256 ? 1 : 256 / B; }

// The CTAs of `kern` (`threads` threads, `smem` bytes of dynamic shared
// memory) that the current device holds at once.  Above 48 KB the
// kernel's shared-memory limit is first raised to the device's opt-in
// maximum.  The answer never changes for one (kernel, device, smem), so
// it is queried once and kept: a launch then costs no query.
inline cudaError_t resident_ctas(const void* kern, int threads, size_t smem,
                                 int* ctas) {
  struct Entry {
    const void* kern;
    int dev;
    size_t smem;
    int ctas;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].dev == dev &&
        cache[i].smem == smem) {
      *ctas = cache[i].ctas;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0, optin = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  *ctas = per_sm * sms;
  if (used < 64) cache[used++] = Entry{kern, dev, smem, *ctas};
  return cudaSuccess;
}

// Thread-block clusters (sm_90).  The cluster barrier, split into its
// arrive (with release semantics: this thread's earlier memory accesses,
// to shared or global memory, are ordered before the other CTAs' wait)
// and its wait (acquire); every thread of every CTA of the cluster takes
// part, and each CTA calls both where all its threads arrive together
// (.aligned).  A thread alternates arrive and wait.  And the generic
// address of a shared-memory variable in CTA `rank` of the cluster
// (distributed shared memory: `mapa`), which plain loads read.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// An arrive that orders nothing: at a kernel's start, so that the wait
// before its first store into another CTA's shared memory knows every CTA
// of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
template <typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  uint64_t a;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(a);
}

// mbarriers (8 bytes of shared memory, 8-byte aligned) for a cluster's
// barrier of one thread a CTA: init (one thread, then mbar_init_fence and a
// cluster barrier before any other CTA arrives on it), an arrive on the
// barrier at the same offset in CTA `rank` with release semantics at
// cluster scope (it orders the arriving thread's earlier writes and those
// it has seen through __syncthreads), and a wait for the phase of parity
// `parity` with acquire semantics.  A wait that has not ended after ~2^26
// polls traps: a fault rather than a hung card.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar,
                                                    int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  for (long long i = 0; !done; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (i > (1LL << 26)) __trap();
  }
}

// The same for one CTA's own mbarrier and its bulk copies (the Tensor
// Memory Accelerator's non-tensor form): an arrive that also expects
// `bytes` of copies to complete on it, a wait for a phase (acquire at CTA
// scope: the copied bytes are visible after it), and a copy of `bytes`
// (a multiple of 16, both addresses 16-byte aligned) from global memory
// to the same shared-memory offset in every CTA of `mask` in the cluster,
// each of whose mbarriers at `bar`'s offset it completes.
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  for (long long i = 0; !done; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (i > (1LL << 26)) __trap();
  }
}
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               unsigned bytes,
                                               unsigned long long* bar,
                                               unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

constexpr int MAX_CLUSTER = 16;  // CTAs of the largest (non-portable) cluster

// Readies `kern` for cluster launches, once per (kernel, device): its
// shared-memory limit raised to the device's opt-in maximum, and clusters
// above the portable 8 CTAs allowed.  A launch then costs no attribute call.
inline cudaError_t cluster_ready(const void* kern) {
  struct Entry {
    const void* kern;
    int dev;
  };
  static std::mutex mu;
  static Entry done[64];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (done[i].kern == kern && done[i].dev == dev) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  if (used < 64) done[used++] = Entry{kern, dev};
  return cudaSuccess;
}

// Launches `kern` as clusters of `cluster` CTAs along x (grid a multiple of
// it) on stream `s`; a refused launch returns its error.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kern)(Params...), int grid, int threads,
                            size_t smem, int cluster, cudaStream_t s,
                            Args&&... args) {
  cudaError_t e = cluster_ready((const void*)kern);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
}

// Elements of T in one 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }

// The V = 16 / sizeof(T) elements row[k0 .. k0 + V) of a row `width`
// long, zero past its end: one 16-byte load when `vec` (the caller has
// checked that the row and k0 are 16-byte aligned and that width is a
// multiple of V), else V masked scalar loads.  The data is read-only for
// the whole kernel (ld.global.nc).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int k0,
                                           int width, bool vec,
                                           T (&v)[vec_of<T>()]) {
  constexpr int V = vec_of<T>();
  if (vec && k0 < width) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + k0));
    memcpy(&v[0], &u, 16);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      v[e] = k0 + e < width ? __ldg(row + k0 + e) : T(0);
  }
}

// The same from shared memory (no 16-byte requirement on the row).
template <typename T>
__device__ __forceinline__ void load_chunk_shared(const T* row, int k0,
                                                  int width,
                                                  T (&v)[vec_of<T>()]) {
#pragma unroll
  for (int e = 0; e < vec_of<T>(); ++e)
    v[e] = k0 + e < width ? row[k0 + e] : T(0);
}

}  // namespace cdt
