// Shared device helpers of the hand-written kernels: warp/block reductions
// in a fixed order (so every result is deterministic, with no atomics),
// the soft threshold, products and sums rounded one at a time (no fused
// multiply-add), the restricted gradient sweep's row-chunk dot
// product c = Xw_b' r, 16-byte loads with a masked scalar fallback and the
// layouts' rounding to them, the cached residency query and the
// cooperative launch behind it, the thread-block cluster's barrier,
// distributed shared memory, launch and occupancy query, the FISTA block
// product from Gram columns held in registers (K1's solve, GP's and the
// union-block round), and the visit skeleton K1 and GP share: the walk of
// the visit order, the row sweep of the partial c, the fixed-order sum of
// the CTAs' partials and the residual update.
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

// One rounding per operation (the compiler may not contract these into
// fused multiply-adds): K1's sqrt candidate and the vc round's updates.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
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

// Launches `kern` on `grid` CTAs of `threads` threads (`smem` bytes of
// dynamic shared memory each) with its `args`, as one cooperative grid on
// stream `s`.  The grid must be co-resident: a plain launch of too large a
// grid would hang at its first grid barrier, and this one is refused.
inline cudaError_t launch_cooperative(const void* kern, int grid, int threads,
                                      size_t smem, void** args,
                                      cudaStream_t s) {
  int resident = 0;
  cudaError_t e = resident_ctas(kern, threads, smem, &resident);
  if (e != cudaSuccess) return e;
  if (resident < grid) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(threads), args, smem,
                                  s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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

// The clusters of `cluster` CTAs of `kern` (`threads` threads, `smem` bytes
// of dynamic shared memory each) that the current device holds at once
// (cudaOccupancyMaxActiveClusters), into *count: 0 when no GPC holds one,
// and a launch of that shape would be refused.  Queried once per (kernel,
// device, cluster, smem) and kept; the launch planners read it through
// kernels/_build.py::largest_cluster.
inline cudaError_t active_clusters(const void* kern, int threads, size_t smem,
                                   int cluster, int* count) {
  struct Entry {
    const void* kern;
    int dev, cluster;
    size_t smem;
    int count;
  };
  static std::mutex mu;
  static Entry cache[128];
  static int used = 0;
  if (cluster < 1 || cluster > MAX_CLUSTER) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cluster_ready(kern);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].kern == kern && cache[i].dev == dev &&
        cache[i].cluster == cluster && cache[i].smem == smem) {
      *count = cache[i].count;
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(count, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (used < 128) cache[used++] = Entry{kern, dev, cluster, smem, *count};
  return cudaSuccess;
}

// Elements of T in one 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }

// x rounded up to whole 16-byte chunks of T (the shared-memory layouts
// start every array 16-byte aligned)
template <typename T>
__host__ __device__ constexpr int vec_up(int x) {
  return (x + vec_of<T>() - 1) / vec_of<T>() * vec_of<T>();
}

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

// V elements at p (16-byte aligned) in or out of shared memory.
template <typename T>
__device__ __forceinline__ void lds16(const T* p, T (&v)[vec_of<T>()]) {
  *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ void sts16(T* p, const T (&v)[vec_of<T>()]) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
}

// The CTA of warp_dot's layout (K1, GP and the union-block round): 128
// coordinates, 4 threads each.
constexpr int DOT_THREADS = 512;
constexpr int DOT_MAXB = 128;

// The FISTA product of K1, GP and the union-block round over one warp's 8
// coordinates k = 8 w + c (c < 8) of a block of at most 128:
// lane L holds K[4 L + i, 8 w + c] (i < 4) in registers for the whole
// solve and reads v[4 L .. 4 L + 3] (one 16-byte load in float: every
// lane a distinct address), forms its 8 partial sums, and the warp adds
// them by a reduce-scatter in a fixed order (xor 16, 8, 4 halve the
// coordinates, xor 2, 1 finish the sums): lane L ends with the total of
// coordinate 8 w + L / 4, as do the other 3 lanes of its quad.
template <typename T>
__device__ __forceinline__ T warp_cols(T (&p)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 4, m = 16; h >= 1; h >>= 1, m >>= 1) {
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const T send = up ? p[i] : p[i + h];
      const T keep = up ? p[i + h] : p[i];
      p[i] = keep + __shfl_xor_sync(FULL, send, m);
    }
  }
  T s = p[0];
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

// sum over l of v[l] K[l, k] for this thread's coordinate (see warp_cols)
template <typename T>
__device__ __forceinline__ T warp_dot(const T* v, const T (&kc)[4][8]) {
  const int lane = threadIdx.x & 31;
  T w[4];
#pragma unroll
  for (int i = 0; i < 4; i += vec_of<T>())
    *reinterpret_cast<uint4*>(w + i) =
        *reinterpret_cast<const uint4*>(v + 4 * lane + i);
  T p[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    p[c] = w[0] * kc[0][c];
#pragma unroll
    for (int i = 1; i < 4; ++i) p[c] += w[i] * kc[i][c];
  }
  return warp_cols(p);
}

// The visit skeleton of K1 (active_pass.cu) and GP (group_pass.cu): a pass
// over the active blocks by a grid of DOT_THREADS-thread CTAs, CTA g
// owning nr rows of r from row0 (`rl`: in its shared memory, or its rows
// of the output), each visit's (n, B) blocks X_b (the residual's) and Xw_b
// (the gradient's: X_b itself but for the weighted kind) read with 16-byte
// loads where `vec` (both designs and B * sizeof(T) 16-byte aligned), else
// masked scalar loads.
constexpr int VISIT_UNROLL = 4;  // 16-byte row loads in flight per thread
constexpr int VISIT_CBATCH = 8;  // partial-c loads in flight per thread

// Warp 0: the next active block in border order after hdr[0] (a ballot
// over 32 entries at a time) into hdr[1] (-1 past the end); every CTA
// walks the same order, and the host reads nothing.
__device__ __forceinline__ void next_active_block(int* hdr,
                                                  const long long* border,
                                                  const unsigned char* active,
                                                  int nb) {
  const int lane = threadIdx.x & 31;
  int cur = hdr[0], blk = -1;
  while (cur < nb) {
    const int i = cur + lane;
    const unsigned m = __ballot_sync(FULL, i < nb && active[border[i]]);
    if (m) {
      const int f = __ffs(m) - 1;
      blk = (int)border[cur + f];
      cur += f + 1;
      break;
    }
    cur += 32;
  }
  __syncwarp();
  if (lane == 0) {
    hdr[0] = cur;
    hdr[1] = blk;
  }
}

// A visit's first phase: this CTA's partial sums of c = Xw_b' r over its
// rows.  Thread (column chunk cl, row group rg) sums V columns over rows
// rg, rg + RG, ..., VISIT_UNROLL rows in flight, and with keep_x stores
// the rows of X_b into xs as it goes (WLS: the unweighted rows, loaded
// beside the weighted).  mid() runs once the sweep is done (K1 issues its
// Gram's prefetch there); then the row groups' sums meet in scr (16-byte
// aligned, DOT_THREADS x V) and are added in group order, and put(j, s)
// takes column j's partial, j < B.
template <typename T, bool WLS, typename Mid, typename Put>
__device__ __forceinline__ void partial_c(const T* Xwb, const T* Xb,
                                          const T* rl, T* xs, T* scr,
                                          int row0, int nr, int B,
                                          int keep_x, bool vec, Mid mid,
                                          Put put) {
  constexpr int V = vec_of<T>();
  const int tid = threadIdx.x;
  const int CL = (B + V - 1) / V;  // column chunks of the row sweep
  const int RG = DOT_THREADS / CL;  // row groups
  const int cl = tid % CL, rg = tid / CL;
  T acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = T(0);
  if (rg < RG) {
    for (int i = rg; i < nr; i += RG * VISIT_UNROLL) {
      T x[VISIT_UNROLL][V];
      // wls: the unweighted rows beside the weighted, to be kept
      T xu[WLS ? VISIT_UNROLL : 1][V];
#pragma unroll
      for (int u = 0; u < VISIT_UNROLL; ++u) {
        const int ii = i + u * RG;
        if (ii < nr) {
          load_chunk(Xwb + (size_t)(row0 + ii) * B, cl * V, B, vec, x[u]);
          if (WLS && keep_x)
            load_chunk(Xb + (size_t)(row0 + ii) * B, cl * V, B, vec,
                       xu[WLS ? u : 0]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) x[u][e] = T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < VISIT_UNROLL; ++u) {
        const int ii = i + u * RG;
        if (ii < nr) {
          T* xd = xs + (size_t)ii * B + cl * V;
          const T(&xk)[V] = WLS ? xu[WLS ? u : 0] : x[u];
          if (keep_x && vec) {
            sts16(xd, xk);
          } else if (keep_x) {
#pragma unroll
            for (int e = 0; e < V; ++e)
              if (cl * V + e < B) xd[e] = xk[e];
          }
          const T rv = rl[ii];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += x[u][e] * rv;
        }
      }
    }
  }
  mid();
  sts16(scr + tid * V, acc);
  __syncthreads();
  if (tid < B) {
    const int cc = tid / V, ee = tid % V;
    T s = T(0);
    for (int qq = 0; qq < RG; ++qq) s += scr[(qq * CL + cc) * V + ee];
    put(tid, s);
  }
}

// c[j] for j < B: the G CTAs' partial sums added in one fixed order, so
// that every CTA holds the same bits.  part(gg) points at CTA gg's B
// partials: in that CTA's shared memory (DSMEM: `peer`'s address, plain
// loads), or in global scratch the other CTAs wrote in this launch (L2
// loads, __ldcg).  With 16-byte loads (vec), thread (column group, subset
// s) sums CTAs s, s + S, ... in order, VISIT_CBATCH loads in flight, and
// the S subsets' sums meet in scr and are added in order; else thread j
// adds column j's partials in CTA order.  Ends with the CTA synchronised.
template <typename T, bool DSMEM, typename Part>
__device__ __forceinline__ void sum_partials(Part part, int G, int B,
                                             bool vec, T* scr, T* c) {
  constexpr int V = vec_of<T>();
  const int tid = threadIdx.x;
  if (vec) {
    const int CG = B / V, S = DOT_THREADS / CG;
    const int cgi = tid % CG, s = tid / CG;
    T acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = T(0);
    if (s < S) {
      for (int g0 = s; g0 < G; g0 += S * VISIT_CBATCH) {
        T v[VISIT_CBATCH][V];
#pragma unroll
        for (int j = 0; j < VISIT_CBATCH; ++j) {
          const int gg = g0 + S * j;
          if (gg < G) {
            const uint4* src =
                reinterpret_cast<const uint4*>(part(gg) + cgi * V);
            uint4 u;
            if constexpr (DSMEM)
              u = *src;
            else
              u = __ldcg(src);
            memcpy(&v[j][0], &u, 16);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[j][e] = T(0);
          }
        }
#pragma unroll
        for (int j = 0; j < VISIT_CBATCH; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += v[j][e];
      }
    }
    sts16(scr + tid * V, acc);
    __syncthreads();
    if (tid < B) {
      T cs = T(0);
      for (int ss = 0; ss < S; ++ss)
        cs += scr[(ss * CG + tid / V) * V + tid % V];
      c[tid] = cs;
    }
  } else if (tid < B) {
    T cs = T(0);
    for (int gg = 0; gg < G; ++gg)
      cs += DSMEM ? part(gg)[tid] : __ldcg(part(gg) + tid);
    c[tid] = cs;
  }
  __syncthreads();
}

// r -= X_b d over this CTA's rows, one warp a row, d (B long) in shared
// memory: the rows of X_b from xs when keep_x, else from global memory
// again.  Lane 0 of the row's warp writes the new r_i and hands it to
// hook(r_i) (K1's sqrt kind sums its squares there).
template <typename T, typename Hook>
__device__ __forceinline__ void update_rows(T* rl, const T* xs, const T* Xb,
                                            const T* d, int row0, int nr,
                                            int B, int keep_x, bool vec,
                                            Hook hook) {
  constexpr int V = vec_of<T>();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < nr; i += DOT_THREADS / 32) {
    T s = T(0);
    for (int k0 = lane * V; k0 < B; k0 += 32 * V) {
      T x[V], dd[V];
      if (keep_x && vec) {
        lds16(xs + (size_t)i * B + k0, x);
      } else if (keep_x) {
        load_chunk_shared(xs + (size_t)i * B, k0, B, x);
      } else {
        load_chunk(Xb + (size_t)(row0 + i) * B, k0, B, vec, x);
      }
      if (vec) {
        lds16(d + k0, dd);
      } else {
        load_chunk_shared(d, k0, B, dd);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) s += x[e] * dd[e];
    }
    s = warp_sum(s);
    if (lane == 0) {
      const T rn = rl[i] - s;
      rl[i] = rn;
      hook(rn);
    }
  }
}

}  // namespace cdt
