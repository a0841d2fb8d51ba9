// Shared device helpers of the hand-written kernels: warp/block reductions
// in a fixed order (so every result is deterministic, with no atomics),
// the soft threshold, the restricted gradient sweep's row-chunk dot
// product c = Xw_b' r, 16-byte loads with a masked scalar fallback, and
// the cached residency query the launchers size their grids by.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

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
