// Shared device helpers of the hand-written kernels: warp/block reductions
// in a fixed order (so every result is deterministic, with no atomics),
// the soft threshold, and the row-chunk dot product c = Xw_b' r that both
// the active pass and the restricted gradient sweep start from.
#pragma once

#include <cuda_runtime.h>

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

// Partial c[k] = sum over rows [row0, row1) of X[i * ld + k] * r[i] for
// the `width` columns of one column tile whose first column X points to,
// with a (W, G) thread block, W = blockDim.x >= width: thread (k, g) sums
// rows g, g + G, ... of column k (neighbouring threads read neighbouring
// addresses of one row), then the G sums are added in order of g.  X's
// element type TX may be narrower than the accumulator T (a float32
// design summed in float64).  `red` holds W * G entries of shared memory.
template <typename TX, typename T>
__device__ void chunk_dot(const TX* __restrict__ X, int ld, int width,
                          const T* __restrict__ r, int row0, int row1, T* red,
                          T* __restrict__ out) {
  const int k = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int W = blockDim.x;
  T acc = T(0);
  if (k < width)
    for (int i = row0 + g; i < row1; i += G)
      acc += T(X[(size_t)i * ld + k]) * r[i];
  red[g * W + k] = acc;
  __syncthreads();
  if (g == 0 && k < width) {
    T s = T(0);
    for (int q = 0; q < G; ++q) s += red[q * W + k];
    out[k] = s;
  }
}

// The same for one (n, B) column block with a (B, G) thread block.
template <typename T>
__device__ void chunk_dot(const T* __restrict__ Xb, const T* __restrict__ r,
                          int row0, int row1, int B, T* red,
                          T* __restrict__ out) {
  chunk_dot<T, T>(Xb, B, B, r, row0, row1, red, out);
}

// Threads of the second axis of chunk_dot's thread block (B * G <= 256).
inline int dot_groups(int B) { return B >= 256 ? 1 : 256 / B; }

}  // namespace cdt
