// The design's set-up copy (BL): the zero-padded column-blocked layout
// Xb[b, i, k] = X[i, b B + k] (0 where b B + k >= p) and each column's sum
// of squares, in one read of X and one write of Xb, float and double.
//
// Replaces no Pallas kernel: the JAX package builds the blocked design with
// jnp.pad + reshape/transpose and sums the squares with jnp.sum under XLA
// (ops/block_cd.py:build_blocked).  The port's plain twin makes the same
// three passes in eager ATen (kernels/blockify.py::blockify_plain): a padded
// copy, a strided permute copy, and a squared design-sized temporary read
// back by a reduction, ~7 x 4.0e9 B of traffic at 10,000 x 100,000 float32.
//
// What bounds it on an H100: device-memory bandwidth.  It moves
// n p x_item bytes in and n nb B x_item out (8.0e9 B at 10,000 x 100,000
// float32, 2.39 ms at 3.35 TB/s) for 2 flops an element.  A CTA copies one
// row chunk of a few adjacent column blocks, one block a row of threads:
// each row of X it reads is one contiguous span of those blocks, and each
// thread writes its block's rows one after another, a contiguous stream.
// Both sides move in 16-byte accesses where the strides and the base allow
// (else one element a thread, any strides), BL_UNROLL rows in flight a
// thread.  Each thread keeps its columns' sums in double registers (each
// float32 square is exact in double), in row order; the row chunks'
// partials are added in chunk order by blockify_reduce_kernel (by the copy
// itself where one chunk covers n): no atomics, the same bits every run;
// the sums are rounded to the design's dtype once.
#include "common.cuh"

namespace cdt {

constexpr int BL_THREADS = 256;  // threads of a CTA at B's lanes or fewer
constexpr int BL_UNROLL = 4;     // rows a thread loads before it stores
constexpr int BL_MAXB = 1024;

template <typename T>
__device__ __forceinline__ T bl_finish(double s, int norm) {
  return norm ? (T)sqrt(s) : (T)s;
}

// Thread (tx, ty) of CTA (x, j) covers the V columns b B + tx V + [0, V),
// b = x blockDim.y + ty, of the rows [j R, j R + R) below n; V = 16 /
// sizeof(T) on the 16-byte path, else 1 with any column stride cs.
template <typename T, bool VEC>
__global__ void __launch_bounds__(BL_MAXB)
    blockify_kernel(const T* __restrict__ X, long long ld, long long cs,
                    int n, int p, int B, int R, T* __restrict__ Xb,
                    double* __restrict__ part, T* __restrict__ out,
                    int norm) {
  constexpr int V = VEC ? vec_of<T>() : 1;
  const int b = blockIdx.x * blockDim.y + threadIdx.y;
  const int j = blockIdx.y, nr = gridDim.y;
  if (b >= (p + B - 1) / B) return;
  const int k0 = threadIdx.x * V;
  const long long c0 = (long long)b * B + k0;
  const bool live = c0 < p;  // on the 16-byte path p % V == 0
  const int row0 = j * R, row1 = min(row0 + R, n);
  const T* src = X + c0 * cs;
  T* dst = Xb + (size_t)b * n * B + k0;
  double acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0;

  auto load = [&](int i, T (&v)[V]) {
    if (!live) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = T(0);
    } else if constexpr (VEC) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + i * ld));
      memcpy(&v[0], &u, 16);
    } else {
      v[0] = __ldg(src + i * ld);
    }
  };
  auto put = [&](int i, const T (&v)[V]) {
    if constexpr (VEC) {
      uint4 u;
      memcpy(&u, &v[0], 16);
      *reinterpret_cast<uint4*>(dst + (size_t)i * B) = u;
    } else {
      dst[(size_t)i * B] = v[0];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += (double)v[e] * (double)v[e];
  };

  int i = row0;
  for (; i + BL_UNROLL <= row1; i += BL_UNROLL) {
    T v[BL_UNROLL][V];
#pragma unroll
    for (int u = 0; u < BL_UNROLL; ++u) load(i + u, v[u]);
#pragma unroll
    for (int u = 0; u < BL_UNROLL; ++u) put(i + u, v[u]);
  }
  for (; i < row1; ++i) {
    T v[V];
    load(i, v);
    put(i, v);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (nr == 1)
      out[(size_t)b * B + k0 + e] = bl_finish<T>(acc[e], norm);
    else
      part[((size_t)b * nr + j) * B + k0 + e] = acc[e];
  }
}

// out[b, k] = the chunks' partials of column b B + k added in chunk order
template <typename T>
__global__ void blockify_reduce_kernel(const double* __restrict__ part,
                                       int nr, int B, T* __restrict__ out,
                                       int norm) {
  const int b = blockIdx.x, k = threadIdx.x;
  if (k >= B) return;
  const double* q = part + (size_t)b * nr * B + k;
  double s = 0.0;
  for (int j = 0; j < nr; ++j) s += q[(size_t)j * B];
  out[(size_t)b * B + k] = bl_finish<T>(s, norm);
}

template <typename T>
int blockify(const T* X, long long ld, long long cs, T* Xb, double* part,
             T* out, int n, int p, int B, int R, int vec, int norm,
             cudaStream_t s) {
  constexpr int V = vec_of<T>();
  if (B < 1 || B > BL_MAXB || R < 1 || n < 1 || p < 1 ||
      (vec && (B % V != 0 || p % V != 0 || ld % V != 0 || cs != 1 ||
               reinterpret_cast<uintptr_t>(X) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const int nb = (p + B - 1) / B, nr = (n + R - 1) / R;
  if (nr > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  // a row of threads a block, as many blocks as BL_THREADS threads hold
  const int lanes = vec ? B / V : B;
  const dim3 block(lanes, lanes >= BL_THREADS ? 1 : BL_THREADS / lanes);
  const dim3 grid((nb + block.y - 1) / block.y, nr);
  if (vec)
    blockify_kernel<T, true><<<grid, block, 0, s>>>(X, ld, cs, n, p, B, R,
                                                    Xb, part, out, norm);
  else
    blockify_kernel<T, false><<<grid, block, 0, s>>>(X, ld, cs, n, p, B, R,
                                                     Xb, part, out, norm);
  if (nr > 1)
    blockify_reduce_kernel<T><<<nb, (B + 31) / 32 * 32, 0, s>>>(part, nr, B,
                                                                out, norm);
  return (int)cudaGetLastError();
}

}  // namespace cdt

#define CDT_BLOCKIFY(SUFFIX, T)                                               \
  extern "C" int cdt_blockify_##SUFFIX(                                       \
      const void* X, long long ld, long long cs, void* Xb, void* part,        \
      void* out, int n, int p, int B, int R, int vec, int norm,               \
      void* stream) {                                                         \
    return cdt::blockify<T>((const T*)X, ld, cs, (T*)Xb, (double*)part,       \
                            (T*)out, n, p, B, R, vec, norm,                   \
                            (cudaStream_t)stream);                            \
  }

CDT_BLOCKIFY(f32, float)
CDT_BLOCKIFY(f64, double)
