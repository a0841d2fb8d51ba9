// Dense gradient sweep (K5): c_j = X_j' r for every column, streaming X once.
//
// Replaces coordinatedescent_jl_tpu/ops/pallas_block.py:fused_gradient_sweep
// (kernel _make_sweep_kernel, launched by _sweep_pass).  One source, two
// instantiations:
//   - cdt_dense_sweep_{f32,f64}: the engine's blocked (nb, n, B) design,
//     element, accumulator and output of one type (the KKT full check's
//     dense refresh, ops/block_cd.py::_full_gradient_c);
//   - cdt_grad64_{f32,f64}: the caller's dense (n, p) design in float32 (or
//     float64), r, the accumulation and the output in float64
//     (ops/compensated.py::grad_f64, the certificate of the f64 polish).
// Both address column j at row i as X[(j / W) n W + i W + j % W]: the row
// stride W is B for the blocked layout (column j lives in block j / B) and
// p for the dense design (one block of width p).
//
// The TPU kernel carries each block's sum in VMEM scratch across the
// sequential row-chunk grid axis.  Here the grid is (column tile, row
// chunk), all in parallel: a (TILE, G) CTA sums R rows of TILE columns of
// one block through common.cuh's chunk_dot (thread (k, g) walks rows g,
// g + G, ... of column k, so neighbouring threads read neighbouring
// addresses of a row) into a partials buffer (nr, ncols); a second kernel
// adds each column's partials in chunk order (no atomics: deterministic).
//
// What bounds it on an H100: device-memory bandwidth.  It reads n p
// sizeof(TX) bytes of X once for 2 n p flops (0.25 flop per byte in f32;
// 0.5 f64 flop per byte in the f64-accumulating form, far below the H100's
// ~20 FP64 flops per byte), and the partials add 2 nr p sizeof(T) bytes,
// under 1 % at the bench shape (R = 256, n = 10,000).
#include "common.cuh"

namespace cdt {

template <typename TX, typename T>
__global__ void dense_partial_kernel(const TX* __restrict__ X,
                                     const T* __restrict__ r, int n, int W,
                                     int tpb, int R, size_t ncols,
                                     T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int t = blockIdx.x, j = blockIdx.y;
  const int b = t / tpb, o = (t % tpb) * blockDim.x;
  const int width = min((int)blockDim.x, W - o);
  const int row0 = j * R, row1 = min(row0 + R, n);
  chunk_dot(X + (size_t)b * n * W + o, W, width, r, row0, row1, red,
            part + (size_t)j * ncols + (size_t)b * W + o);
}

template <typename T>
__global__ void dense_reduce_kernel(const T* __restrict__ part, int nr,
                                    size_t ncols, T* __restrict__ out) {
  const size_t col = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncols) return;
  T s = T(0);
  for (int j = 0; j < nr; ++j) s += part[(size_t)j * ncols + col];
  out[col] = s;
}

template <typename TX, typename T>
int dense_sweep(const TX* X, const T* r, T* part, T* out, int nb, int n,
                int W, int R, cudaStream_t s) {
  if (nb < 1 || n < 1 || W < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int tile = W < 128 ? W : 128;
  const int tpb = (W + tile - 1) / tile;
  const int nr = (n + R - 1) / R;
  if (nr > 65535) return (int)cudaErrorInvalidValue;
  const size_t ncols = (size_t)nb * W;
  const int G = dot_groups(tile);
  dense_partial_kernel<TX, T><<<dim3(nb * tpb, nr), dim3(tile, G),
                                sizeof(T) * tile * G, s>>>(X, r, n, W, tpb, R,
                                                           ncols, part);
  const int nt = 256;
  dense_reduce_kernel<T><<<(unsigned)((ncols + nt - 1) / nt), nt, 0, s>>>(
      part, nr, ncols, out);
  return (int)cudaGetLastError();
}

}  // namespace cdt

#define CDT_DENSE_SWEEP(NAME, TX, T)                                          \
  extern "C" int NAME(const void* X, const void* r, void* part, void* out,    \
                      int nb, int n, int W, int R, void* stream) {            \
    return cdt::dense_sweep<TX, T>((const TX*)X, (const T*)r, (T*)part,       \
                                   (T*)out, nb, n, W, R,                      \
                                   (cudaStream_t)stream);                     \
  }

CDT_DENSE_SWEEP(cdt_dense_sweep_f32, float, float)
CDT_DENSE_SWEEP(cdt_dense_sweep_f64, double, double)
CDT_DENSE_SWEEP(cdt_grad64_f32, float, double)
CDT_DENSE_SWEEP(cdt_grad64_f64, double, double)
