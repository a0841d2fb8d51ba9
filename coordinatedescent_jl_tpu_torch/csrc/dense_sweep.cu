// Dense gradient sweep (K5): c_j = X_j' r for every column, streaming X once.
//
// Replaces coordinatedescent_jl_tpu/ops/pallas_block.py:fused_gradient_sweep
// (kernel _make_sweep_kernel, launched by _sweep_pass).  One source, two
// instantiations:
//   - cdt_dense_sweep_{f32,f64}: the engine's blocked (nb, n, B) design,
//     element, accumulator and output of one type (the KKT full check's
//     dense refresh, ops/block_cd.py::_full_gradient_c, and the compacted
//     working set's refresh);
//   - cdt_grad64_{f32,f64}: the caller's dense (n, p) design in float32 (or
//     float64), r, the accumulation and the output in float64: each element
//     is widened and the multiply-add runs in float64
//     (ops/compensated.py::grad_f64, the certificate of the f64 polish).
// Both address column j at row i as X[(j / W) n W + i W + j % W]: the row
// stride W is B for the blocked layout (column j lives in block j / B) and
// p for the dense design (one block of width p).
//
// What bounds it on an H100: device-memory bandwidth.  It reads n p
// sizeof(TX) bytes of X once for 2 n p flops (0.25 flop per byte in f32;
// 0.5 f64 flop per byte in the f64-accumulating form, far below the H100's
// ~10 FP64 flops per byte), so the design is about keeping enough bytes in
// flight:
//   - a thread takes V = 16 / sizeof(TX) adjacent columns of a row with one
//     16-byte load; the 128-thread CTA is (TILE / V column lanes) x (row
//     groups), so one warp instruction covers a 128-column row of a tile
//     (f32), and each thread keeps U = 4 such loads in flight;
//   - r is staged a slab of rows at a time in shared memory;
//   - the work items are (column tile, row slice), laid out by the wrapper's
//     planner (kernels/gradient_sweep.py::plan_dense_sweep) in one of three
//     routes:
//       * one slice a tile (many tiles: 782 at the bench shape): a
//         persistent grid, sized by the planner and capped here by the
//         occupancy the card reports, walks the tiles, each summed by one
//         CTA and written straight to the output, no partials;
//       * S <= 16 slices a tile (few tiles and rows, e.g. the
//         varying-coefficient scan's one tile of 500 rows): each tile's S
//         slices are one thread-block cluster, a CTA each; a CTA stores its
//         partial tile into CTA 0's shared memory (distributed shared
//         memory), and after the cluster barrier CTA 0 adds the S partials
//         in slice order and writes the output: one launch, one barrier,
//         no partials in HBM (CTA 0 reads only its own shared memory, so
//         the others leave at once; an mbarrier that the others arrive on
//         measured slower than the hardware barrier, PERF.md);
//       * more slices (the 8-block working set at n = 10K, 66 slices): the
//         persistent grid writes the S partials to HBM and a second,
//         fixed-order pass adds them;
//     a persistent grid rather than a TMA ring of row slabs: with up to 7
//     such CTAs per SM, ~48 KB of loads are in flight per SM, which keeps
//     the sweep within 8 % of the HBM bound on the H100 (PERF.md), and
//     needs no mbarrier pipeline;
//   - every sum runs in a fixed order (rows per thread in order, the row
//     groups in order, the slices in order): deterministic, no atomics; the
//     cluster and the two-pass routes add the same partials in the same
//     order, so at one S they give the same bits.
// A row whose byte stride is not a multiple of 16 (grad_f64 at an odd p)
// takes the same kernel with masked scalar loads.
#include <algorithm>

#include "common.cuh"

namespace cdt {

constexpr int SW_TILE = 128;   // columns per work item
constexpr int SW_THREADS = 128;
constexpr int SW_UNROLL = 4;   // 16-byte loads in flight per thread
constexpr int SW_SLAB = 1024;  // rows of r staged in shared memory

// CLUSTER: the grid is the items, a tile's `split` slices one cluster.
template <typename TX, typename T, bool CLUSTER>
__global__ void __launch_bounds__(SW_THREADS)
sweep_kernel(const TX* __restrict__ X, const T* __restrict__ r, int nb, int n,
             int W, int tpb, int split, int rows, int vec, size_t ncols,
             T* __restrict__ out, T* __restrict__ part) {
  constexpr int V = vec_of<TX>();
  constexpr int CL = SW_TILE / V;       // column lanes
  constexpr int RG = SW_THREADS / CL;   // row groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);  // [SW_SLAB]
  T* red = rs + SW_SLAB;                   // [RG][SW_TILE]
  T* pt = red + RG * SW_TILE;              // cluster: [split][SW_TILE] partials
  const int tid = threadIdx.x;
  const int cl = tid % CL, rg = tid / CL;
  const int items = nb * tpb * split;
  // cluster: every CTA has started before any stores into CTA 0 (the wait
  // below, long complete by then)
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int s = it % split, tile = it / split;
    const int b = tile / tpb, o = (tile % tpb) * SW_TILE;
    const int width = min(SW_TILE, W - o);
    const int row0 = min(s * rows, n), row1 = min(row0 + rows, n);
    const TX* base = X + (size_t)b * n * W + o;
    T acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = T(0);
    // rows i + u RG (u < SW_UNROLL) of this thread's columns, zero past s1
    auto load_rows = [&](TX (&x)[SW_UNROLL][V], int i, int s1) {
#pragma unroll
      for (int u = 0; u < SW_UNROLL; ++u) {
        const int row = i + u * RG;
        if (row < s1) {
          load_chunk(base + (size_t)row * W, cl * V, width, vec, x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) x[u][e] = TX(0);
        }
      }
    };
    for (int s0 = row0; s0 < row1; s0 += SW_SLAB) {
      const int s1 = min(s0 + SW_SLAB, row1);
      // software-pipelined: the next rows' loads are in flight while this
      // step's multiply-adds (and, for grad64, the widening) run; a
      // cluster's short slices issue their first loads under r's staging
      TX x[SW_UNROLL][V], xn[SW_UNROLL][V];
      if (CLUSTER) load_rows(x, s0 + rg, s1);
      __syncthreads();
      for (int i = s0 + tid; i < s1; i += SW_THREADS) rs[i - s0] = r[i];
      __syncthreads();
      if (!CLUSTER) load_rows(x, s0 + rg, s1);
      for (int i = s0 + rg; i < s1; i += RG * SW_UNROLL) {
        if (i + RG * SW_UNROLL < s1) load_rows(xn, i + RG * SW_UNROLL, s1);
#pragma unroll
        for (int u = 0; u < SW_UNROLL; ++u) {
          const int row = i + u * RG;
          const T rv = row < s1 ? rs[row - s0] : T(0);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += T(x[u][e]) * rv;
        }
#pragma unroll
        for (int u = 0; u < SW_UNROLL; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) x[u][e] = xn[u][e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < V; ++e) red[rg * SW_TILE + cl * V + e] = acc[e];
    __syncthreads();
    // the cluster route stores its partial tile into row s of CTA 0's pt
    if constexpr (CLUSTER) cluster_wait();
    T* dst = CLUSTER      ? peer(pt, 0) + s * SW_TILE
             : split == 1 ? out + (size_t)b * W + o
                          : part + (size_t)s * ncols + (size_t)b * W + o;
    for (int k = tid; k < width; k += SW_THREADS) {
      T sum = T(0);
      for (int q = 0; q < RG; ++q) sum += red[q * SW_TILE + k];
      dst[k] = sum;
    }
    if constexpr (CLUSTER) {
      // CTA 0 of the tile's cluster (slice 0) adds the slices' partials in
      // slice order, as sweep_reduce_kernel does
      cluster_sync();
      if (s == 0) {
        for (int k = tid; k < width; k += SW_THREADS) {
          T sum = T(0);
          for (int j = 0; j < split; ++j) sum += pt[j * SW_TILE + k];
          out[(size_t)b * W + o + k] = sum;
        }
      }
    }
  }
}

// out[col] = the S partials of col added in slice order.
template <typename T>
__global__ void sweep_reduce_kernel(const T* __restrict__ part, int split,
                                    size_t ncols, T* __restrict__ out) {
  const size_t col = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncols) return;
  T s = T(0);
  for (int j = 0; j < split; ++j) s += part[(size_t)j * ncols + col];
  out[col] = s;
}

// cluster: the tile's slices are one cluster each (2 <= split <= 16; the
// grid is then every item, and `part` and `grid` are unused).
template <typename TX, typename T>
int dense_sweep(const TX* X, const T* r, T* part, T* out, int nb, int n,
                int W, int split, int rows, int grid, int cluster,
                cudaStream_t s) {
  if (nb < 1 || n < 1 || W < 1 || split < 1 || rows < 1 || grid < 1 ||
      (long long)split * rows < n ||
      (cluster ? split < 2 || split > MAX_CLUSTER
               : split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int V = vec_of<TX>();
  constexpr int RG = SW_THREADS / (SW_TILE / V);
  const int tpb = (W + SW_TILE - 1) / SW_TILE;
  const size_t ncols = (size_t)nb * W;
  const long long items = (long long)nb * tpb * split;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = (reinterpret_cast<uintptr_t>(X) % 16 == 0) &&
                  ((size_t)W * sizeof(TX)) % 16 == 0;
  const size_t smem = sizeof(T) * (SW_SLAB + RG * SW_TILE);
  if (cluster) {
    // CTA 0's rows of the slices' partials
    const size_t csmem = smem + sizeof(T) * split * SW_TILE;
    const cudaError_t e = launch_clusters(
        sweep_kernel<TX, T, true>, (int)items, SW_THREADS, csmem, split, s, X,
        r, nb, n, W, tpb, split, rows, vec, ncols, out, (T*)nullptr);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // the planner's grid, capped by what the card keeps resident at once
  int resident = 0;
  const cudaError_t e = resident_ctas((const void*)sweep_kernel<TX, T, false>,
                                      SW_THREADS, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  grid = (int)std::min<long long>({(long long)grid, items,
                                   (long long)std::max(resident, 1)});
  sweep_kernel<TX, T, false><<<grid, SW_THREADS, smem, s>>>(
      X, r, nb, n, W, tpb, split, rows, vec, ncols, out, part);
  if (split > 1) {
    const int nt = 256;
    sweep_reduce_kernel<T><<<(unsigned)((ncols + nt - 1) / nt), nt, 0, s>>>(
        part, split, ncols, out);
  }
  return (int)cudaGetLastError();
}

// The clusters of `cluster` slices (CTAs) of a tile, with CTA 0's shared
// memory for their partials, that the current device holds at once.
template <typename TX, typename T>
int sweep_clusters(int cluster, int* count) {
  constexpr int RG = SW_THREADS / (SW_TILE / vec_of<TX>());
  const size_t csmem =
      sizeof(T) * (SW_SLAB + RG * SW_TILE + (size_t)cluster * SW_TILE);
  return (int)active_clusters((const void*)sweep_kernel<TX, T, true>,
                              SW_THREADS, csmem, cluster, count);
}

}  // namespace cdt

#define CDT_DENSE_SWEEP(NAME, TX, T)                                          \
  extern "C" int NAME##_clusters(int cluster, void* count) {                  \
    return cdt::sweep_clusters<TX, T>(cluster, (int*)count);                  \
  }                                                                           \
  extern "C" int NAME(const void* X, const void* r, void* part, void* out,    \
                      int nb, int n, int W, int split, int rows, int grid,    \
                      int cluster, void* stream) {                            \
    return cdt::dense_sweep<TX, T>((const TX*)X, (const T*)r, (T*)part,       \
                                   (T*)out, nb, n, W, split, rows, grid,      \
                                   cluster, (cudaStream_t)stream);            \
  }

CDT_DENSE_SWEEP(cdt_dense_sweep_f32, float, float)
CDT_DENSE_SWEEP(cdt_dense_sweep_f64, double, double)
CDT_DENSE_SWEEP(cdt_grad64_f32, float, double)
CDT_DENSE_SWEEP(cdt_grad64_f64, double, double)
