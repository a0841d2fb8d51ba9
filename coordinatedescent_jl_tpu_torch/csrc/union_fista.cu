// The batched path's union-block FISTA round, float and double, in one
// launch.
//
// Replaces no Pallas kernel: coordinatedescent_jl_tpu/ops/batched_certify.py
// ::union_block_fista is an XLA lax.scan (sweeps x blocks x steps), whose
// plain PyTorch counterpart, ops/batched_certify.py::union_block_fista_plain,
// is a host loop of small eager launches, ~14,700 device operations a round
// at the batched path's Cp = 1,024, block 128, 16 steps, 8 sweeps.  This
// kernel computes the same round with the same arithmetic: per block b
// (offset o) of the union Gram Ks (Cp x Cp), the Gershgorin majorizer
// L_b = max row sum of |K_bb| (at least 1e-30), thr_L = thr_b / L_b, then
// block_iters steps of
//     gv = cs_b - (v - bs_b) K_bb,  z = soft(v + gv / L_b, thr_L),
//     v = z + coef_t (z - z_prev)
// from v = z = bs_b, with the momentum coefficients coef_t the host
// computed in the working dtype; then cs -= (z - bs_b) Ks[o:o+B, :] and
// bs_b = z.  No convergence exit: every sweep runs every step.
//
// Design: one CTA of 512 threads a lane (98 lanes at the cell's shape: one
// wave on 132 SMs); a certified (frozen) lane's CTA copies Bs0 and exits,
// which is what the plain round returns for it.  The lane's bs, cs and
// thr live in shared memory for the whole round.  Per block the CTA loads
// K_bb into registers in K1's layout (common.cuh::warp_dot: a warp owns 8
// coordinates, lane L rows 4 L .. 4 L + 3 of their columns) and each step
// is one 16-byte shared-memory read of v - bs_b a lane, a fixed-order
// reduce-scatter of shuffles and one __syncthreads.  The majorizers are
// found in the first sweep (row sums across the warps in warp order, then
// a block max) and kept.  The panel update streams Ks[o:o+B, :] from L2
// with 16-byte loads (where Cp is a multiple of 16 / sizeof(T) and Ks
// 16-byte aligned; else scalar loads), each thread a column chunk over a
// group of rows, the groups' partial sums added in group order.  Every sum
// is in a fixed order: deterministic, no atomics; the sums run in another
// order than cuBLAS's, so results match the plain round to rounding.
//
// What bounds it on an H100: the chain of dependent steps, not the bytes or
// the flops.  A round is 2 k sweeps ncb (iters B^2 + B Cp) flops (4.9 GFLOP
// at k = 98, Cp = 1,024: 0.07 ms at the 67 TFLOP/s f32 peak) on a Gram of
// Cp^2 sizeof(T) bytes (4 MB in f32) that stays in L2 while every CTA reads
// it once a sweep; but each lane's sweeps x ncb x iters steps (1,024) run
// one after another, each a shared-memory read, a shuffle tree and a
// barrier (K1's step: ~1,100 SM cycles), with a panel read of B Cp
// sizeof(T) bytes from L2 per block.  One launch a round instead of one
// per operation takes the host's dispatch off that chain.
#include "common.cuh"

namespace cdt {

// The CTA is common.cuh's DOT_THREADS (warp_dot's layout), and the widest
// block DOT_MAXB.
constexpr int UF_UNROLL = 8;     // panel rows in flight per thread
// scratch: the row sums' 16 warps x 128 rows, or the panel's row groups'
// partials (G x Cp <= DOT_THREADS x 16 / sizeof(T) entries)
constexpr int UF_SCR = 2048;

// Shared-memory layout, in elements of T; every array starts 16-byte
// aligned.  kernels/union_fista.py::smem_bytes computes the same bytes.
struct UfLayout {
  int bs, cs, thr, u, d, scr, lb, mom, red;
  size_t bytes;
};

template <typename T>
__host__ __device__ inline UfLayout uf_layout(int Cp, int B, int iters) {
  UfLayout L;
  int o = 0;
  L.bs = o;  o += vec_up<T>(Cp);         // the lane's coefficients
  L.cs = o;  o += vec_up<T>(Cp);         // its gradients Xs'R, kept current
  L.thr = o; o += vec_up<T>(Cp);         // its thresholds
  L.u = o;   o += 2 * DOT_MAXB;          // v - bs_b, by step parity
  L.d = o;   o += DOT_MAXB;              // the block's change
  L.scr = o; o += UF_SCR;
  L.lb = o;  o += vec_up<T>(Cp / B);     // the blocks' majorizers
  L.mom = o; o += vec_up<T>(iters);      // the momentum coefficients
  L.red = o; o += 32;                    // block_max slots
  L.bytes = sizeof(T) * (size_t)o;
  return L;
}

// W elements at p, one 16-byte load (W = 16 / sizeof(T), p aligned) or one
// scalar (W = 1); read-only data.
template <typename T, int W>
__device__ __forceinline__ void ldg_w(const T* p, T (&x)[W]) {
  if constexpr (W == 1) {
    x[0] = __ldg(p);
  } else {
    static_assert(W * sizeof(T) == 16, "one 16-byte load");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&x[0], &u, 16);
  }
}

// cs[j] -= sum over r < B of d[r] P[r Cp + j] for every j < Cp (P =
// Ks + o Cp, the block's row panel), W columns a chunk.  Where the chunks
// are fewer than the threads, G row groups split the rows (group g sums
// rows g, g + G, ...) and their partials are added in group order.  Ends
// with the CTA synchronised.
template <typename T, int W>
__device__ void panel_update(const T* __restrict__ P, const T* d, T* cs,
                             T* scr, int Cp, int B) {
  const int tid = threadIdx.x;
  const int nch = Cp / W;
  const int G = nch >= DOT_THREADS ? 1 : min(B, DOT_THREADS / nch);
  const int g = tid / nch;
  for (int c = tid % nch; c < nch && g < G; c += DOT_THREADS) {
    T acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = T(0);
    for (int r0 = g; r0 < B; r0 += G * UF_UNROLL) {
      T x[UF_UNROLL][W];
#pragma unroll
      for (int u = 0; u < UF_UNROLL; ++u) {
        const int r = r0 + u * G;
        if (r < B) {
          ldg_w<T, W>(P + (size_t)r * Cp + c * W, x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) x[u][e] = T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < UF_UNROLL; ++u) {
        const int r = r0 + u * G;
        if (r < B) {
          const T dr = d[r];
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] += dr * x[u][e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      if (G == 1)
        cs[c * W + e] -= acc[e];
      else
        scr[g * Cp + c * W + e] = acc[e];
    }
  }
  __syncthreads();
  if (G > 1) {
    for (int j = tid; j < Cp; j += DOT_THREADS) {
      T t = scr[j];
      for (int q = 1; q < G; ++q) t += scr[q * Cp + j];
      cs[j] -= t;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(DOT_THREADS, 1)
    union_fista_kernel(const T* __restrict__ Ks, const T* __restrict__ thr_in,
                       const T* __restrict__ Bs0, const T* __restrict__ cs0,
                       const unsigned char* __restrict__ cert,
                       const T* __restrict__ mom_in, T* __restrict__ out,
                       int Cp, int B, int iters, int n_sweeps, int vec) {
  constexpr int V = vec_of<T>();
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t row = (size_t)blockIdx.x * Cp;
  if (cert[blockIdx.x]) {  // frozen: the plain round keeps Bs0
    for (int j = tid; j < Cp; j += DOT_THREADS) out[row + j] = Bs0[row + j];
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const UfLayout Ly = uf_layout<T>(Cp, B, iters);
  T *bs = sm + Ly.bs, *cs = sm + Ly.cs, *thr = sm + Ly.thr;
  T *U0 = sm + Ly.u, *U1 = U0 + DOT_MAXB, *D = sm + Ly.d, *scr = sm + Ly.scr;
  T *Lb = sm + Ly.lb, *mom = sm + Ly.mom, *red = sm + Ly.red;
  for (int j = tid; j < Cp; j += DOT_THREADS) {
    bs[j] = Bs0[row + j];
    cs[j] = cs0[row + j];
    thr[j] = thr_in[row + j];
  }
  for (int j = tid; j < iters; j += DOT_THREADS) mom[j] = mom_in[j];
  // v - bs_b is 0 past B (warp_dot reads all 128)
  for (int j = tid; j < 2 * DOT_MAXB; j += DOT_THREADS) U0[j] = T(0);
  __syncthreads();

  const int k = tid >> 2;  // this thread's coordinate (warp_dot's result)
  const bool own = k < B;
  const bool lead = own && (tid & 3) == 0;  // writes coordinate k
  const int ncb = Cp / B;
  const bool vec_k = vec && B % V == 0;     // 16-byte Gram tile loads
  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int b = 0; b < ncb; ++b) {
      const int o = b * B;
      // 1. K_bb in registers: kc[i][c] = K[o + 4 lane + i, o + 8 w + c]
      T kc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * lane + i;
        const T* kr = Ks + (size_t)(o + min(l, B - 1)) * Cp + o;
#pragma unroll
        for (int j0 = 0; j0 < 8; j0 += V) {
          T u[V];
          load_chunk(kr, 8 * w + j0, B, vec_k, u);
#pragma unroll
          for (int e = 0; e < V; ++e) kc[i][j0 + e] = l < B ? u[e] : T(0);
        }
      }
      // 2. the majorizer: max over rows of sum |K_bb[l, :]|, first sweep
      T L;
      if (sweep == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          T s = tabs(kc[i][0]);
#pragma unroll
          for (int c = 1; c < 8; ++c) s += tabs(kc[i][c]);
          scr[w * DOT_MAXB + 4 * lane + i] = s;
        }
        __syncthreads();
        T rsum = T(0);
        if (tid < B) {
          rsum = scr[tid];
          for (int q = 1; q < DOT_THREADS / 32; ++q)
            rsum += scr[q * DOT_MAXB + tid];
        }
        L = tmax(block_max(rsum, red), T(1e-30));
        if (tid == 0) Lb[b] = L;
      } else {
        L = Lb[b];
      }
      // 3. the block's FISTA steps from v = z = bs_b
      const T bk = own ? bs[o + k] : T(0);
      const T ck = own ? cs[o + k] : T(0);
      const T tl = own ? thr[o + k] / L : T(0);
      T v = bk, z = bk;
      if (lead) U0[k] = v - bk;
      __syncthreads();
      for (int it = 0; it < iters; ++it) {
        const T* Uc = (it & 1) ? U1 : U0;
        T* Un = (it & 1) ? U0 : U1;
        const T s = warp_dot(Uc, kc);
        if (own) {
          const T gv = ck - s;
          const T zn = soft(v + gv / L, tl);
          v = zn + mom[it] * (zn - z);
          z = zn;
        }
        if (lead) Un[k] = v - bk;
        __syncthreads();
      }
      // 4. bs_b = z, and cs -= (z - bs_b) Ks[o:o+B, :]
      if (lead) {
        D[k] = z - bk;
        bs[o + k] = z;
      }
      __syncthreads();
      if (vec)
        panel_update<T, V>(Ks + (size_t)o * Cp, D, cs, scr, Cp, B);
      else
        panel_update<T, 1>(Ks + (size_t)o * Cp, D, cs, scr, Cp, B);
    }
  }
  for (int j = tid; j < Cp; j += DOT_THREADS) out[row + j] = bs[j];
}

template <typename T>
int union_fista(const T* Ks, const T* thr, const T* Bs0, const T* cs0,
                const unsigned char* cert, const T* mom, T* out, int k,
                int Cp, int B, int iters, int n_sweeps, int vec, int smem,
                cudaStream_t s) {
  if (B < 1 || B > DOT_MAXB || Cp < B || Cp % B != 0 || iters < 0 ||
      n_sweeps < 0 || (size_t)smem != uf_layout<T>(Cp, B, iters).bytes)
    return (int)cudaErrorInvalidValue;
  if (k < 1) return (int)cudaGetLastError();
  auto kern = union_fista_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<k, DOT_THREADS, smem, s>>>(Ks, thr, Bs0, cs0, cert, mom, out, Cp,
                                    B, iters, n_sweeps, vec);
  return (int)cudaGetLastError();
}

}  // namespace cdt

#define CDT_UNION_FISTA(SUFFIX, T)                                            \
  extern "C" int cdt_union_fista_##SUFFIX(                                    \
      const void* Ks, const void* thr, const void* Bs0, const void* cs0,      \
      const void* cert, const void* mom, void* out, int k, int Cp, int B,     \
      int iters, int n_sweeps, int vec, int smem, void* stream) {             \
    return cdt::union_fista<T>((const T*)Ks, (const T*)thr, (const T*)Bs0,    \
                               (const T*)cs0, (const unsigned char*)cert,     \
                               (const T*)mom, (T*)out, k, Cp, B, iters,       \
                               n_sweeps, vec, smem, (cudaStream_t)stream);    \
  }

CDT_UNION_FISTA(f32, float)
CDT_UNION_FISTA(f64, double)
