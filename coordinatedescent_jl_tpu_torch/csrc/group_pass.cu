// The group engine's active pass (GP), float and double, for the
// least-squares, weighted least-squares and sqrt-lasso kinds, in one
// cooperative launch.
//
// Replaces no Pallas kernel: the JAX engine's group visit
// (coordinatedescent_jl_tpu/ops/group_cd.py) runs outside Pallas.  Its plain
// PyTorch counterpart, ops/group_cd.py::_group_active_pass_plain, is a host
// loop over the active blocks of ~268 eager operations a visit (16 FISTA
// steps of 128-wide products, adds, divides and the group prox, then the
// zero snap).  This kernel runs the same pass with the same arithmetic, per
// visited block b (B = k G lanes, k groups of G):
//     c0 = Xw_b' r,  L = max(L_b, 1e-30),  thr_g = n_scale lam0 w_g / L
//     (the wrapper's (nb, k) table),  d = d_prev = beta0,
//     iters steps of  yv = d + coef_t (d - d_prev),
//                     z = yv + (c0 - K_b (yv - beta0)) / L,
//                     d_prev = d,  d = z max(1 - thr_g / max(||z_g||, 1e-30), 0)
//     (the momentum coefficients coef_t from the host, in the working dtype);
//     then the exact per-group zero snap: q = c0 - K_b (d - beta0),
//     s_g = q_g + K_gg d_g, the group set to 0 iff ||s_g|| <= L thr_g;
//     maxh = max(maxh, max |d - beta0|); d = 0 on the padded lanes;
//     r -= X_b (d - beta0); beta_b = d.
// The kinds differ only outside the visit: wls takes c0 from the weighted
// design Xw and updates r from X; sqrt has n_scale = ||r|| in its
// thresholds, which the wrapper folds into the table.
//
// Design, on K1's cooperative route (csrc/active_pass.cu's header):
//   - a co-resident grid of at most one CTA an SM (cudaLaunchCooperativeKernel,
//     grid barriers by cooperative groups' grid.sync()); CTA g owns rows
//     [g R, g R + R) of r for the whole pass, in shared memory when the plan
//     keeps them (else in its rows of r_out), and writes them out at the end;
//   - the visit order is found on the device: every CTA walks `border` and
//     takes the next block whose `active` flag is set (a warp ballot over 32
//     entries at a time, during the previous visit's residual update), so the
//     pass reads nothing to the host;
//   - per visit each CTA reads its rows of Xw_b once with 16-byte loads
//     (keeping the rows of X_b in shared memory when they fit), writes its B
//     partial sums of c0 (double-buffered by visit parity), issues the loads
//     of the block's Gram into registers, and meets the others at one grid
//     barrier;
//   - every CTA then solves the block redundantly: the partials added in one
//     fixed order and the same code give every CTA a bit-identical d, so no
//     CTA waits for a published result.  A warp owns 8 coordinates (K1's
//     layout, common.cuh::warp_dot), here on the Gram's rows, K_b v as the
//     plain twin's product: lane L holds K[8 w + c, 4 L + i]; a step reads
//     yv - beta0 once a warp and meets one __syncthreads.  A group's norm is
//     a butterfly of shuffles where G divides 8 (a group lies in one warp's
//     coordinates), else a sum over shared memory in lane order behind a
//     second barrier (groups of 5, 6, 16 or 128 straddle warps);
//   - each CTA updates its own rows, r -= X_b (d - beta0), from the rows it
//     kept; CTA 0 writes beta_b and, at the end, maxh.
// Every sum is in a fixed order: no atomics, deterministic.  The sums run in
// another order than cuBLAS's and PyTorch's reductions, so the pass matches
// the plain twin to rounding.
//
// What bounds it on an H100: a visit streams the (n, B) block once (5.1 MB
// at n = 10,000, B = 128, f32: 1.5 us at 3.35 TB/s) and each CTA reads the
// B x B Gram from L2, for 4 n B + 2 iters B^2 flops; the chain of a grid
// barrier and iters dependent steps (each a shared-memory read, a shuffle
// tree and a barrier) is what a visit waits for.  One launch a pass takes the
// host's dispatch of ~268 operations a visit off that chain.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cdt {

constexpr int GP_THREADS = 512;  // 128 coordinates x 4 (warp_dot's layout)
constexpr int GP_MAXB = 128;     // widest block (warp_dot covers 128)
constexpr int GP_UNROLL = 4;     // 16-byte row loads in flight per thread
constexpr int GP_CBATCH = 8;     // partial-c loads in flight per thread

// Shared-memory layout, in elements of T after a 16-byte header of ints;
// every array starts 16-byte aligned.  kernels/group_pass.py::smem_bytes
// computes the same bytes, and the launch refuses any other count.
struct GpLayout {
  int scr, c, b0, u, ds, dd, sq, thr, red, mom, rs, xs;
  size_t bytes;
};

// x rounded up to whole 16-byte chunks of T
template <typename T>
__host__ __device__ inline int gp_up(int x) {
  return (x + vec_of<T>() - 1) / vec_of<T>() * vec_of<T>();
}

template <typename T>
__host__ __device__ inline GpLayout gp_layout(int B, int rows, int keep_x,
                                              int keep_r, int iters) {
  GpLayout L;
  int o = 0;
  L.scr = o; o += GP_THREADS * vec_of<T>();  // row-group and partial sums
  L.c = o;   o += GP_MAXB;                   // c0
  L.b0 = o;  o += GP_MAXB;                   // beta0
  L.u = o;   o += 2 * GP_MAXB;               // yv - beta0, by step parity
  L.ds = o;  o += GP_MAXB;                   // d, for the snap's K_gg d_g
  L.dd = o;  o += GP_MAXB;                   // the block's change
  L.sq = o;  o += GP_MAXB;                   // squares for a group's norm
  L.thr = o; o += GP_MAXB;                   // the block's group thresholds
  L.red = o; o += 32;                        // block_max slots
  L.mom = o; o += gp_up<T>(iters);           // the momentum coefficients
  L.rs = o;  o += keep_r ? gp_up<T>(rows) : 0;  // the CTA's rows of r
  L.xs = o;  o += keep_x ? rows * B : 0;        // its rows of X_b
  L.bytes = 16 + sizeof(T) * (size_t)o;
  return L;
}

// Warp 0: the next active block in border order after hdr[0] (a ballot over
// 32 entries at a time) into hdr[1] (-1 past the end); every CTA walks the
// same order.  (K1's find_next, which csrc/active_pass.cu keeps to itself.)
__device__ __forceinline__ void gp_next(int* hdr,
                                        const long long* __restrict__ border,
                                        const unsigned char* __restrict__ active,
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

// sum over j in the group of this thread's coordinate of v[j] K[k, j]
// (warp_dot's layout with the other groups' columns masked out)
template <typename T>
__device__ __forceinline__ T group_dot(const T* v, const T (&kc)[4][8],
                                       int G) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T x[4];
#pragma unroll
  for (int i = 0; i < 4; i += vec_of<T>())
    *reinterpret_cast<uint4*>(x + i) =
        *reinterpret_cast<const uint4*>(v + 4 * lane + i);
  T p[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int gc = (8 * w + c) / G;
    p[c] = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((4 * lane + i) / G == gc) p[c] += x[i] * kc[i][c];
  }
  return warp_cols(p);
}

// ||z_g|| for the group of this thread's coordinate k (z of the other lanes
// of the quad equal to this one's; 0 for k >= B).  `shfl` (G divides 8): a
// butterfly over the lanes of the group's coordinates, the same sum in every
// lane.  Else the lead threads write the squares, a barrier, and every thread
// of the group adds them in lane order.  Called by every thread.
template <typename T>
__device__ __forceinline__ T group_norm(T z, bool shfl, int G, int k,
                                        bool own, bool lead, T* SQ) {
  T s2 = z * z;
  if (shfl) {
    for (int m = 4; m < 4 * G; m <<= 1) s2 += __shfl_xor_sync(FULL, s2, m);
  } else {
    if (lead) SQ[k] = s2;
    __syncthreads();
    if (own) {
      const T* q = SQ + k / G * G;
      s2 = q[0];
      for (int j = 1; j < G; ++j) s2 += q[j];
    }
  }
  return sqrt(s2);
}

template <typename T, bool WLS>
__global__ void __launch_bounds__(GP_THREADS, 1)
group_pass_kernel(const T* __restrict__ X, const T* __restrict__ Xw,
                  const T* __restrict__ Kb, const T* __restrict__ Lb,
                  const T* __restrict__ thr_in,
                  const unsigned char* __restrict__ valid,
                  const long long* __restrict__ border,
                  const unsigned char* __restrict__ active,
                  const T* __restrict__ mom_in, const T* __restrict__ beta_in,
                  const T* __restrict__ r_in, T* beta_out, T* r_out,
                  T* maxh_out, T* part_c, int nb, int n, int B, int G,
                  int rows, int keep_x, int keep_r, int iters) {
  constexpr int V = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* hdr = reinterpret_cast<int*>(smem_raw);  // [0] cursor, [1] block
  T* base = reinterpret_cast<T*>(smem_raw + 16);
  const GpLayout Ly = gp_layout<T>(B, rows, keep_x, keep_r, iters);
  T* scr = base + Ly.scr;
  T* c = base + Ly.c;
  T* b0 = base + Ly.b0;
  T* U0 = base + Ly.u;
  T* U1 = U0 + GP_MAXB;
  T* DS = base + Ly.ds;
  T* DD = base + Ly.dd;
  T* SQ = base + Ly.sq;
  T* TH = base + Ly.thr;
  T* red = base + Ly.red;
  T* mom = base + Ly.mom;
  T* xs = base + Ly.xs;

  const int tid = threadIdx.x, ctas = gridDim.x, g = blockIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int row0 = min(g * rows, n), row1 = min(row0 + rows, n);
  const int nr = row1 - row0;
  T* rl = keep_r ? base + Ly.rs : r_out + row0;  // this CTA's rows of r
  // 16-byte paths: X's rows (and with them the kept rows and the B-long
  // vectors in shared memory) are 16-byte aligned; the Gram's rows too
  const bool vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   (!WLS || reinterpret_cast<uintptr_t>(Xw) % 16 == 0) &&
                   ((size_t)B * sizeof(T)) % 16 == 0;
  const bool kvec = vec && reinterpret_cast<uintptr_t>(Kb) % 16 == 0;
  const int CL = (B + V - 1) / V;    // column lanes of the row sweep
  const int RG = GP_THREADS / CL;    // row groups
  const int cl = tid % CL, rg = tid / CL;
  const int k = tid >> 2;            // this thread's coordinate (warp_dot)
  const bool own = k < B;
  const bool lead = own && (tid & 3) == 0;  // writes coordinate k
  const int ngr = B / G;             // groups a block
  const bool shfl = 8 % G == 0;      // a group inside one warp's coordinates

  // beta_out starts as beta_in (the first grid barrier orders this copy
  // before CTA 0 writes a visited block); r from r_in, own rows
  for (size_t e = (size_t)g * GP_THREADS + tid; e < (size_t)nb * B;
       e += (size_t)ctas * GP_THREADS)
    beta_out[e] = beta_in[e];
  for (int i = tid; i < nr; i += GP_THREADS) rl[i] = r_in[row0 + i];
  for (int i = tid; i < iters; i += GP_THREADS) mom[i] = mom_in[i];
  // the products read all 128 entries: 0 past B, for good
  for (int i = tid; i < 2 * GP_MAXB; i += GP_THREADS) U0[i] = T(0);
  if (tid < GP_MAXB) DS[tid] = T(0);
  if (tid == 0) hdr[0] = 0;
  __syncthreads();
  if (w == 0) gp_next(hdr, border, active, nb);

  T mh_all = T(0);
  for (int t = 0;; ++t) {
    __syncthreads();
    const int b = hdr[1];  // (found during the previous visit's residual)
    if (b < 0) break;
    const int par = t & 1;
    const T* Xb = X + (size_t)b * n * B;
    const T* Xwb = WLS ? Xw + (size_t)b * n * B : Xb;

    // 1. this CTA's partial c0 over its rows (the rows of X_b kept in
    //    shared memory when planned)
    {
      T acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = T(0);
      if (rg < RG) {
        for (int i = rg; i < nr; i += RG * GP_UNROLL) {
          T x[GP_UNROLL][V];
          // wls: the unweighted rows beside the weighted, to be kept
          T xu[WLS ? GP_UNROLL : 1][V];
#pragma unroll
          for (int u = 0; u < GP_UNROLL; ++u) {
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
          for (int u = 0; u < GP_UNROLL; ++u) {
            const int ii = i + u * RG;
            if (ii < nr) {
              T* xd = xs + (size_t)ii * B + cl * V;
              const T(&xk)[V] = WLS ? xu[WLS ? u : 0] : x[u];
              if (keep_x && vec) {
                *reinterpret_cast<uint4*>(xd) =
                    *reinterpret_cast<const uint4*>(xk);
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
#pragma unroll
      for (int e = 0; e < V; ++e) scr[tid * V + e] = acc[e];
      __syncthreads();
      if (tid < B) {
        const int cc = tid / V, ee = tid % V;
        T s = T(0);
        for (int qq = 0; qq < RG; ++qq) s += scr[(qq * CL + cc) * V + ee];
        part_c[((size_t)par * ctas + g) * B + tid] = s;
      }
    }

    // 2. what does not depend on the sums, loaded under the barrier: the
    //    Gram's rows in registers, kc[i][c] = K[8 w + c, 4 lane + i] (0 past
    //    B); beta0, the group thresholds and L
    T kc[4][8];
    {
      const T* Kg = Kb + (size_t)b * B * B;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int row = 8 * w + cc;
#pragma unroll
        for (int j0 = 0; j0 < 4; j0 += V) {
          T u[V];
          if (row < B) {
            load_chunk(Kg + (size_t)row * B, 4 * lane + j0, B, kvec, u);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) u[e] = T(0);
          }
#pragma unroll
          for (int e = 0; e < V; ++e) kc[j0 + e][cc] = u[e];
        }
      }
    }
    if (tid < B) b0[tid] = beta_in[(size_t)b * B + tid];
    if (tid < ngr) TH[tid] = thr_in[(size_t)b * ngr + tid];
    const T L = tmax(Lb[b], T(1e-30));
    cg::this_grid().sync();

    // 3. c0: the partials added in a fixed order; with 16-byte loads, thread
    //    (column group, subset s) sums CTAs s, s + S, ... in order, then the
    //    S subsets in order
    if (vec) {
      const int CG = B / V, S = GP_THREADS / CG;
      const int cgi = tid % CG, s = tid / CG;
      T acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = T(0);
      if (s < S) {
        for (int g0 = s; g0 < ctas; g0 += S * GP_CBATCH) {
          T v[GP_CBATCH][V];
#pragma unroll
          for (int j = 0; j < GP_CBATCH; ++j) {
            const int gg = g0 + S * j;
            if (gg < ctas) {
              const uint4 u = __ldcg(reinterpret_cast<const uint4*>(
                  part_c + ((size_t)par * ctas + gg) * B + cgi * V));
              memcpy(&v[j][0], &u, 16);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) v[j][e] = T(0);
            }
          }
#pragma unroll
          for (int j = 0; j < GP_CBATCH; ++j)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += v[j][e];
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) scr[tid * V + e] = acc[e];
      __syncthreads();
      if (tid < B) {
        T cs = T(0);
        for (int ss = 0; ss < S; ++ss)
          cs += scr[(ss * CG + tid / V) * V + tid % V];
        c[tid] = cs;
      }
    } else if (tid < B) {
      T cs = T(0);
      for (int gg = 0; gg < ctas; ++gg)
        cs += __ldcg(part_c + ((size_t)par * ctas + gg) * B + tid);
      c[tid] = cs;
    }
    __syncthreads();

    // 4. the block solve, redundantly in every CTA
    const T bk = own ? b0[k] : T(0);
    const T ck = own ? c[k] : T(0);
    const T tg = own ? TH[k / G] : T(0);
    T d = bk, dp = bk;
    for (int it = 0; it < iters; ++it) {
      T* Uc = (it & 1) ? U1 : U0;
      const T yv = d + mom[it] * (d - dp);
      if (lead) Uc[k] = yv - bk;
      __syncthreads();
      const T s = warp_dot(Uc, kc);  // (K (yv - beta0))[k]
      const T z = own ? yv + (ck - s) / L : T(0);
      const T nrm = group_norm(z, shfl, G, k, own, lead, SQ);
      dp = d;
      if (own) d = z * tmax(T(1) - tg / tmax(nrm, T(1e-30)), T(0));
    }
    // the zero snap: q = c0 - K (d - beta0), s_g = q_g + K_gg d_g; the
    // buffer the last step did not read takes d - beta0
    T* Uf = (iters & 1) ? U1 : U0;
    if (lead) {
      Uf[k] = d - bk;
      DS[k] = d;
    }
    __syncthreads();
    // (both products shuffle over the whole warp: every thread calls them)
    const T q = ck - warp_dot(Uf, kc);
    const T od = group_dot(DS, kc, G);
    const T sg = own ? q + od : T(0);
    const T ns = group_norm(sg, shfl, G, k, own, lead, SQ);
    if (own && ns <= L * tg) d = T(0);
    const T mh = block_max(own ? tabs(d - bk) : T(0), red);
    const T dv = own && valid[(size_t)b * B + k] ? d : T(0);
    if (lead) {
      DD[k] = dv - bk;
      if (g == 0) beta_out[(size_t)b * B + k] = dv;
    }
    mh_all = tmax(mh_all, mh);
    __syncthreads();

    // 5. r -= X_b (d - beta0) over this CTA's rows, one warp per row; warp 0
    //    first finds the next visit's block, its loads under the other
    //    warps' rows
    if (w == 0) gp_next(hdr, border, active, nb);
    for (int i = w; i < nr; i += GP_THREADS / 32) {
      T s = T(0);
      for (int k0 = lane * V; k0 < B; k0 += 32 * V) {
        T x[V], dd[V];
        if (keep_x && vec) {
          *reinterpret_cast<uint4*>(x) =
              *reinterpret_cast<const uint4*>(xs + (size_t)i * B + k0);
        } else if (keep_x) {
          load_chunk_shared(xs + (size_t)i * B, k0, B, x);
        } else {
          load_chunk(Xb + (size_t)(row0 + i) * B, k0, B, vec, x);
        }
        load_chunk_shared(DD, k0, B, dd);
#pragma unroll
        for (int e = 0; e < V; ++e) s += x[e] * dd[e];
      }
      s = warp_sum(s);
      if (lane == 0) rl[i] = rl[i] - s;
    }
  }
  if (keep_r)
    for (int i = tid; i < nr; i += GP_THREADS) r_out[row0 + i] = rl[i];
  if (g == 0 && tid == 0) *maxh_out = mh_all;
}

template <typename T>
int group_pass(const T* X, const T* Xw, const T* Kb, const T* Lb,
               const T* thr, const unsigned char* valid,
               const long long* border, const unsigned char* active,
               const T* mom, const T* beta_in, const T* r_in, T* beta_out,
               T* r_out, T* maxh, T* part_c, int nb, int n, int B, int G,
               int grid, int rows, int keep_x, int keep_r, int iters,
               int wls, int smem, cudaStream_t s) {
  if (B < 1 || B > GP_MAXB || G < 1 || B % G != 0 || nb < 1 || n < 1 ||
      grid < 1 || rows < 1 || (long long)grid * rows < n || iters < 0 ||
      !part_c ||
      (size_t)smem != gp_layout<T>(B, rows, keep_x, keep_r, iters).bytes)
    return (int)cudaErrorInvalidValue;
  const void* kern = wls ? (const void*)group_pass_kernel<T, true>
                         : (const void*)group_pass_kernel<T, false>;
  // the grid must be co-resident (a plain launch of too large a grid would
  // hang at the first barrier; the cooperative launch refuses it)
  int resident = 0;
  cudaError_t e = resident_ctas(kern, GP_THREADS, (size_t)smem, &resident);
  if (e != cudaSuccess) return (int)e;
  if (resident < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&X,      &Xw,      &Kb,       &Lb,    &thr,    &valid,
                  &border, &active,  &mom,      &beta_in, &r_in, &beta_out,
                  &r_out,  &maxh,    &part_c,   &nb,    &n,      &B,
                  &G,      &rows,    &keep_x,   &keep_r, &iters};
  e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(GP_THREADS), args,
                                  (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cdt

#define CDT_GROUP_PASS(SUFFIX, T)                                             \
  extern "C" int cdt_group_pass_##SUFFIX(                                     \
      const void* X, const void* Xw, const void* Kb, const void* Lb,          \
      const void* thr, const void* valid, const void* border,                 \
      const void* active, const void* mom, const void* beta_in,               \
      const void* r_in, void* beta_out, void* r_out, void* maxh,              \
      void* part_c, int nb, int n, int B, int G, int grid, int rows,          \
      int keep_x, int keep_r, int iters, int wls, int smem, void* stream) {   \
    return cdt::group_pass<T>(                                                \
        (const T*)X, (const T*)Xw, (const T*)Kb, (const T*)Lb, (const T*)thr, \
        (const unsigned char*)valid, (const long long*)border,                \
        (const unsigned char*)active, (const T*)mom, (const T*)beta_in,       \
        (const T*)r_in, (T*)beta_out, (T*)r_out, (T*)maxh, (T*)part_c, nb, n, \
        B, G, grid, rows, keep_x, keep_r, iters, wls, smem,                   \
        (cudaStream_t)stream);                                                \
  }

CDT_GROUP_PASS(f32, float)
CDT_GROUP_PASS(f64, double)
